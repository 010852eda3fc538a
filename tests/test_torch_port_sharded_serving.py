"""`ShardedArtifactRunner` and `serve --shard` of the port on the CPU.

Two CPU replicas (`devices=["cpu", "cpu"]`) against the port's single
`ArtifactRunner` and against the JAX package's `ShardedArtifactRunner` on a
2-device CPU mesh (`tests/test_serving.py::
test_sharded_runner_matches_single_device`'s batches: padded, exact bucket,
max and chunked), with the same weights: the same buckets, the masks equal
to the single runner's, the heatmaps within 2e-4 of both (the masks within
`test_torch_port_serving.py`'s 16 threshold flips of the JAX package's).
Sharded serving has no collective, so it needs no process group."""

import base64
import json
import subprocess
import sys
import threading
import urllib.request
from io import BytesIO
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from avtubes.core import serving as jserving
from avtubes.core.export import export_localizer as jax_export_localizer
from avtubes_torch.core.export import export_localizer
from avtubes_torch.core.serving import ArtifactRunner, MicroBatcher, ShardedArtifactRunner
from torch_port_ranks import TIMEOUT_S
from torch_port_util import IMG, jax_avenet_state, port_model, spec_cfgs

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
HEATMAP_ATOL = 2e-4
MASK_FLIPS = 16
BATCHES = (1, 3, 4, 8, 11)     # pad, pad, exact bucket, max, chunked


@pytest.fixture(scope="module")
def artifacts():
    """(port artifact, JAX artifact, port spectrogram config), one weights."""
    state = jax_avenet_state(9)
    jcfg, tcfg = spec_cfgs()
    blob = export_localizer(port_model(state), tcfg, image_size=IMG)
    return blob, jax_export_localizer(state, jcfg, image_size=IMG), tcfg


def _requests(tcfg, n, seed):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    waves = np.clip(rng.randn(n, tcfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    return frames, waves


def test_two_replicas_are_the_single_runner_and_the_jax_sharded_runner(artifacts):
    blob, jblob, tcfg = artifacts
    single = ArtifactRunner(blob, max_batch=8, device="cpu")
    sharded = ShardedArtifactRunner(blob, max_batch=8, devices=["cpu", "cpu"])
    jsharded = jserving.ShardedArtifactRunner(jblob, max_batch=8,
                                              devices=jax.devices("cpu")[:2])
    assert sharded.buckets == jsharded.buckets == [2, 4, 8]
    assert sharded.max_batch == jsharded.max_batch == 8
    assert [r.device.type for r in sharded.replicas] == ["cpu", "cpu"]
    for i, n in enumerate(BATCHES):
        frames, waves = _requests(tcfg, n, i)
        m0, h0 = single.run(frames, waves)
        m1, h1 = sharded.run(frames, waves)
        mj, hj = jsharded.run(frames, waves)
        assert m1.shape == (n, 224, 224) and h1.shape == (n, IMG // 16, IMG // 16)
        np.testing.assert_allclose(h1, h0, atol=HEATMAP_ATOL)
        np.testing.assert_array_equal(m1, m0)
        np.testing.assert_allclose(h1, hj, atol=HEATMAP_ATOL)
        assert np.abs(m1 - mj).sum(axis=(1, 2)).max() <= MASK_FLIPS


def test_buckets_round_up_to_multiples_of_the_devices(artifacts):
    blob, _, _ = artifacts
    three = ShardedArtifactRunner(blob, max_batch=8, devices=["cpu"] * 3)
    assert three.buckets == [3, 6, 9] and three.max_batch == 9
    assert all(r.max_batch == 3 for r in three.replicas[1:])
    one = ShardedArtifactRunner(blob, max_batch=5, devices=["cpu"])
    assert one.buckets == [1, 2, 4, 5]
    with pytest.raises(ValueError, match="at least one device"):
        ShardedArtifactRunner(blob, devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):   # default: every card
            ShardedArtifactRunner(blob)


def test_the_batcher_warms_every_sharded_bucket_twice_in_its_thread(artifacts, monkeypatch):
    blob, _, tcfg = artifacts
    runner = ShardedArtifactRunner(blob, max_batch=4, devices=["cpu", "cpu"])
    seen = []
    real = ShardedArtifactRunner._execute

    def execute(self, frames, waves, b):
        seen.append((b, threading.current_thread().name))
        return real(self, frames, waves, b)

    monkeypatch.setattr(ShardedArtifactRunner, "_execute", execute)
    batcher = MicroBatcher(runner, window_ms=1.0)
    try:
        batcher.wait_warm(timeout=TIMEOUT_S)
        frames, waves = _requests(tcfg, 1, 5)
        mask, _ = batcher.submit(frames[0], waves[0], timeout=TIMEOUT_S)
    finally:
        batcher.close()
    assert [b for b, _ in seen] == [2, 4, 2, 4, 2]
    assert {name for _, name in seen} == {"avtubes-microbatch"}
    np.testing.assert_array_equal(mask, runner.run(frames, waves)[0][0])


def test_serve_shard_answers_over_http(artifacts, tmp_path):
    """`serve --shard --device cpu`: one CPU replica; it says how many
    devices it shards over, then answers a request."""
    from PIL import Image

    blob, _, tcfg = artifacts
    model = tmp_path / "m.avt"
    model.write_bytes(blob)
    proc = subprocess.Popen(
        [sys.executable, "-m", "avtubes_torch.cli.serve", "--model", str(model), "--device",
         "cpu", "--shard", "--port", "0", "--max_batch", "2"],
        cwd=ROOT, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        lines = []
        timer = threading.Timer(TIMEOUT_S, proc.kill)
        timer.start()
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        timer.cancel()
        assert "sharding batches over 1 devices\n" in lines, lines
        url = lines[-1].split(" on ")[1].split(" ")[0]
        frames, waves = _requests(tcfg, 1, 6)
        buf = BytesIO()
        Image.fromarray(frames[0]).save(buf, format="PNG")
        body = json.dumps({"image": base64.b64encode(buf.getvalue()).decode(),
                           "pcm": base64.b64encode(waves[0].astype("<f4").tobytes()).decode(),
                           "samplerate": tcfg.samplerate}).encode()
        req = urllib.request.Request(url + "/localize", body,
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            out = json.loads(resp.read())
        want = ArtifactRunner(blob, max_batch=2, device="cpu").run(frames, waves)[1][0]
        np.testing.assert_allclose(np.asarray(out["heatmap"]), want, atol=HEATMAP_ATOL)
    finally:
        proc.kill()
        proc.wait(timeout=TIMEOUT_S)
        proc.stdout.close()
        model.unlink()          # pytest keeps its last temporary directories
