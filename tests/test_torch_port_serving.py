"""Serving runtime of the port on the CPU: artifact header and round trip,
bucket padding and chunking, the micro-batcher, the HTTP server in-process,
and the mask wire format.  The runner's answers are held against the JAX
package's pipeline with the same weights."""

import base64
import json
import struct
import threading
import time
import urllib.error
import urllib.request
from io import BytesIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.export import _pipeline_fn
from avtubes.core import serving as jserving
from avtubes_torch.cli.serve import LocalizerHTTPServer, _prepare_audio, build_handler
from avtubes_torch.core.export import export_localizer
from avtubes_torch.core.serving import (
    ArtifactRunner,
    MicroBatcher,
    mask_box,
    mask_to_rle,
    rle_to_mask,
)
from avtubes_torch.data.audio import parse_wav, prepare_waveform, read_wav, write_wav
from torch_port_util import IMG, jax_state, port_model, spec_cfgs

HEATMAP_ATOL = 2e-4
MASK_FLIPS = 16


# ------------------------------------------------------------- wire format

def test_rle_round_trip_and_box_match_jax_package():
    rng = np.random.default_rng(0)
    for mask in (rng.random((16, 12)) > 0.5, np.zeros((5, 5)), np.ones((3, 4))):
        mask = mask.astype(np.float32)
        rle = mask_to_rle(mask)
        assert rle == jserving.mask_to_rle(mask)
        np.testing.assert_array_equal(rle_to_mask(rle, mask.shape), mask)
        assert mask_box(mask) == jserving.mask_box(mask)
    assert mask_to_rle(np.asarray([[1, 1, 0]]))[0] == 0     # starts with a zero-run
    with pytest.raises(ValueError, match="RLE covers"):
        rle_to_mask([1, 2], (2, 2))
    m = np.zeros((8, 8)); m[2:5, 3:7] = 1
    assert mask_box(m) == [3, 2, 6, 4] and mask_box(np.zeros((2, 2))) is None


def test_wav_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    w = np.clip(rng.randn(3000) * 0.3, -1, 1)
    write_wav(tmp_path / "a.wav", w, 8000)
    got, sr = read_wav(tmp_path / "a.wav")
    assert sr == 8000 and got.shape == (3000,)
    np.testing.assert_allclose(got, w, atol=1e-4)  # written x32767, read /32768
    again, _ = parse_wav((tmp_path / "a.wav").read_bytes())
    np.testing.assert_array_equal(again, got)
    assert prepare_waveform(got, 8000, seconds=1).shape == (8000,)   # tiled up
    with pytest.raises(ValueError, match="RIFF"):
        parse_wav(b"not a wav file at all")


# ------------------------------------------------------------ micro-batcher

class _FakeRunner:
    """Stands in for ArtifactRunner: records batch sizes and the threads
    that warm it up and run it, echoes inputs."""

    max_batch = 4

    def __init__(self, fail=False):
        self.batches = []
        self.fail = fail
        self.warm_threads = []
        self.run_threads = []

    def warmup(self):
        self.warm_threads.append(threading.get_ident())

    def run(self, frames, waves):
        self.run_threads.append(threading.get_ident())
        if self.fail:
            raise RuntimeError("device exploded")
        self.batches.append(len(frames))
        n = len(frames)
        return (np.full((n, 2, 2), frames[:, 0, 0, 0, None, None], np.float32),
                np.zeros((n, 2, 2), np.float32))


def test_microbatcher_coalesces_concurrent_requests():
    runner = _FakeRunner()
    batcher = MicroBatcher(runner, window_ms=2000.0)
    try:
        results = [None] * 4

        def call(i):
            results[i] = batcher.submit(np.full((4, 4, 3), i, np.uint8),
                                        np.zeros(8, np.float32), timeout=60.0)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i in range(4):  # each caller got ITS result back
            assert float(results[i][0][0, 0]) == float(i)
        stats = batcher.snapshot()
        assert stats["requests"] == 4 and stats["batches"] <= 3
        assert max(runner.batches) >= 2
        assert sum(int(k) * v for k, v in stats["batch_hist"].items()) == 4
    finally:
        batcher.close()


def test_microbatcher_warms_up_in_its_dispatcher_thread():
    """cuDNN's autotuner cache is per thread: the warm-up runs in the thread
    that runs every batch, before the first request, and `wait_warm`
    reports its end."""
    runner = _FakeRunner()
    batcher = MicroBatcher(runner, window_ms=1.0)
    try:
        assert batcher.wait_warm(timeout=30.0) >= 0.0
        for i in range(3):
            batcher.submit(np.full((4, 4, 3), i, np.uint8), np.zeros(8, np.float32),
                           timeout=30.0)
        assert runner.warm_threads == [batcher._thread.ident]
        assert set(runner.run_threads) == {batcher._thread.ident}
        assert threading.get_ident() not in runner.warm_threads
    finally:
        batcher.close()
    runner = _FakeRunner()
    batcher = MicroBatcher(runner, window_ms=1.0, warmup=False)     # --no_warmup
    try:
        assert batcher.wait_warm(timeout=30.0) == 0.0
        batcher.submit(np.zeros((4, 4, 3), np.uint8), np.zeros(8, np.float32), timeout=30.0)
        assert runner.warm_threads == [] and len(runner.run_threads) == 1
    finally:
        batcher.close()
    runner = _FakeRunner()
    runner.warmup = lambda: (_ for _ in ()).throw(RuntimeError("warm-up exploded"))
    batcher = MicroBatcher(runner, window_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="warm-up exploded"):
            batcher.wait_warm(timeout=30.0)
        batcher.submit(np.zeros((4, 4, 3), np.uint8), np.zeros(8, np.float32), timeout=30.0)
    finally:
        batcher.close()


def test_microbatcher_errors_propagate_and_timeouts_cancel():
    runner = _FakeRunner(fail=True)
    batcher = MicroBatcher(runner, window_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="device exploded"):
            batcher.submit(np.zeros((4, 4, 3), np.uint8), np.zeros(8, np.float32),
                           timeout=60.0)
        runner.fail = False
        mask, _ = batcher.submit(np.zeros((4, 4, 3), np.uint8),
                                 np.zeros(8, np.float32), timeout=60.0)
        assert mask.shape == (2, 2) and batcher.snapshot()["errors"] == 1
    finally:
        batcher.close()

    # A occupies the dispatcher; B times out while queued and must be
    # dropped, not executed later; C stays live
    gate = threading.Event()
    runner = _FakeRunner()
    real_run = runner.run
    runner.run = lambda f, w: (gate.wait(30.0), real_run(f, w))[1]
    batcher = MicroBatcher(runner, window_ms=1.0)
    try:
        t_a = threading.Thread(target=lambda: batcher.submit(
            np.zeros((4, 4, 3), np.uint8), np.zeros(8, np.float32), timeout=30.0))
        t_a.start()
        time.sleep(0.2)
        with pytest.raises(TimeoutError):
            batcher.submit(np.full((4, 4, 3), 1, np.uint8),
                           np.zeros(8, np.float32), timeout=0.05)
        done_c = []
        t_c = threading.Thread(target=lambda: done_c.append(batcher.submit(
            np.full((4, 4, 3), 2, np.uint8), np.zeros(8, np.float32), timeout=30.0)))
        t_c.start()
        gate.set()
        t_a.join(timeout=60)
        t_c.join(timeout=60)
        assert done_c and float(done_c[0][0][0, 0]) == 2.0
        stats = batcher.snapshot()
        assert stats["cancelled"] == 1 and stats["requests"] == 2
    finally:
        gate.set()
        batcher.close()


# ------------------------------------------------- artifact runner + HTTP

@pytest.fixture(scope="module")
def served():
    """(JAX pipeline fn, float32 artifact, port spec cfg, port model)."""
    state = jax_state(seed=9)
    jcfg, tcfg = spec_cfgs()
    model = port_model(state)
    blob = export_localizer(model, tcfg, image_size=IMG,
                            extra_meta={"checkpoint": "unit-test"})
    return jax.jit(_pipeline_fn(state, jcfg)), blob, tcfg, model


def _requests(tcfg, n, seed=0):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    waves = np.clip(rng.randn(n, tcfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    return frames, waves


def test_artifact_header(served):
    _, blob, tcfg, _ = served
    assert blob[:8] == b"AVTMETA1"
    (n,) = struct.unpack("<I", blob[8:12])
    meta = json.loads(blob[12:12 + n])
    for key in ("image_size", "samplerate", "seconds", "num_samples", "batch",
                "platforms", "audio_transport"):     # the JAX artifact's keys
        assert key in meta
    assert meta["framework"] == "torch" and meta["checkpoint"] == "unit-test"
    assert meta["hardway"]["epsilon"] == 0.65 and meta["spectrogram"]["nperseg"] == 512
    assert meta["num_samples"] == tcfg.num_samples and meta["image_size"] == IMG
    with pytest.raises(ValueError, match="AVTMETA1"):
        ArtifactRunner(b"garbage" * 10, device="cpu")
    # weights load with weights_only=True: a pickle payload is refused
    import pickle

    evil = blob[:12 + n] + pickle.dumps(print)
    with pytest.raises(pickle.UnpicklingError):
        ArtifactRunner(evil, device="cpu")


def test_runner_matches_jax_pads_and_chunks(served):
    jax_fn, blob, tcfg, _ = served
    runner = ArtifactRunner(blob, max_batch=4, device="cpu")
    assert runner.buckets == [1, 2, 4] and runner.device.type == "cpu"
    runner.warmup()
    frames, waves = _requests(tcfg, 7)
    want_masks, want_heat = jax.device_get(jax_fn(jnp.asarray(frames), jnp.asarray(waves)))
    masks, heat = runner.run(frames, waves)        # 7 > max_batch: chunks 4 + 3(->4)
    assert masks.shape == (7, 224, 224) and heat.shape == (7, IMG // 16, IMG // 16)
    np.testing.assert_allclose(heat, want_heat, atol=HEATMAP_ATOL)
    assert np.abs(masks - want_masks).sum(axis=(1, 2)).max() <= MASK_FLIPS
    # bucket padding leaves real rows unchanged: 3 rows padded to 4 equal
    # the same rows run unpadded in a full bucket
    m3, h3 = runner.run(frames[:3], waves[:3])
    m4, h4 = runner.run(frames[:4], waves[:4])
    np.testing.assert_allclose(h3, h4[:3], atol=1e-6)
    np.testing.assert_array_equal(m3, m4[:3])
    m1, h1 = runner.run(frames[:1], waves[:1])
    np.testing.assert_allclose(h1, h4[:1], atol=1e-6)
    with pytest.raises(ValueError, match="empty batch"):
        runner.run(frames[:0], waves[:0])
    with pytest.raises(ValueError, match="matches neither"):
        runner.run(frames[:2], waves[:2, :100])
    with pytest.raises(ValueError, match="frames must be"):
        runner.run(frames[:2, :32], waves[:2])


def test_runner_warms_every_bucket_twice(served, monkeypatch):
    """The first pass lets cuDNN's autotuner pick, the second runs what it
    picked: only then is the first served batch no slower than the rest."""
    _, blob, _, _ = served
    runner = ArtifactRunner(blob, max_batch=4, device="cpu")
    seen = []
    monkeypatch.setattr(runner, "run", lambda frames, waves: seen.append(len(frames)))
    runner.warmup()
    assert seen == [1, 2, 4, 1, 2, 4]


@pytest.mark.parametrize("transport", ["int16", "spec_int16", "spec_int8"])
def test_runner_transport_artifacts(served, transport):
    _, blob, tcfg, model = served
    frames, waves = _requests(tcfg, 3, seed=1)
    ref = ArtifactRunner(blob, max_batch=4, device="cpu").run(frames, waves)
    runner = ArtifactRunner(
        export_localizer(model, tcfg, image_size=IMG, audio_transport=transport),
        max_batch=4, device="cpu")
    assert runner.audio_transport == transport
    payload = runner.prepare_audio(waves)
    assert payload.dtype == runner.audio_dtype and payload.shape[1:] == runner.audio_shape
    masks, heat = runner.run(frames, waves)          # float waveforms, encoded host-side
    masks_p, heat_p = runner.run(frames, payload)    # the wire payload itself
    np.testing.assert_array_equal(heat, heat_p)
    np.testing.assert_array_equal(masks, masks_p)
    # quantized transports stay close to the float32 artifact
    tol = 0.05 if transport == "spec_int8" else 5e-3
    np.testing.assert_allclose(heat, ref[1], atol=tol)


def _png_b64(frame):
    from PIL import Image

    buf = BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _wav_b64(tmp_path, wave, samplerate):
    path = tmp_path / "req.wav"
    write_wav(path, wave, samplerate)
    return base64.b64encode(path.read_bytes()).decode()


@pytest.fixture()
def server(served):
    _, blob, _, _ = served
    runner = ArtifactRunner(blob, max_batch=4, device="cpu")
    batcher = MicroBatcher(runner, window_ms=2.0)
    handler = build_handler(batcher, runner.meta, request_timeout_s=120.0,
                            max_request_mb=2.0)
    handler.log_message = lambda self, fmt, *args: None
    srv = LocalizerHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", runner
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        batcher.close()
        assert not thread.is_alive()


def _post(url, obj, raw=None):
    data = raw if raw is not None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_localize_wav_and_pcm(server, served, tmp_path):
    url, runner = server
    _, _, tcfg, _ = served
    frames, waves = _requests(tcfg, 2, seed=2)
    bodies = [
        {"image": _png_b64(frames[0]),
         "audio": _wav_b64(tmp_path, waves[0], tcfg.samplerate)},
        {"image": _png_b64(frames[1]),
         "pcm": base64.b64encode(waves[1].astype("<f4").tobytes()).decode(),
         "samplerate": tcfg.samplerate},
    ]
    for i, body in enumerate(bodies):
        status, out = _post(url + "/localize", body)
        assert status == 200, out
        assert out["mask_shape"] == [224, 224] and out["latency_ms"] > 0
        mask = rle_to_mask(out["mask_rle"], tuple(out["mask_shape"]))
        heat = np.asarray(out["heatmap"], np.float32)
        decoded = _prepare_audio(body, tcfg.samplerate, tcfg.num_samples)
        want_mask, want_heat = runner.run(frames[i:i + 1], decoded[None])
        np.testing.assert_allclose(heat, want_heat[0], atol=2e-6)  # 6-decimal wire rounding
        assert np.abs(mask - want_mask[0]).sum() <= MASK_FLIPS
        assert out["box"] == mask_box(mask)
    # a WAV at another rate is resampled to the artifact's
    status, out = _post(url + "/localize", {
        "image": _png_b64(frames[0]),
        "audio": _wav_b64(tmp_path, waves[0][:3000], tcfg.samplerate // 2)})
    assert status == 200 and np.isfinite(out["heatmap"]).all()


def test_http_health_stats_and_errors(server, served):
    url, _ = server
    _, _, tcfg, _ = served
    with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["model"]["framework"] == "torch"
    assert health["fast_decode"] is False
    frames, waves = _requests(tcfg, 1, seed=3)
    ok = {"image": _png_b64(frames[0]),
          "pcm": base64.b64encode(waves[0].astype("<f4").tobytes()).decode()}
    assert _post(url + "/localize", ok)[0] == 200
    with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
        stats = json.loads(resp.read())
    assert stats["requests"] == 1 and stats["batches"] == 1 and stats["errors"] == 0
    # the artifact's compute dtype (this fixture's model is float32)
    assert stats["compute_dtype"] == health["model"]["compute_dtype"] == "float32"
    assert stats["fast_decode"] is False
    # 400: missing fields, bad base64 image, non-object body, empty audio
    assert _post(url + "/localize", {"image": ok["image"]})[0] == 400
    assert _post(url + "/localize", {"image": "!!!", "pcm": ok["pcm"]})[0] == 400
    assert _post(url + "/localize", None, raw=b"[1, 2]")[0] == 400
    assert _post(url + "/localize", {"image": ok["image"], "pcm": ""})[0] == 400
    # 404: unknown paths, GET and POST
    assert _post(url + "/nowhere", ok)[0] == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url + "/nowhere", timeout=30)
    assert err.value.code == 404
    # 413: a body over --max_request_mb is refused unread — announce it and
    # send none of it, so the answer cannot race with an upload
    import http.client

    conn = http.client.HTTPConnection(url.removeprefix("http://"), timeout=30)
    try:
        conn.putrequest("POST", "/localize")
        conn.putheader("Content-Length", "2100000")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert "exceeds limit" in json.loads(resp.read())["error"]
    finally:
        conn.close()
    with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
        assert json.loads(resp.read())["status"] == "ok"   # still serving


def _photo_jpeg(seed: int) -> bytes:
    """A photo-like 480x640 JPEG: smooth gradients plus mild noise."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:480, 0:640]
    img = np.stack([xx / 640 * 255, yy / 480 * 255, (xx + yy) / 1120 * 255], -1)
    buf = BytesIO()
    Image.fromarray(np.clip(img + rng.randn(480, 640, 3) * 8, 0, 255).astype(np.uint8)).save(
        buf, "JPEG", quality=90)
    return buf.getvalue()


def test_http_fast_decode(served, tmp_path):
    """--fast_decode wiring: the server decodes request JPEGs with the
    native DCT-scaled path (the answer is the runner's on that decode), the
    response contract is unchanged, the heatmap tracks the exact-decode
    server's on the same payload, and /healthz and /stats say which."""
    from avtubes_torch import native

    if not native.available():
        pytest.skip("the native IO core is unavailable (needs g++ and libjpeg)")
    _, blob, tcfg, _ = served
    jpeg = _photo_jpeg(6)
    _, waves = _requests(tcfg, 1, seed=6)
    payload = {"image": base64.b64encode(jpeg).decode(),
               "audio": _wav_b64(tmp_path, waves[0], tcfg.samplerate)}
    heats = {}
    for fast in (False, True):
        runner = ArtifactRunner(blob, max_batch=2, device="cpu")
        batcher = MicroBatcher(runner, window_ms=1.0)
        handler = build_handler(batcher, runner.meta, 120.0, fast_decode=fast)
        handler.log_message = lambda self, fmt, *args: None
        srv = LocalizerHTTPServer(("127.0.0.1", 0), handler)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            code, resp = _post(url + "/localize", payload)
            assert code == 200, resp
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                assert json.loads(r.read())["fast_decode"] is fast
            with urllib.request.urlopen(url + "/stats", timeout=30) as r:
                assert json.loads(r.read())["fast_decode"] is fast
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
            batcher.close()
        heat = np.asarray(resp["heatmap"])
        assert heat.shape == (IMG // 16, IMG // 16) and np.isfinite(heat).all()
        heats[fast] = heat
        frame = (native.decode_jpeg_shortest_bytes(jpeg, IMG, IMG, scaled=True) if fast else
                 _exact_frame(jpeg))
        audio = _prepare_audio(payload, tcfg.samplerate, tcfg.num_samples)
        _, want = runner.run(frame[None], audio[None])
        np.testing.assert_allclose(heat, want[0], atol=1e-6)
    assert np.abs(heats[True] - heats[False]).max() < 0.15


def _exact_frame(jpeg: bytes) -> np.ndarray:
    from avtubes_torch.data.transforms import eval_frame_from_bytes

    return eval_frame_from_bytes(jpeg, IMG)
