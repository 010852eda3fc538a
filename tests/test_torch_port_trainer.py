"""The port's flagship trainer end to end on the CPU: the CLI on synthetic
and on-disk data, resume, the input pipeline against the JAX package's, and
what is not ported raising."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from avtubes import native
from avtubes.core.config import DataConfig as JaxDataConfig
from avtubes.data import pipeline as jpipe
from avtubes.data.synthetic import write_synthetic_dataset as jax_write_synthetic_dataset
from avtubes_torch.cli import train_hardway as cli
from avtubes_torch.core.checkpoint import latest_checkpoint
from avtubes_torch.core.config import DataConfig, ExperimentConfig
from avtubes_torch.data import pipeline as tpipe
from avtubes_torch.data.synthetic import write_synthetic_dataset
from avtubes_torch.train import hardway

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--image_size", "64", "--frame_density", "2", "--batch_size", "2",
         "--samplerate", "8000", "--audio_seconds", "1", "--n_threads", "2",
         "--learning_rate", "1e-4", "--eval_batch_size", "3"]
CPU32 = ["--device", "cpu", "--compute_dtype", "float32"]


def _records(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.open()]


@pytest.fixture
def pil_only(monkeypatch):
    """The JAX package's PIL and numpy decode paths (the port has no native
    decoder)."""
    monkeypatch.setattr(native, "available", lambda: False)


# ---------------------------------------------------------------- the CLI

def test_cli_trains_evaluates_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--synthetic", *CPU32, *SMALL, "--summaries_dir", str(tmp_path), "--steps", "2"]
    final = cli.main([*args, "--epochs", "1"])
    for key in ("loss", "hardway_loss", "aug_loss", "l2_loss", "consistency_loss",
                "hardway_ciou", "hardway_auc"):
        assert np.isfinite(final[key]), key
    assert 0.0 <= final["hardway_ciou"] <= 1.0 and 0.0 <= final["hardway_auc"] <= 1.0
    assert final["hardway_n"] == 8 and final["skipped_samples"] == 0
    assert "final:" in capsys.readouterr().out
    assert latest_checkpoint(tmp_path, "hardway16").name == "hardway16_ep0"
    payload = torch.load(tmp_path / "hardway16_ep0", weights_only=True)
    assert payload["step"] == 2 and payload["epoch"] == 0

    # resume from hardway16_ep0: epoch 1 only, the step count goes on
    cli.main([*args, "--epochs", "2", "--use_pretrained"])
    steps = [r["step"] for r in _records(tmp_path / "hardway16.metrics.jsonl") if "loss" in r]
    assert steps == [1, 2, 3, 4]
    assert all(r["loader_wait_ms"] >= 0 for r in _records(tmp_path / "hardway16.metrics.jsonl")
               if "loss" in r)
    assert latest_checkpoint(tmp_path, "hardway16").name == "hardway16_ep1"
    assert torch.load(tmp_path / "hardway16_ep1", weights_only=True)["step"] == 4


def test_cli_on_disk_clips_and_hard_way_test(tmp_path):
    """ClipTrainSource + HardwayTestSource over the original layout, the
    metadata CSVs and the XML ground truth."""
    root = tmp_path / "data"
    ids = write_synthetic_dataset(root, n_videos=4, frames=2, samplerate=8000, seconds=1,
                                  image_hw=(80, 96))
    final = cli.main([*CPU32, *SMALL, "--data_path", str(root), "--og_data_path", str(root),
                      "--og_gt_path", str(root / "anno"), "--metadata_dir",
                      str(root / "metadata"), "--subset", "5", "--epochs", "1",
                      "--summaries_dir", str(tmp_path / "ckpt")])
    assert np.isfinite(final["loss"]) and final["hardway_n"] == len(ids)
    assert 0.0 <= final["hardway_ciou"] <= 1.0
    # a whole epoch: 4 clips in batches of 2
    assert torch.load(tmp_path / "ckpt" / "hardway16_ep0", weights_only=True)["step"] == 2


def test_watch_and_device_pool_options(tmp_path):
    base = ExperimentConfig.from_args(["--synthetic", *CPU32, *SMALL, "--epochs", "1",
                                       "--summaries_dir", str(tmp_path / "a")])
    watched = dataclasses.replace(base, train=dataclasses.replace(base.train, watch_every=1))
    a = hardway.run(watched, steps_cap=1, do_eval=False)
    norms = [r for r in _records(tmp_path / "a" / "hardway16.metrics.jsonl")
             if "grad_norm/imgnet/layer1_block0" in r]
    assert norms and norms[0]["param_norm/audnet/stem_audio"] > 0
    # one device: the per-device pool is the whole batch, so the same losses
    pooled = dataclasses.replace(base, train=dataclasses.replace(
        base.train, negative_pool="device", summaries_dir=str(tmp_path / "b")))
    b = hardway.run(pooled, steps_cap=1, do_eval=False)
    assert a["loss"] == b["loss"]


# ---------------------------------------------------- what is not ported

@pytest.mark.parametrize("extra,match", [
    (["--remat"], "Queue 1 item 12"),     # the bfloat16 default runs; remat on it does not
    (["--compute_dtype", "float32", "--remat"], "remat"),
    (["--compute_dtype", "float32", "--group_steps", "2"], "Not to port"),
])
def test_unported_options_raise(tmp_path, extra, match):
    cfg = ExperimentConfig.from_args(["--synthetic", "--device", "cpu", *SMALL,
                                      "--summaries_dir", str(tmp_path), *extra])
    with pytest.raises(NotImplementedError, match=match):
        hardway.run(cfg, steps_cap=1)
    assert not list(tmp_path.iterdir())


def test_more_than_one_process_and_qualitative_records_raise(tmp_path, monkeypatch):
    cfg = ExperimentConfig.from_args(["--synthetic", *CPU32, *SMALL, "--epochs", "1",
                                      "--summaries_dir", str(tmp_path)])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        hardway.run(cfg, steps_cap=1)
    monkeypatch.delenv("WORLD_SIZE")
    # qualitative records no longer raise: the overlays of the first two test
    # samples are written under the JAX package's names
    # (`test_torch_port_visual.py` holds them against it)
    recording = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                   record_qualitative=2))
    final = hardway.run(recording, steps_cap=1)
    assert final["hardway_n"] == 8
    assert sorted(p.name for p in (tmp_path / "images").iterdir()) == [
        "synthetic_0_hardway_0.jpg", "synthetic_1_hardway_0.jpg"]


def test_per_frame_test_videos_raise_up_front(tmp_path):
    """They no longer raise: with `--gt_path` and `videos/` the epoch runs
    the per-frame test, as the JAX package's does, and a test set whose every
    video is unreadable gives NaN for its three metrics
    (`avtubes/train/evaluate.py:263-264`); the readable case is in
    `test_torch_port_perframe.py`."""
    root = tmp_path / "data"
    write_synthetic_dataset(root, n_videos=2, frames=2, samplerate=8000, seconds=1,
                            image_hw=(80, 96))
    for vid in ("900000000", "900000001"):
        (root / "videos" / f"{vid}.mp4").write_bytes(b"")
    cfg = ExperimentConfig.from_args([*CPU32, *SMALL, "--data_path", str(root),
                                      "--og_data_path", str(root), "--og_gt_path",
                                      str(root / "anno"), "--gt_path", str(root / "anno"),
                                      "--metadata_dir", str(root / "metadata"), "--subset",
                                      "5", "--epochs", "1",
                                      "--summaries_dir", str(tmp_path / "ckpt")])
    final = hardway.run(cfg, steps_cap=1)
    assert np.isfinite(final["loss"]) and final["hardway_n"] == 2
    for key in ("test_ciou", "test_auc", "test_mtc"):
        assert np.isnan(final[key]), (key, final[key])
    logged = [r for r in _records(tmp_path / "ckpt" / "hardway16.metrics.jsonl")
              if "test_ciou" in r]
    assert len(logged) == 1


def test_without_a_device_flag_a_machine_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "avtubes_torch.cli.train_hardway", "--synthetic",
         "--compute_dtype", "float32", *SMALL, "--steps", "1",
         "--summaries_dir", str(tmp_path)],
        cwd=ROOT, text=True, capture_output=True, timeout=300)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert "final:" not in out.stdout and not list(tmp_path.iterdir())


# ------------------------------------------------------- input pipeline

@pytest.mark.parametrize("transport", ["float32", "int16", "spec_int16", "spec_int8"])
def test_synthetic_batches_equal_the_jax_package_s(transport, pil_only):
    kwargs = dict(image_size=32, frame_density=2, samplerate=8000, audio_seconds=1,
                  audio_transport=transport)
    t_loader = tpipe.BatchLoader(tpipe.SyntheticSource(DataConfig(**kwargs), n=5), 2,
                                 num_workers=3, seed=4)
    j_loader = jpipe.BatchLoader(jpipe.SyntheticSource(JaxDataConfig(**kwargs), n=5), 2,
                                 num_workers=1, seed=4)
    got, want = list(t_loader.epoch(1)), list(j_loader.epoch(1))
    assert len(got) == len(want) == len(t_loader) == 2
    for a, b in zip(got, want):
        assert a["id"] == b["id"] and set(a) == set(b)
        for k in ("clip", "waveform"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_on_disk_sources_equal_the_jax_package_s(tmp_path, pil_only):
    ids = write_synthetic_dataset(tmp_path, n_videos=3, frames=2, samplerate=8000, seconds=1,
                                  image_hw=(70, 90))
    # the same files as the JAX package's generator writes
    jax_write_synthetic_dataset(tmp_path / "jax", n_videos=3, frames=2, samplerate=8000,
                                seconds=1, image_hw=(70, 90))
    for rel in ("audio/900000001.wav", "anno/900000000.xml", "metadata/flickr_test_hardway.csv"):
        assert (tmp_path / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
    kwargs = dict(image_size=64, frame_density=2, samplerate=8000, audio_seconds=1)
    for transport in ("float32", "int16", "spec_int16"):
        t_cfg = DataConfig(**kwargs, audio_transport=transport)
        j_cfg = JaxDataConfig(**kwargs, audio_transport=transport)
        for t_src, j_src in ((tpipe.ClipTrainSource(tmp_path, ids, t_cfg),
                              jpipe.ClipTrainSource(tmp_path, ids, j_cfg)),
                             (tpipe.HardwayTestSource(tmp_path, ids, t_cfg),
                              jpipe.HardwayTestSource(tmp_path, ids, j_cfg))):
            a = t_src.load(1, np.random.RandomState(8))
            b = j_src.load(1, np.random.RandomState(8))
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    bad = tpipe.ClipTrainSource(tmp_path, ["missing"], DataConfig(**kwargs))
    with pytest.raises(tpipe.SkippedSampleError, match="missing"):
        bad.load(0, np.random.RandomState(0))


def test_hard_way_loader_equals_the_jax_package_s_per_sample_loader(tmp_path, pil_only):
    ids = write_synthetic_dataset(tmp_path, n_videos=5, frames=2, samplerate=8000, seconds=1,
                                  image_hw=(70, 90))
    kwargs = dict(image_size=64, frame_density=2, samplerate=8000, audio_seconds=1)
    got = list(tpipe.make_hardway_loader(tmp_path, ids, DataConfig(**kwargs), 2,
                                         num_workers=3).epoch(0))
    want = list(jpipe.make_hardway_loader(tmp_path, ids, JaxDataConfig(**kwargs), 2,
                                          num_workers=1, mode="per_sample").epoch(0))
    assert [b["id"] for b in got] == [b["id"] for b in want] == [ids[:2], ids[2:4], ids[4:]]
    for a, b in zip(got, want):
        for k in ("frame", "waveform"):
            np.testing.assert_array_equal(a[k], b[k])


def test_loader_skips_and_counts_and_raises_real_errors():
    class Flaky:
        def __len__(self):
            return 5

        def load(self, idx, rng):
            if idx == 2:
                raise tpipe.SkippedSampleError("bad file")
            if idx == 9:
                raise KeyError("bug")
            return {"x": np.full(2, idx), "id": str(idx)}

    loader = tpipe.BatchLoader(Flaky(), 2, num_workers=3, shuffle=False, drop_last=False)
    batches = list(loader.epoch(0))
    assert [b["id"] for b in batches] == [["0", "1"], ["3", "4"]]
    assert loader.skipped == loader.epoch_skipped == 1

    class Buggy(Flaky):
        def load(self, idx, rng):
            return super().load(9, rng)

    with pytest.raises(KeyError):
        list(tpipe.BatchLoader(Buggy(), 2, num_workers=2).epoch(0))


def test_device_prefetch_on_the_cpu_gives_tensors_in_order_and_surfaces_errors():
    batches = [{"clip": np.full((2, 3), i, np.uint8), "id": [str(i)]} for i in range(5)]
    got = list(tpipe.device_prefetch(iter(batches), "cpu", depth=2))
    assert [int(b["clip"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["clip"], torch.Tensor) and b["id"] == [str(i)]
               for i, b in enumerate(got))

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    it = tpipe.device_prefetch(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    # a consumer that stops early retires the stager
    early = tpipe.device_prefetch(iter(batches * 10), "cpu", depth=1)
    next(early)
    early.close()
