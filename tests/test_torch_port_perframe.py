"""The per-frame whole-video test of the port against the JAX package's:
the `.mp4` fixtures, their decode by `PerFrameEvalSource`, `evaluate_perframe`
on the same weights, and the trainer's gate (`--gt_path` and `videos/`).
Modelled on `tests/test_perframe_eval.py`."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.config import DataConfig as JaxDataConfig
from avtubes.data.pipeline import PerFrameEvalSource as JaxPerFrameEvalSource
from avtubes.data.spectrogram import SpectrogramConfig as JaxSpectrogramConfig
from avtubes.data.synthetic import write_synthetic_dataset as jax_write_synthetic_dataset
from avtubes.train import evaluate as jeval
from avtubes.train.hardway import _synthetic_gt_lookup as jax_synthetic_gt_lookup
from avtubes_torch.core.config import DataConfig, ExperimentConfig
from avtubes_torch.data.pipeline import PerFrameEvalSource, SkippedSampleError
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.data.synthetic import write_synthetic_dataset
from avtubes_torch.train import evaluate as teval
from avtubes_torch.train import hardway
from torch_port_util import IMG, jax_state, port_model

pytest.importorskip("cv2")
torch.set_num_threads(2)
SR, SECONDS = 8000, 1
FRAMES = 10
KW = dict(image_size=IMG, sampling_rate=4, samplerate=SR, audio_seconds=SECONDS)
METRIC_ATOL = 1e-6    # means of equal per-frame values, summed in another order


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same arguments through both packages' writers: (port's root, JAX's root, ids)."""
    port_root = tmp_path_factory.mktemp("port_mp4")
    jax_root = tmp_path_factory.mktemp("jax_mp4")
    args = dict(n_videos=3, frames=FRAMES, samplerate=SR, seconds=SECONDS,
                image_hw=(80, 96), mp4=True)
    ids = write_synthetic_dataset(port_root, **args)
    assert jax_write_synthetic_dataset(jax_root, **args) == ids
    return port_root, jax_root, ids


@pytest.fixture(scope="module")
def js():
    return jax_state(0)


def test_the_mp4_fixtures_decode_to_the_same_frames_in_both_packages(datasets):
    port_root, jax_root, ids = datasets
    for vid in ids:
        assert (port_root / "videos" / f"{vid}.mp4").stat().st_size > 0
    for i in range(len(ids)):
        want = JaxPerFrameEvalSource(jax_root, ids, JaxDataConfig(**KW)).load(i)
        for root in (port_root, jax_root):
            got = PerFrameEvalSource(root, ids, DataConfig(**KW)).load(i)
            assert got["id"] == want["id"] == ids[i]
            assert got["clip"].dtype == np.uint8 and got["clip"].shape == (FRAMES, IMG, IMG, 3)
            np.testing.assert_array_equal(got["clip"], want["clip"])
            np.testing.assert_array_equal(got["waveform"], want["waveform"])


def test_undecodable_videos_and_wavs_are_skipped(datasets, tmp_path):
    port_root, _, ids = datasets
    root = tmp_path / "broken"
    shutil.copytree(port_root, root)
    (root / "videos" / f"{ids[0]}.mp4").write_bytes(b"not a video")
    (root / "audio" / f"{ids[1]}.wav").write_bytes(b"not a wav")
    src = PerFrameEvalSource(root, ids, DataConfig(**KW))
    with pytest.raises(SkippedSampleError, match="undecodable or single-frame"):
        src.load(0)
    with pytest.raises(SkippedSampleError, match=ids[1]):
        src.load(1)
    assert src.load(2)["clip"].shape[0] == FRAMES


def _jax_masks(state, sample, spec_cfg, k):
    """The masks the JAX package's `evaluate_perframe` scores for one video."""
    idxs = list(range(4, FRAMES - 1, 4))
    frames = jeval._pad_rows(sample["clip"][idxs], jeval.bucket_len(len(idxs)))
    return np.asarray(jeval._perframe_masks(state, jnp.asarray(frames),
                                            jnp.asarray(sample["waveform"]), spec_cfg))[:k]


def test_evaluate_perframe_gives_the_jax_package_s_metrics(datasets, js):
    """Float32 models on both sides, the same weights, the same decoded
    videos: the same masks, so the same cIoU, AUC and mTC."""
    port_root, _, ids = datasets
    jax_spec, port_spec = (JaxSpectrogramConfig(samplerate=SR, seconds=SECONDS),
                           SpectrogramConfig(samplerate=SR, seconds=SECONDS))
    jax_src = JaxPerFrameEvalSource(port_root, ids, JaxDataConfig(**KW))
    port_src = PerFrameEvalSource(port_root, ids, DataConfig(**KW))
    want = jeval.evaluate_perframe(js, jax_src, JaxDataConfig(**KW), jax_spec,
                                   jax_synthetic_gt_lookup())
    model = port_model(js)
    got = teval.evaluate_perframe(model, port_src, DataConfig(**KW), port_spec,
                                  hardway._synthetic_gt_lookup())
    assert set(got) == set(want) == {"test_ciou", "test_auc", "test_mtc"}
    # the masks behind the metrics are equal, pixel for pixel (within the
    # tests/test_export.py bar of 16 median flips a map, none are seen), so the
    # metrics agree to float rounding
    k = len(range(4, FRAMES - 1, 4))
    for i in range(len(ids)):
        sample = port_src.load(i)
        tm = teval._perframe_masks(model, torch.from_numpy(sample["clip"][[4, 8]]),
                                   torch.from_numpy(sample["waveform"]), port_spec).numpy()
        np.testing.assert_array_equal(tm, _jax_masks(js, sample, jax_spec, k))
    for key in want:
        assert abs(got[key] - want[key]) <= METRIC_ATOL, (key, got[key], want[key])
    for v in got.values():
        assert np.isfinite(v)


def test_the_trainer_runs_the_per_frame_test_where_videos_and_gt_are_given(datasets,
                                                                             tmp_path):
    port_root, _, ids = datasets
    root = tmp_path / "data"
    shutil.copytree(port_root, root)
    # per-frame ground truth: the clip's box for every frame, `<id>_<frame>.xml`
    (root / "gt").mkdir()
    for vid in ids:
        for fi in range(FRAMES):
            shutil.copy(root / "anno" / f"{vid}.xml", root / "gt" / f"{vid}_{fi}.xml")
    args = ["--device", "cpu", "--compute_dtype", "float32", "--image_size", str(IMG),
            "--frame_density", "2", "--batch_size", "2", "--samplerate", str(SR),
            "--audio_seconds", str(SECONDS), "--n_threads", "2", "--sampling_rate", "4",
            "--data_path", str(root), "--og_data_path", str(root), "--og_gt_path",
            str(root / "anno"), "--metadata_dir", str(root / "metadata"),
            "--summaries_dir", str(tmp_path / "ckpt"), "--epochs", "1"]
    final = hardway.run(ExperimentConfig.from_args([*args, "--gt_path", str(root / "gt")]),
                        steps_cap=1)
    for key in ("test_ciou", "test_auc", "test_mtc"):
        assert np.isfinite(final[key]) and 0.0 <= final[key] <= 1.0, (key, final[key])
    # without --gt_path there is no per-frame test, as in the JAX package
    without = hardway.run(ExperimentConfig.from_args(args), steps_cap=1)
    assert not any(k.startswith("test_") for k in without)
    # every video unreadable: NaN, as `avtubes/train/evaluate.py:263-264`
    for vid in ids:
        (root / "videos" / f"{vid}.mp4").write_bytes(b"")
    nan = hardway.run(ExperimentConfig.from_args([*args, "--gt_path", str(root / "gt")]),
                      steps_cap=1)
    assert all(np.isnan(nan[k]) for k in ("test_ciou", "test_auc", "test_mtc")), nan
