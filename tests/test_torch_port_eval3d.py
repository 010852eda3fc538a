"""The 3D tube model's evaluations and trainer in the port against the JAX
package's: `evaluate_perframe(model_kind="3d")` on cv2-written `.mp4`
fixtures (each video's sampled frames as ONE clip, not padded),
`evaluate_hardway(model_kind="3d")` (each frame a clip of one frame), and
`train3d.run` end to end on the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.config import DataConfig as JaxDataConfig
from avtubes.data import pipeline as jpipe
from avtubes.data.spectrogram import SpectrogramConfig as JaxSpectrogramConfig
from avtubes.train import evaluate as jeval
from avtubes.train.hardway import _synthetic_gt_lookup as jax_synthetic_gt_lookup
from avtubes_torch.core.checkpoint import latest_checkpoint
from avtubes_torch.core.config import DataConfig, ExperimentConfig
from avtubes_torch.data import pipeline as tpipe
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.data.synthetic import write_synthetic_dataset
from avtubes_torch.train import evaluate as teval
from avtubes_torch.train import train3d
from avtubes_torch.train.hardway import _synthetic_gt_lookup
from torch_port_util import IMG, jax_fullmodel_state, port_fullmodel

pytest.importorskip("cv2")
torch.set_num_threads(2)
SR, SECONDS = 8000, 1
FRAMES = 10
KW = dict(image_size=IMG, sampling_rate=3, samplerate=SR, audio_seconds=SECONDS)
METRIC_ATOL = 1e-6    # means of equal per-frame values, summed in another order
MASK_FLIPS = 16       # a map, against the JAX package's: pixels at the median threshold
#                       (tests/test_export.py's bar)
# what `avtubes/train/train3d.py::run` returns: the step's metrics
# (`avtubes/train/steps.py:343`) and the per-frame test's (`evaluate.py:265-269`)
JAX_RUN_KEYS = {"loss", "np_ratio", "test_ciou", "test_auc", "test_mtc"}
CPU32 = ["--device", "cpu", "--compute_dtype", "float32"]
SMALL = ["--synthetic", "--image_size", "32", "--frame_density", "2", "--batch_size", "2",
         "--samplerate", str(SR), "--audio_seconds", str(SECONDS), "--n_threads", "2",
         "--learning_rate", "1e-4", "--epochs", "1"]


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A trainer's checkpoints (hundreds of MB at full width) are removed
    after each test: the suite keeps its temporary directories."""
    yield
    for path in tmp_path.glob("*_ep*"):
        path.unlink()


@pytest.fixture(scope="module")
def js():
    return jax_fullmodel_state(0)


@pytest.fixture(scope="module")
def model(js):
    return port_fullmodel(js)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """`.mp4` fixtures written by the port (the same files as the JAX
    package's writer, `test_torch_port_perframe.py`): (root, ids)."""
    root = tmp_path_factory.mktemp("mp4")
    ids = write_synthetic_dataset(root, n_videos=3, frames=FRAMES, samplerate=SR,
                                  seconds=SECONDS, image_hw=(80, 96), mp4=True)
    return root, ids


def test_evaluate_perframe_3d_gives_the_jax_package_s_masks_and_metrics(js, model, videos):
    root, ids = videos
    jax_spec = JaxSpectrogramConfig(samplerate=SR, seconds=SECONDS)
    port_spec = SpectrogramConfig(samplerate=SR, seconds=SECONDS)
    port_src = tpipe.PerFrameEvalSource(root, ids, DataConfig(**KW))
    want = jeval.evaluate_perframe(js, jpipe.PerFrameEvalSource(root, ids, JaxDataConfig(**KW)),
                                   JaxDataConfig(**KW), jax_spec, jax_synthetic_gt_lookup(),
                                   model_kind="3d")
    got = teval.evaluate_perframe(model, port_src, DataConfig(**KW), port_spec,
                                  _synthetic_gt_lookup(), model_kind="3d")
    assert set(got) == set(want) == {"test_ciou", "test_auc", "test_mtc"}
    idxs = list(range(3, FRAMES - 1, 3))                     # frames 3 and 6: k = 2
    for i in range(len(ids)):
        sample = port_src.load(i)
        clip, wave = sample["clip"][idxs], sample["waveform"]
        tm = teval._perframe_masks(model, torch.from_numpy(clip), torch.from_numpy(wave),
                                   port_spec, model_kind="3d").numpy()
        jm = np.asarray(jeval._perframe_masks_3d(js, jnp.asarray(clip), jnp.asarray(wave),
                                                 jax_spec))
        assert tm.shape == jm.shape == (len(idxs), 224, 224)      # one clip, not padded
        flips = np.abs(tm - jm).sum(axis=(1, 2))
        assert flips.max() <= MASK_FLIPS, flips          # measured: 3 pixels in one map of 6
    # cIoU >= 0.5 and the AUC over thresholds do not move for a few pixels here;
    # mTC, the IoU of consecutive masks (each about half of 224 x 224 set),
    # moves by at most 2 MASK_FLIPS / 25,088 (measured: 7.9e-6)
    mtc_atol = 2 * MASK_FLIPS / (224 * 224 // 2)
    for key, atol in (("test_ciou", METRIC_ATOL), ("test_auc", METRIC_ATOL),
                      ("test_mtc", mtc_atol)):
        assert np.isfinite(got[key]) and abs(got[key] - want[key]) <= atol, (key, got, want)


def test_the_3d_per_frame_clip_is_not_padded(model, videos):
    """A clip of k frames runs at length k: padding it to a bucket, as the
    2D path does, would change the masks near its end (3D convolutions
    couple neighbouring frames)."""
    root, ids = videos
    spec = SpectrogramConfig(samplerate=SR, seconds=SECONDS)
    sample = tpipe.PerFrameEvalSource(root, ids, DataConfig(**KW)).load(0)
    clip = sample["clip"][[1, 3, 5]]
    wave = torch.from_numpy(sample["waveform"])
    natural = teval._perframe_masks(model, torch.from_numpy(clip), wave, spec, "3d").numpy()
    padded = teval._perframe_masks(model, torch.from_numpy(teval._pad_rows(clip, 4)), wave,
                                   spec, "3d").numpy()[:3]
    assert natural.shape == (3, 224, 224)
    assert (natural != padded).any()


def test_evaluate_hardway_3d_gives_the_jax_package_s_ciou_and_auc(js, model):
    jcfg = JaxSpectrogramConfig(samplerate=SR, seconds=SECONDS)
    cfg = SpectrogramConfig(samplerate=SR, seconds=SECONDS)
    data = dict(image_size=IMG, samplerate=SR, audio_seconds=SECONDS)

    def loader(pkg, data_cfg):
        return pkg.BatchLoader(pkg.SyntheticSource(data_cfg, n=5, clip=False, seed=1), 2,
                               num_workers=1, shuffle=False, drop_last=False)

    want = jeval.evaluate_hardway(js, loader(jpipe, JaxDataConfig(**data)),
                                  JaxDataConfig(**data), jcfg, jax_synthetic_gt_lookup(),
                                  model_kind="3d")
    got = teval.evaluate_hardway(model, loader(tpipe, DataConfig(**data)), DataConfig(**data),
                                 cfg, _synthetic_gt_lookup(), model_kind="3d")
    assert got == want and got["hardway_n"] == 5
    # the masks themselves, frame for frame (each frame a clip of one frame)
    batch = next(loader(tpipe, DataConfig(**data)).epoch(0))
    tm = teval._hardway_eval_masks(model, torch.from_numpy(batch["frame"]),
                                   torch.from_numpy(batch["waveform"]), cfg,
                                   model_kind="3d").numpy()
    jm = np.asarray(jeval._hardway_eval_masks_3d(js, jnp.asarray(batch["frame"]),
                                                 jnp.asarray(batch["waveform"]), jcfg))
    np.testing.assert_array_equal(tm, jm)
    with pytest.raises(ValueError, match="model_kind"):
        teval.evaluate_hardway(model, loader(tpipe, DataConfig(**data)), DataConfig(**data),
                               cfg, _synthetic_gt_lookup(), model_kind="4d")


def _records(path) -> list[dict]:
    return [json.loads(line) for line in path.open()]


def test_the_trainer_trains_tests_records_checkpoints_and_resumes(tmp_path):
    args = [*CPU32, *SMALL, "--steps", "2", "--summaries_dir", str(tmp_path),
            "--record_qualitative", "1"]
    final = train3d.run(ExperimentConfig.from_args(args), steps_cap=2)
    assert set(final) == JAX_RUN_KEYS
    for key in JAX_RUN_KEYS:
        assert np.isfinite(final[key]), key
    assert 0.0 <= final["test_ciou"] <= 1.0 and 0.0 <= final["test_auc"] <= 1.0
    assert latest_checkpoint(tmp_path, "tube3d").name == "tube3d_ep0"
    payload = torch.load(tmp_path / "tube3d_ep0", weights_only=True)
    assert payload["step"] == 2 and payload["epoch"] == 0
    assert all(t.dtype in (torch.float32, torch.int64) for t in payload["params"].values())
    # the synthetic per-frame test: 4 clips of 4 frames at stride 1 -> frames 1 and 2;
    # the overlays of the first video, under the JAX package's names
    names = sorted(p.name for p in (tmp_path / "images").iterdir())
    assert names == ["synthetic_0_test_frame_1_0.jpg", "synthetic_0_test_frame_2_0.jpg"]
    # resume from tube3d_ep0: epoch 1 only, the step count goes on
    resumed = ExperimentConfig.from_args([*args, "--epochs", "2", "--use_pretrained"])
    again = train3d.run(resumed, steps_cap=2)
    assert set(again) == JAX_RUN_KEYS
    steps = [r["step"] for r in _records(tmp_path / "tube3d.metrics.jsonl") if "loss" in r]
    assert steps == [1, 2, 3, 4]
    assert latest_checkpoint(tmp_path, "tube3d").name == "tube3d_ep1"


def test_the_trainer_runs_bf16_by_default(tmp_path):
    """The default compute dtype, at 16 kHz x 2 s (the CPU's bf16 convolution
    fails on the audio tower at 8 kHz x 1 s: ROADMAP host facts)."""
    args = ["--device", "cpu", *SMALL, "--samplerate", "16000", "--audio_seconds", "2",
            "--steps", "1", "--summaries_dir", str(tmp_path)]
    cfg = ExperimentConfig.from_args(args)
    assert cfg.train.compute_dtype == "bfloat16"
    final = train3d.run(cfg, steps_cap=1, do_eval=False)
    assert set(final) == {"loss", "np_ratio"} and np.isfinite(final["loss"])
    payload = torch.load(tmp_path / "tube3d_ep0", weights_only=True)
    assert all(t.dtype in (torch.float32, torch.int64) for t in payload["params"].values())


@pytest.mark.parametrize("extra,match", [
    (["--conv3d_impl", "stacked"], "Not to port"),
    (["--conv3d_impl", "sum"], "Not to port"),
    (["--remat"], "Queue 1 item 12"),
    (["--compute_dtype", "float16"], "compute_dtype"),
])
def test_unported_options_raise(tmp_path, extra, match):
    cfg = ExperimentConfig.from_args(["--device", "cpu", *SMALL, "--summaries_dir",
                                      str(tmp_path), *extra])
    with pytest.raises((NotImplementedError, ValueError), match=match):
        train3d.run(cfg, steps_cap=1)
    assert not list(tmp_path.iterdir())


def test_the_per_frame_test_setup_follows_the_jax_package(tmp_path):
    cfg = ExperimentConfig.from_args([*CPU32, *SMALL])
    src, pf_cfg, lookup = train3d.perframe_test_setup(cfg)
    assert len(src) == 4 and pf_cfg.sampling_rate == 1 and pf_cfg.frame_density == 4
    assert src.load(0)["clip"].shape == (4, 32, 32, 3) and lookup("x", 1).shape == (224, 224)
    # real data: only with --gt_path and <data_path>/videos/
    root = tmp_path / "data"
    write_synthetic_dataset(root, n_videos=2, frames=4, samplerate=SR, seconds=SECONDS,
                            image_hw=(40, 48), mp4=True)
    real = ["--data_path", str(root), "--metadata_dir", str(root / "metadata")]
    assert train3d.perframe_test_setup(ExperimentConfig.from_args(real))[0] is None
    with_gt = ExperimentConfig.from_args([*real, "--gt_path", str(root / "anno")])
    src, pf_cfg, _ = train3d.perframe_test_setup(with_gt)
    assert isinstance(src, tpipe.PerFrameEvalSource) and pf_cfg == with_gt.data
