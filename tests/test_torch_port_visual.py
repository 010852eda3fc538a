"""The overlay images of `--record_qualitative` in the port against the JAX
package's: `overlay_heatmap` bit-equal through OpenCV and through the numpy
fallback, `MetricLogger.log_image`'s files, and the names the two
evaluations write."""

import sys

import numpy as np
import pytest

from avtubes.core.config import DataConfig as JaxDataConfig
from avtubes.data import pipeline as jpipe
from avtubes.train import evaluate as jeval
from avtubes.train.hardway import _synthetic_gt_lookup as jax_synthetic_gt_lookup
from avtubes.utils import visual as jvisual
from avtubes.utils.logging import MetricLogger as JaxMetricLogger
from avtubes_torch.core.config import DataConfig
from avtubes_torch.data import pipeline as tpipe
from avtubes_torch.train import evaluate as teval
from avtubes_torch.train.hardway import _synthetic_gt_lookup
from avtubes_torch.utils import visual as tvisual
from avtubes_torch.utils.logging import MetricLogger
from torch_port_util import IMG, jax_state, port_model, spec_cfgs

pytest.importorskip("cv2")
EVAL = dict(image_size=IMG, frame_density=6, sampling_rate=2, samplerate=8000,
            audio_seconds=1)


def _case(name: str):
    """(frame, pred, gt) made with numpy from a seed."""
    rng = np.random.RandomState(len(name))
    frame = rng.randint(0, 256, (48, 40, 3)).astype(np.uint8)
    pred = rng.rand(14, 14).astype(np.float32)
    gt = (rng.rand(48, 40) > 0.5).astype(np.float64)
    if name == "float_frame_in_0_1":
        return frame / 255.0, pred, gt
    if name == "map_at_the_frame_size_no_gt":
        return frame, rng.rand(48, 40), None
    if name == "float_frame_above_1_gt_outside_0_1":
        return frame.astype(np.float32) * 0.9, pred, gt * 1.7 - 0.3
    if name == "binary_mask_224":      # what the evaluations pass: a mask at 224x224
        return (rng.randint(0, 256, (224, 224, 3)).astype(np.uint8),
                (rng.rand(224, 224) > 0.5).astype(np.float32), gt)
    return frame, pred, gt


CASES = ("uint8_frame_14x14_map_gt", "float_frame_in_0_1", "map_at_the_frame_size_no_gt",
         "float_frame_above_1_gt_outside_0_1", "binary_mask_224")


@pytest.mark.parametrize("case", CASES)
def test_overlay_is_bit_equal_through_opencv(case):
    frame, pred, gt = _case(case)
    got = tvisual.overlay_heatmap(frame, pred, gt)
    want = jvisual.overlay_heatmap(frame, pred, gt)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_overlay_is_bit_equal_through_the_numpy_fallback(case, monkeypatch):
    frame, pred, gt = _case(case)
    with_cv2 = tvisual.overlay_heatmap(frame, pred, gt)
    monkeypatch.setitem(sys.modules, "cv2", None)      # `import cv2` raises ImportError
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    got = tvisual.overlay_heatmap(frame, pred, gt)
    want = jvisual.overlay_heatmap(frame, pred, gt)
    np.testing.assert_array_equal(got, want)
    assert got.shape == with_cv2.shape


def test_log_image_writes_the_jax_package_s_files(tmp_path):
    image = tvisual.overlay_heatmap(*_case(CASES[0]))
    port = MetricLogger(tmp_path / "port", run_name="r")
    jax_logger = JaxMetricLogger(tmp_path / "jax", run_name="r")
    for logger in (port, jax_logger):
        logger.log_image("clip_hardway", image, step=3)
        logger.log_image("no_step", image)
    names = sorted(p.name for p in (tmp_path / "port" / "images").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "images").iterdir())
    assert names == ["clip_hardway_3.jpg", "no_step.jpg"]
    for n in names:      # the same PIL encoder on the same pixels
        assert (tmp_path / "port" / "images" / n).read_bytes() == \
            (tmp_path / "jax" / "images" / n).read_bytes()
    # no summaries_dir: nothing is written, nothing raises
    MetricLogger(None).log_image("x", image, step=0)


@pytest.fixture(scope="module")
def models():
    js = jax_state(0)
    return js, port_model(js)


def _image_names(path):
    d = path / "images"
    return sorted(p.name for p in d.iterdir()) if d.exists() else []


@pytest.mark.parametrize("record", [0, 3])
def test_evaluate_hardway_records_the_jax_package_s_overlays(tmp_path, models, record):
    js, model = models
    jcfg, cfg = spec_cfgs()

    def source(pkg, data_cfg):
        return pkg.BatchLoader(pkg.SyntheticSource(data_cfg, n=5, clip=False, seed=1), 2,
                               num_workers=1, shuffle=False, drop_last=False)

    got = teval.evaluate_hardway(model, source(tpipe, DataConfig(**EVAL)), DataConfig(**EVAL),
                                 cfg, _synthetic_gt_lookup(), epoch=2,
                                 logger=MetricLogger(tmp_path / "port"), record=record)
    want = jeval.evaluate_hardway(js, source(jpipe, JaxDataConfig(**EVAL)),
                                  JaxDataConfig(**EVAL), jcfg, jax_synthetic_gt_lookup(),
                                  epoch=2, logger=JaxMetricLogger(tmp_path / "jax"),
                                  record=record)
    assert got == want
    names = _image_names(tmp_path / "port")
    assert names == _image_names(tmp_path / "jax")
    assert names == sorted(f"synthetic_{i}_hardway_2.jpg" for i in range(record))


@pytest.mark.parametrize("record", [0, 2])
def test_evaluate_perframe_records_the_jax_package_s_overlays(tmp_path, models, record):
    js, model = models
    jcfg, cfg = spec_cfgs()
    port_src = tpipe.SyntheticSource(DataConfig(**EVAL), n=3, clip=True, seed=1)
    jax_src = jpipe.SyntheticSource(JaxDataConfig(**EVAL), n=3, clip=True, seed=1)
    got = teval.evaluate_perframe(model, port_src, DataConfig(**EVAL), cfg,
                                  _synthetic_gt_lookup(), logger=MetricLogger(tmp_path / "port"),
                                  record=record, epoch=1)
    want = jeval.evaluate_perframe(js, jax_src, JaxDataConfig(**EVAL), jcfg,
                                   jax_synthetic_gt_lookup(),
                                   logger=JaxMetricLogger(tmp_path / "jax"), record=record,
                                   epoch=1)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    names = _image_names(tmp_path / "port")
    assert names == _image_names(tmp_path / "jax")
    # frames 2 and 4 of each 6-frame clip (stride 2, < T-1)
    assert names == sorted(f"synthetic_{v}_test_frame_{f}_1.jpg"
                           for v in range(record) for f in (2, 4))
