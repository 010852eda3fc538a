"""The bfloat16 compute dtype of the port's FullModel against the JAX
package's `FullModel(dtype=jnp.bfloat16)` and against float32.

The bars of `tests/test_bf16.py` (heatmap Pearson >= 0.999 a frame, mask IoU
>= 0.95, live logits within 0.15) are bars of a bf16 forward against the
float32 forward on the same weights: the port's bf16 and the JAX package's
bf16 are each held to them against the float32 forward (the two float32
forwards agree to 3e-6).  Between the two bf16 forwards, two independent
roundings of every activation, the same bars compose by the triangle
inequality: an angle of at most 2 arccos(0.999) between the centred
heatmaps (Pearson >= cos(2 arccos 0.999) = 0.996), a Jaccard distance of at
most 2 x 0.05, logits within 2 x 0.15.  Measured here: bf16 against float32
0.99901-0.99926 (JAX) and 0.99946-0.99960 (port) a frame; port bf16 against
JAX bf16 0.99871-0.99902, which the 2D model's tests hold at 0.999 but this
deeper 3D tower (27 x the sums a convolution output) does not.

Geometry: 112x112 frames and 129x96 spectrograms, as in
`test_torch_port_bf16.py` (the CPU's oneDNN bfloat16 convolution is wrong
where a stride-2 output is one column wide; no shape here has one)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.config import ExperimentConfig as JaxExperimentConfig
from avtubes.models import FullModel as JaxFullModel
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from torch_port_util import jax_fullmodel_state, numpy_variables, port_fullmodel

torch.set_num_threads(2)
B, T = 2, 2
FRAME, SPEC = 112, (129, 96)
# the bars of tests/test_bf16.py:49,54,61: a bf16 forward against float32
PEARSON_MIN, IOU_MIN, LOGIT_ATOL = 0.999, 0.95, 0.15
# two bf16 forwards, each within those bars of the same float32 forward
PAIR_BARS = (math.cos(2 * math.acos(PEARSON_MIN)), 1 - 2 * (1 - IOU_MIN), 2 * LOGIT_ATOL)


@pytest.fixture(scope="module")
def forwards():
    """The four forwards on one batch: JAX and port, float32 and bf16."""
    js = jax_fullmodel_state(0)
    rng = np.random.RandomState(2)
    video = rng.randn(B, T, FRAME, FRAME, 3).astype(np.float32)
    spec = (rng.randn(B, *SPEC, 1) * 0.5).astype(np.float32)
    out = {}
    for name, dtype in (("jax_float32", jnp.float32), ("jax_bfloat16", jnp.bfloat16)):
        model = JaxFullModel(hardway=JaxExperimentConfig().hardway, dtype=dtype)
        out[name] = jax.device_get(jax.jit(
            lambda v, a, x, m=model: m.apply(v, a, x, train=False,
                                             method="forward_shared_audio"))(
            numpy_variables(js), jnp.asarray(spec), jnp.asarray(video)))
    for dtype in ("float32", "bfloat16"):
        model = port_fullmodel(js, dtype)
        with torch.no_grad():
            if dtype == "bfloat16":
                assert model.encode_video(torch.from_numpy(video)).dtype == torch.bfloat16
            out[f"port_{dtype}"] = model.forward_shared_audio(torch.from_numpy(spec),
                                                              torch.from_numpy(video))
        assert all(p.dtype == torch.float32 for p in model.parameters())
    return out


def _hold(got, want, what, bars=(PEARSON_MIN, IOU_MIN, LOGIT_ATOL)):
    pearson_min, iou_min, logit_atol = bars
    hg, hw = np.asarray(got.heatmap, np.float64), np.asarray(want.heatmap, np.float64)
    for i in range(hg.shape[0]):
        r = np.corrcoef(hg[i].ravel(), hw[i].ravel())[0, 1]
        assert r >= pearson_min, f"{what}: frame {i} heatmap correlation {r}"
    mg = heatmap_to_mask_batch(torch.from_numpy(hg.astype(np.float32))).numpy()
    mw = heatmap_to_mask_batch(torch.from_numpy(hw.astype(np.float32))).numpy()
    iou = (mg * mw).sum(axis=(1, 2)) / ((mg + mw) > 0).sum(axis=(1, 2))
    assert iou.min() >= iou_min, f"{what}: mask IoU {iou}"
    lg, lw = np.asarray(got.logits), np.asarray(want.logits)
    live = lw > -100
    np.testing.assert_allclose(lg[live], lw[live], atol=logit_atol, err_msg=what)


def test_the_two_float32_forwards_agree(forwards):
    for field in ("heatmap", "logits"):
        want = np.asarray(getattr(forwards["jax_float32"], field))
        got = getattr(forwards["port_float32"], field).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_bf16_meets_the_bars_against_float32(forwards, package):
    bf16 = forwards[f"{package}_bfloat16"]
    _hold(bf16, forwards["jax_float32"], f"{package} bf16 vs float32")
    # and it is a bf16 forward, not float32 run again
    diff = np.abs(np.asarray(bf16.heatmap) - np.asarray(forwards["jax_float32"].heatmap))
    assert diff.max() > 1e-5


def test_port_bf16_against_jax_bf16_within_the_composed_bars(forwards):
    assert PAIR_BARS == pytest.approx((0.996002, 0.9, 0.3), abs=1e-6)
    _hold(forwards["port_bfloat16"], forwards["jax_bfloat16"], "port bf16 vs JAX bf16",
          PAIR_BARS)


def test_the_head_stays_float32_under_bf16(forwards):
    assert all(t.dtype == torch.float32 for t in forwards["port_bfloat16"])
