"""int8 inference of the port (`ops/int8_conv.py`, `QuantConv2d`,
`AVENet(quant_int8=True)`) against the JAX package's `QuantConv` and
`AVENet(quant_int8=True)`: the same weights, the same numpy-made inputs.

The JAX package runs its models compiled, and XLA compiles its "/ 127.0"
into a product with float32(1/127); the port computes the scales that way,
so one convolution is bit-equal to the jitted JAX one.  Through a whole
backbone, BatchNorm's float32 sums run in another order in the two
packages, a scale moves by an ulp, and a few values round to the other
int8 level: the models are held to `tests/test_quant.py`'s export-vs-live
bar (float32) and, in bf16, to `tests/test_bf16.py`'s mask and logit bars
and to the JAX package's own bf16-vs-float32 gap (see the bf16 test).  Both
dtypes run at 112x112 / 129x96, the geometry that avoids the CPU's bf16
one-column defect, so they share the two JAX compiles.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.config import ExperimentConfig as JaxExperimentConfig
from avtubes.models import AVENet as JaxAVENet
from avtubes.models.resnet2d import QuantConv as JaxQuantConv
from avtubes_torch.core.convert import avenet_from_flax
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.models.resnet2d import Conv2d, QuantConv2d
from avtubes_torch.ops import int8_conv
from torch_port_util import jax_avenet_state, numpy_variables

torch.set_num_threads(2)
# tests/test_quant.py:31-44, int8 against the plain model on the same weights
QUANT_HEATMAP_ATOL = 0.02
QUANT_PEARSON = 0.98
# tests/test_quant.py:84-118: one int8 forward against another compile of it;
# a scale one ulp apart flips round() at .5 boundaries
EXPORT_VS_LIVE_ATOL = 5e-3
# tests/test_bf16.py:49,54,61
BF16_PEARSON = 0.999
BF16_IOU = 0.95
BF16_LOGIT_ATOL = 0.15
# tests/test_quant.py:59-74: a sample's answer whatever its neighbours
NEIGHBOUR_ATOL = 5e-5
# the bf16 geometry that avoids the CPU's one-column bf16 defect (ROADMAP host facts)
BF16_FRAME, BF16_SPEC = 112, (129, 96)


@pytest.fixture(scope="module")
def js():
    return jax_avenet_state(0)


@pytest.fixture(scope="module")
def variables(js):
    return numpy_variables(js)


def _port(variables, quant: bool, dtype: str = "float32") -> AVENet:
    model = AVENet(generator=torch.Generator().manual_seed(1), compute_dtype=dtype,
                   quant_int8=quant)
    model.load_state_dict(avenet_from_flax(variables), strict=True)
    return model.eval()


def _forward(model, img, aud):
    with torch.inference_mode():
        return model(torch.from_numpy(img), torch.from_numpy(aud))


def _jax_forward(variables, img, aud, dtype=jnp.float32):
    model = JaxAVENet(hardway=JaxExperimentConfig().hardway, dtype=dtype, quant_int8=True)
    return jax.device_get(jax.jit(lambda v, i, a: model.apply(v, i, a, train=False))(
        variables, img, aud))


def _jax_forwards(variables, img, aud, dtypes):
    """`_jax_forward` in each dtype, the compiles side by side (XLA compiles
    outside the interpreter lock)."""
    with ThreadPoolExecutor(len(dtypes)) as pool:
        return list(pool.map(lambda d: _jax_forward(variables, img, aud, d), dtypes))


# ------------------------------------------------------- one convolution

def _jax_quantities(kernel, x):
    """What `QuantConv.__call__` computes (avtubes/models/resnet2d.py:130-136),
    compiled: (sw, sx) from its expressions, and the int8 operands (wq, xq)
    that its own call hands to `lax.conv_general_dilated`."""
    seen = []
    conv = jax.lax.conv_general_dilated

    def spy(lhs, rhs, *args, **kwargs):
        seen.extend([lhs, rhs])
        return conv(lhs, rhs, *args, **kwargs)

    k = kernel.shape[0]
    module = JaxQuantConv(kernel.shape[-1], (k, k), padding=k // 2)

    @jax.jit
    def run(kernel, x):
        jax.lax.conv_general_dilated = spy
        try:
            module.apply({"params": {"kernel": kernel}}, x)
        finally:
            jax.lax.conv_general_dilated = conv
        sw = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-12) / 127.0
        sx = jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32)), axis=(1, 2, 3)),
                         1e-12) / 127.0
        return sw, sx, seen[1], seen[0]

    return [np.asarray(a) for a in run(kernel, x)]


@pytest.mark.parametrize("cin,cout,k", [(3, 64, 7), (1, 64, 7), (64, 64, 3), (64, 128, 1)],
                         ids=["vision_stem", "audio_stem", "3x3", "1x1_downsample"])
def test_quantized_weights_and_scales_are_the_jax_package_s(cin, cout, k):
    rng = np.random.RandomState(k + cin)
    kernel = (rng.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cout))).astype(np.float32)
    kernel[..., 5] = 0.0                                 # a dead channel: the 1e-12 floor
    x = rng.randn(3, 11, 9, cin).astype(np.float32)
    x[1] *= 40.0
    sw_j, sx_j, wq_j, xq_j = _jax_quantities(kernel, x)
    wq, packed, sw = int8_conv.quantize_weight(torch.from_numpy(kernel).permute(3, 2, 0, 1))
    xq, sx = int8_conv.quantize_activation(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(sw.numpy(), sw_j)
    np.testing.assert_array_equal(sx.numpy(), sx_j)
    assert wq.dtype == xq.dtype == torch.int8
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(), wq_j)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), xq_j)
    # the packed weight: K in (kh, kw, C) order, zero columns up to a multiple of 8
    assert packed.shape == (cout, int8_conv.padded_k(k * k * cin)) and packed.shape[1] % 8 == 0
    np.testing.assert_array_equal(packed[:, :k * k * cin].numpy(),
                                  wq_j.reshape(-1, cout).T)
    assert not packed[:, k * k * cin:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
def test_one_quant_conv_is_bit_equal_to_jax_quantconv(stride, dtype):
    rng = np.random.RandomState(stride)
    kernel = (rng.randn(3, 3, 64, 64) * 0.06).astype(np.float32)
    x = rng.randn(2, 13, 10, 64).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    module = JaxQuantConv(64, (3, 3), strides=(stride, stride), padding=1, dtype=jdt)
    want = np.asarray(jax.jit(module.apply)({"params": {"kernel": kernel}},
                                            jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    conv = QuantConv2d(64, 64, 3, stride=stride, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        got = conv(xt)
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("cin,k,stride,pad,hw,b", [
    (3, 7, 2, 3, (12, 10), 2),     # vision stem: K 147 -> 152
    (1, 7, 2, 3, (17, 9), 2),      # audio stem: K 49 -> 56
    (64, 3, 1, 1, (2, 3), 1),      # M = 6 rows -> 17
    (64, 1, 2, 0, (9, 8), 3)])
def test_int_mm_product_with_padding_equals_the_float64_convolution(cin, k, stride, pad, hw, b):
    g = torch.Generator().manual_seed(cin + k)
    xq = torch.randint(-127, 128, (b, cin, *hw), generator=g, dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (64, cin, k, k), generator=g, dtype=torch.int8)
    packed = torch.zeros(64, int8_conv.padded_k(k * k * cin), dtype=torch.int8)
    packed[:, :k * k * cin] = wq.permute(0, 2, 3, 1).reshape(64, -1)
    a, (_, ho, wo) = int8_conv.im2col_nhwc(xq, k, stride, pad)
    assert a.shape[0] >= int8_conv.MIN_ROWS and a.shape[1] % 8 == 0
    assert a.shape[1] == packed.shape[1]
    got = int8_conv.int8_conv2d(xq, packed, k, stride, pad)
    want = int8_conv.int8_conv2d_plain(xq, wq, stride, pad)
    assert got.dtype == want.dtype == torch.int32 and got.shape == (b, ho, wo, 64)
    assert torch.equal(got, want)
    # the float64 reference is exact at the widest K the backbones have (3x3x512)
    extreme = torch.full((1, 512, 3, 3), 127, dtype=torch.int8)
    assert int(int8_conv.int8_conv2d_plain(extreme, extreme[:1], 1, 0)) == 4608 * 127 ** 2


# ---------------------------------------------------------- the model

@pytest.fixture(scope="module")
def case(variables):
    """At the bf16 geometry (both dtypes share it, and so share the JAX
    compiles): the inputs and the JAX package's int8 forwards in bf16 and in
    float32."""
    rng = np.random.RandomState(4)
    img = rng.randn(2, BF16_FRAME, BF16_FRAME, 3).astype(np.float32)
    aud = (rng.randn(2, *BF16_SPEC, 1) * 0.5).astype(np.float32)
    return (img, aud, *_jax_forwards(variables, img, aud, (jnp.bfloat16, jnp.float32)))


def _pearson(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.asarray([np.corrcoef(a[i].ravel(), b[i].ravel())[0, 1] for i in range(len(a))])


def test_int8_avenet_matches_the_jax_package_s_in_float32(variables, case):
    img, aud, _, want = case
    model = _port(variables, quant=True)
    assert sum(isinstance(m, QuantConv2d) for m in model.modules()) == 40
    got = _forward(model, img, aud)
    np.testing.assert_allclose(got.heatmap.numpy(), want.heatmap, atol=EXPORT_VS_LIVE_ATOL)
    live = want.logits > -100
    np.testing.assert_allclose(got.logits.numpy()[live], want.logits[live],
                               atol=10 * EXPORT_VS_LIVE_ATOL)


def test_int8_avenet_matches_the_jax_package_s_in_bf16(variables, case):
    """tests/test_bf16.py's mask IoU and logit bars between the two packages'
    bf16 int8 forwards.  Its Pearson bar (0.999 against float32) is out of
    an int8 model's reach: a bf16 rounding moves values across int8 levels,
    and the JAX package's own bf16 int8 heatmap correlates with its float32
    int8 one at only ~0.995 here.  So the port's bf16 int8 heatmap is held
    to that gap: per sample, its correlation deficit against the float32
    int8 heatmap (which the two packages share to 1e-3) at most 1.25 times
    the JAX package's own (measured: 1.00 times), the margin for the bf16
    roundings that the two packages place differently."""
    img, aud, want16, want32 = case
    got = _forward(_port(variables, quant=True, dtype="bfloat16"), img, aud)
    jax_own = _pearson(want16.heatmap, want32.heatmap)
    assert jax_own.min() < BF16_PEARSON                   # why the Pearson bar is not used
    assert np.all(1 - _pearson(got.heatmap, want32.heatmap) <= 1.25 * (1 - jax_own))
    mg = heatmap_to_mask_batch(got.heatmap.float()).numpy()
    mw = heatmap_to_mask_batch(torch.tensor(np.asarray(want16.heatmap, np.float32))).numpy()
    iou = (mg * mw).sum(axis=(1, 2)) / ((mg + mw) > 0).sum(axis=(1, 2))
    assert iou.min() >= BF16_IOU, iou
    live = want16.logits > -100
    np.testing.assert_allclose(got.logits.numpy()[live], want16.logits[live],
                               atol=BF16_LOGIT_ATOL)


@pytest.fixture(scope="module")
def quant_inputs():
    """tests/test_quant.py's geometry: unit normal frames and 'spectrograms'
    of 64x64."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
            rng.normal(size=(2, 64, 64, 1)).astype(np.float32))


def test_int8_matches_the_plain_model_within_quantization_noise(variables, quant_inputs):
    plain = _forward(_port(variables, quant=False), *quant_inputs)
    quant = _forward(_port(variables, quant=True), *quant_inputs)
    hp, hq = plain.heatmap.double().numpy(), quant.heatmap.double().numpy()
    assert 0 < np.abs(hp - hq).max() < QUANT_HEATMAP_ATOL
    assert np.corrcoef(hp.ravel(), hq.ravel())[0, 1] > QUANT_PEARSON
    lp, lq = plain.logits.double().numpy(), quant.logits.double().numpy()
    assert np.corrcoef(lp.ravel(), lq.ravel())[0, 1] > QUANT_PEARSON


def test_a_sample_s_answer_does_not_depend_on_its_neighbours(variables, quant_inputs):
    img, aud = quant_inputs
    model = _port(variables, quant=True)
    solo = _forward(model, img[:1], aud[:1])
    loud = _forward(model, np.concatenate([img[:1], img[1:] * 50.0]),
                    np.concatenate([aud[:1], aud[1:] * 50.0]))
    padded = _forward(model, np.concatenate([img[:1], np.zeros_like(img[:3])]),
                      np.concatenate([aud[:1], np.zeros_like(aud[:3])]))
    for other in (loud, padded):
        np.testing.assert_allclose(other.heatmap[:1].numpy(), solo.heatmap.numpy(),
                                   atol=NEIGHBOUR_ATOL)


def test_training_mode_raises(variables, quant_inputs):
    model = _port(variables, quant=True).train()
    with pytest.raises(ValueError, match="inference-only"):
        model(*(torch.from_numpy(a) for a in quant_inputs))


def test_a_plain_state_dict_loads_strictly_and_the_cache_stays_out_of_it(variables):
    plain = _port(variables, quant=False)
    quant = AVENet(quant_int8=True)
    assert quant.load_state_dict(plain.state_dict(), strict=True)
    assert set(quant.state_dict()) == set(plain.state_dict())
    quant.eval()
    conv = quant.audnet.layer2[0].downsample[0]
    assert isinstance(conv, QuantConv2d) and isinstance(conv, Conv2d)
    _, packed, _ = conv.quantized_weight()
    assert packed.dtype == torch.int8
    assert set(quant.state_dict()) == set(plain.state_dict())
    assert not any(t.dtype == torch.int8 for t in quant.state_dict().values())


def test_the_weight_cache_refreshes_after_load_state_dict(variables):
    model = _port(variables, quant=True)
    conv = model.imgnet.conv1
    wq, packed, sw = conv.quantized_weight()
    assert conv.quantized_weight()[1] is packed            # cached while the weight stands
    state = model.state_dict()
    state["imgnet.conv1.weight"] = state["imgnet.conv1.weight"] * 3.0
    model.load_state_dict(state, strict=True)
    wq2, packed2, sw2 = conv.quantized_weight()
    assert packed2 is not packed
    torch.testing.assert_close(sw2, sw * 3.0, rtol=1e-6, atol=0)
    assert torch.equal(wq2, int8_conv.quantize_weight(conv.weight.detach())[0])
