"""Weight bridge, encoders and hard-way head of the port against the JAX
package: the same weights (through `avenet_from_flax`) and the same
numpy-made inputs on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.models import HardwayConfig as JaxHardwayConfig
from avtubes.models import hardway_head as jax_hardway_head
from avtubes_torch.core.convert import avenet_from_flax
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.models.hardway import (
    HardwayConfig,
    global_pool_mask,
    hardway_head,
    l2_normalize,
)
from avtubes_torch.models.resnet2d import ResNet2D
from torch_port_util import IMG, jax_state, numpy_variables, port_model, spec_cfgs

# float32 convolutions accumulate in another order in XLA and in PyTorch's
# CPU kernels; 17 conv layers deep the features agree to about 1e-5
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def both():
    state = jax_state(seed=0)
    return state, port_model(state)


def _inputs(seed, batch=3):
    _, tcfg = spec_cfgs()
    rng = np.random.RandomState(seed)
    img = rng.randn(batch, IMG, IMG, 3).astype(np.float32)
    spec = rng.randn(batch, *tcfg.shape, 1).astype(np.float32)
    return img, spec


def test_bridge_loads_strict_and_covers_every_tensor(both):
    state, model = both
    sd = avenet_from_flax(numpy_variables(state))
    assert set(sd) == set(model.state_dict())
    assert sd["imgnet.conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["audnet.conv1_a.weight"].shape == (64, 1, 7, 7)
    assert sd["imgnet.layer2.0.downsample.0.weight"].shape == (128, 64, 1, 1)
    k = np.asarray(state.params["imgnet"]["layer1_block0"]["conv1"]["kernel"])
    np.testing.assert_array_equal(
        sd["imgnet.layer1.0.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["audnet.bn1.running_var"].numpy(),
        np.asarray(state.batch_stats["audnet"]["stem_bn"]["var"]))
    with pytest.raises(ValueError, match="unknown backbone entry"):
        avenet_from_flax({"params": {"imgnet": {"mystery": {}}, "audnet": {}}})


def test_image_and_audio_features_match(both):
    state, model = both
    img, spec = _inputs(1)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want_img = np.asarray(state.apply_fn(
        variables, jnp.asarray(img), train=False,
        method=lambda m, x, train: m.encode_image(x, train=train)))
    want_aud = np.asarray(state.apply_fn(
        variables, jnp.asarray(spec), train=False,
        method=lambda m, x, train: m.encode_audio(x, train=train)))
    with torch.no_grad():
        got_img = model.encode_image(torch.from_numpy(img)).numpy()
        got_aud = model.encode_audio(torch.from_numpy(spec)).numpy()
    assert got_img.shape == want_img.shape == (3, IMG // 16, IMG // 16, 512)
    assert got_aud.shape == want_aud.shape == (3, 512)
    np.testing.assert_allclose(got_img, want_img, **FEAT_TOL)
    np.testing.assert_allclose(got_aud, want_aud, **FEAT_TOL)


def _assert_head_close(got, want):
    # heatmap, maps and masks are cosines and sigmoids of them: 1e-5;
    # logits are sims divided by temperature 0.07 (and the masked own-pair
    # column by a further factor 99): 1e-3
    for name in ("heatmap", "weighted_map", "pos", "neg"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-3, rtol=1e-5)


HEAD_CASES = {
    "own_pool": ({}, False),
    "no_trimap": ({"trimap": False}, False),
    "no_neg": ({"use_neg": False}, False),
    "pool_block": ({"pool_block": 2}, False),
    "gathered_pool_with_offset": ({}, True),
}


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_hardway_head_matches(case):
    kwargs, gathered = HEAD_CASES[case]
    rng = np.random.RandomState(2)
    b, h, w, c = 4, 4, 4, 32
    # features with a positive mean, like post-ReLU maps: sims near the
    # 0.65 / 0.4 thresholds, where the sigmoids are not saturated
    img = (rng.randn(b, h, w, c) + 1.0).astype(np.float32)
    aud = (rng.randn(b, c) + 1.0).astype(np.float32)
    pool = (rng.randn(3 * b, c) + 1.0).astype(np.float32)
    pool[b:2 * b] = aud
    extra_j = dict(aud_all=jnp.asarray(pool), pool_offset=b) if gathered else {}
    extra_t = dict(aud_all=torch.from_numpy(pool), pool_offset=b) if gathered else {}
    want = jax_hardway_head(jnp.asarray(img), jnp.asarray(aud),
                            JaxHardwayConfig(**kwargs), **extra_j)
    got = hardway_head(torch.from_numpy(img), torch.from_numpy(aud),
                       HardwayConfig(**kwargs), **extra_t)
    expected_cols = (3 * b if gathered else b) + (1 if case == "no_neg" else 2)
    assert got.logits.shape == (b, expected_cols)
    _assert_head_close(got, want)


def test_head_runs_in_float32_whatever_the_input_dtype():
    rng = np.random.RandomState(3)
    img = torch.from_numpy(rng.randn(2, 4, 4, 16).astype(np.float32))
    aud = torch.from_numpy(rng.randn(2, 16).astype(np.float32))
    out = hardway_head(img.to(torch.bfloat16), aud.to(torch.bfloat16))
    assert all(t.dtype == torch.float32 for t in out)
    n = l2_normalize(img)
    np.testing.assert_allclose(n.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    m = global_pool_mask(2, 6, 2)
    assert m.tolist() == [[1, 1, -99, 1, 1, 1], [1, 1, 1, -99, 1, 1]]


def test_full_forward_and_shared_audio_match(both):
    state, model = both
    img, spec = _inputs(4, batch=4)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want = state.apply_fn(variables, jnp.asarray(img), jnp.asarray(spec), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(spec))
    # the PARITY bar of the JAX package for heatmaps across frameworks
    np.testing.assert_allclose(got.heatmap.numpy(), np.asarray(want.heatmap), atol=2e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=2e-2, rtol=1e-4)

    # two clips, two frames each: the audio is encoded once per clip
    want_s = state.apply_fn(
        variables, jnp.asarray(img), jnp.asarray(spec[:2]), train=False,
        method=lambda m, f, a, train: m.forward_shared_audio(f, a, train=train))
    with torch.no_grad():
        got_s = model.forward_shared_audio(torch.from_numpy(img),
                                           torch.from_numpy(spec[:2]))
        head_only = model.head(model.encode_image(torch.from_numpy(img)),
                               model.encode_audio(torch.from_numpy(spec[:2]))
                               .repeat_interleave(2, dim=0))
    np.testing.assert_allclose(got_s.heatmap.numpy(), np.asarray(want_s.heatmap),
                               atol=2e-4)
    np.testing.assert_array_equal(got_s.heatmap.numpy(), head_only.heatmap.numpy())


def test_resnet_init_stems_and_errors():
    gen = torch.Generator().manual_seed(0)
    net = ResNet2D(modal="flow", generator=gen)
    assert net.conv1_flow.weight.shape == (64, 6, 7, 7)
    assert not hasattr(net, "conv1")
    # He fan-out: std = sqrt(2 / (out * k * k))
    w = net.layer3[0].conv1.weight.detach()
    assert abs(float(w.std()) - (2.0 / (256 * 9)) ** 0.5) < 2e-3
    bn = net.layer4[1].bn2.requires_grad_(False)
    assert 0.005 < float(bn.weight.std()) < 0.04 and abs(float(bn.weight.mean()) - 1) < 0.01
    assert bn.eps == 1e-5 and bn.momentum == 0.1 and float(bn.bias.abs().max()) == 0
    plain = ResNet2D(modal="audio", bn_scale_noise=False, generator=gen)
    assert float(plain.bn1.weight.detach().std()) == 0.0
    # same seed, same weights
    a = AVENet(generator=torch.Generator().manual_seed(7))
    b = AVENet(generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    with pytest.raises(ValueError, match="input channels"):
        net(torch.zeros(1, 32, 32, 3))
    with pytest.raises(ValueError, match="modal"):
        ResNet2D(modal="depth")
    out = net.eval()(torch.zeros(1, 32, 48, 6))
    assert out.shape == (1, 2, 3, 512)
