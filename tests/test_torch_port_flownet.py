"""FlowNetLite of the port against the JAX package with the same weights
(through `flownet_from_flax`): flow and parameter gradients, at a square size
and at a non-square size that no stride divides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.models.flownet import FlowNetLite as JaxFlowNetLite
from avtubes_torch.core.convert import flownet_from_flax
from avtubes_torch.models.flownet import FlowNetLite, same_padding

torch.set_num_threads(2)


def _jax_params(seed, size=(64, 64)):
    zeros = jnp.zeros((1, *size, 3))
    params = jax.device_get(JaxFlowNetLite().init(jax.random.PRNGKey(seed), zeros, zeros)["params"])
    # the flow head starts at zero and the biases too: give them values, so
    # that a swapped axis or a dropped bias shows
    rng = np.random.RandomState(seed + 50)

    def bump(path, a):
        a = np.asarray(a)
        if path[-1].key == "bias" or path[0].key == "flow_head":
            return (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(bump, params)


def _port(params) -> FlowNetLite:
    model = FlowNetLite(generator=torch.Generator().manual_seed(3))
    model.load_state_dict(flownet_from_flax(params), strict=True)
    return model


def _pair(seed, h, w, batch=2):
    rng = np.random.RandomState(seed)
    im1 = rng.rand(batch, h, w, 3).astype(np.float32)
    im2 = np.roll(im1, (3, -2), axis=(1, 2)) + 0.02 * rng.randn(batch, h, w, 3).astype(np.float32)
    return im1, im2.astype(np.float32)


@pytest.mark.parametrize("h,w", [(64, 64), (52, 76), (37, 45)])
def test_flow_matches_jax(h, w):
    params = _jax_params(0)
    im1, im2 = _pair(1, h, w)
    want = np.asarray(JaxFlowNetLite().apply({"params": params}, jnp.asarray(im1),
                                             jnp.asarray(im2)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(im1), torch.from_numpy(im2)).numpy()
    assert got.shape == want.shape == (2, h, w, 2)
    assert np.abs(want).max() > 1.0          # a real flow, in pixels
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("h,w", [(64, 64), (52, 76)])
def test_parameter_gradients_match_jax(h, w):
    params = _jax_params(2)
    im1, im2 = _pair(3, h, w)
    weight = np.random.RandomState(4).randn(2, h, w, 2).astype(np.float32)

    def loss(p):
        flow = JaxFlowNetLite().apply({"params": p}, jnp.asarray(im1), jnp.asarray(im2))
        return (flow * weight).mean() + 0.1 * (flow * flow).mean()

    want = flownet_from_flax(jax.device_get(jax.grad(loss)(params)))
    model = _port(params)
    flow = model(torch.from_numpy(im1), torch.from_numpy(im2))
    ((flow * torch.from_numpy(weight)).mean() + 0.1 * (flow * flow).mean()).backward()
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        # rtol 1e-3 of each tensor's largest entry: float32 sums in another order
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=name)


def test_same_padding_is_flax_same():
    # stride 2: even sizes pad (1,2) / (0,1); odd sizes are symmetric
    assert same_padding(224, 5, 2) == (1, 2)
    assert same_padding(224, 3, 2) == (0, 1)
    assert same_padding(37, 5, 2) == (2, 2)
    assert same_padding(37, 3, 2) == (1, 1)
    assert same_padding(28, 3, 1) == (1, 1)
    x = np.random.RandomState(5).randn(1, 9, 10, 2).astype(np.float32)
    k = np.random.RandomState(6).randn(5, 5, 2, 3).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    top, bottom = same_padding(9, 5, 2)
    left, right = same_padding(10, 5, 2)
    xt = torch.nn.functional.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 (left, right, top, bottom))
    got = torch.nn.functional.conv2d(xt, torch.from_numpy(k).permute(3, 2, 0, 1), stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_init_and_state_dict():
    a = FlowNetLite(generator=torch.Generator().manual_seed(7))
    b = FlowNetLite(generator=torch.Generator().manual_seed(7))
    c = FlowNetLite(generator=torch.Generator().manual_seed(8))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.dec1.weight, c.dec1.weight)
    assert float(a.flow_head.weight.detach().abs().max()) == 0.0
    assert float(a.corr_temp.detach()) == 10.0
    assert all(float(m.bias.abs().max()) == 0.0 for m in a.modules()
               if isinstance(m, torch.nn.Conv2d))
    # He fan-out: std = sqrt(2 / (out * k * k))
    assert abs(float(a.dec1.weight.std()) - (2.0 / (128 * 9)) ** 0.5) < 2e-3
    params = _jax_params(0)
    assert set(flownet_from_flax(params)) == set(a.state_dict())
    assert tuple(a.state_dict()["corr_temp"].shape) == (1,)
    with pytest.raises(ValueError, match="unknown"):
        flownet_from_flax({"encoder": {"conv1": {"scale": np.zeros(3)}}})
    with pytest.raises(ValueError, match="frames"):
        a(torch.zeros(1, 3, 16, 16), torch.zeros(1, 3, 16, 16))
