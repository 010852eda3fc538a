"""`flow_warp` and `grid_sample` of the port against the JAX package: values
and gradients, with flows and grids that leave the image."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avtubes.ops.warp import flow_warp as jax_flow_warp
from avtubes.ops.warp import grid_sample as jax_grid_sample
from avtubes_torch.ops.warp import flow_warp, grid_sample

ATOL = 1e-5   # the same four gathers and weights, float32


def _flow_case(seed, shape=(2, 9, 11, 3)):
    rng = np.random.RandomState(seed)
    img = rng.randn(*shape).astype(np.float32)
    # up to ~6 px: many samples land outside a 9x11 image, on every side
    flow = (rng.randn(*shape[:3], 2) * 3.0).astype(np.float32)
    # exact integers too, among them 0 at the first row and column and the
    # last ones: where a clipped *coordinate* and a clipped *index* differ
    flow[0, :, :2] = 0.0
    flow[0, :, -2:] = 0.0
    flow[1, :2] = np.round(flow[1, :2])
    cot = rng.randn(*shape).astype(np.float32)
    return img, flow, cot


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_flow_warp_value_and_gradients(padding_mode):
    img, flow, cot = _flow_case(0)
    want, vjp = jax.vjp(lambda i, f: jax_flow_warp(i, f, padding_mode=padding_mode),
                        jnp.asarray(img), jnp.asarray(flow))
    want_gi, want_gf = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    ti = torch.from_numpy(img).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    got = flow_warp(ti, tf, padding_mode=padding_mode)
    got_gi, got_gf = torch.autograd.grad(got, (ti, tf), torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_gi.numpy(), want_gi, atol=ATOL)
    np.testing.assert_allclose(got_gf.numpy(), want_gf, atol=1e-4)   # sums of C products of O(1) values
    assert np.abs(want_gf).max() > 0.1


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_value_and_gradients(padding_mode, align_corners):
    rng = np.random.RandomState(1)
    img = rng.randn(2, 9, 11, 3).astype(np.float32)
    grid = np.clip(rng.randn(2, 5, 7, 2) * 0.8, -1.6, 1.6).astype(np.float32)
    cot = rng.randn(2, 5, 7, 3).astype(np.float32)
    want, vjp = jax.vjp(
        lambda i, g: jax_grid_sample(i, g, align_corners=align_corners,
                                     padding_mode=padding_mode),
        jnp.asarray(img), jnp.asarray(grid))
    want_gi, want_gg = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    ti = torch.from_numpy(img).requires_grad_()
    tg = torch.from_numpy(grid).requires_grad_()
    got = grid_sample(ti, tg, align_corners=align_corners, padding_mode=padding_mode)
    got_gi, got_gg = torch.autograd.grad(got, (ti, tg), torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_gi.numpy(), want_gi, atol=ATOL)
    np.testing.assert_allclose(got_gg.numpy(), want_gg, atol=1e-4)
    # and it is the library's function, in channels-last layout
    lib = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), lib.numpy(), atol=ATOL)


def test_why_flow_warp_is_not_the_library_call():
    """`F.grid_sample(padding_mode="border")` clips the coordinate, so its
    gradient with respect to a flow of exactly 0 at the first column is 0;
    the JAX package clips the index and keeps img[1] - img[0].  And the round
    trip through normalized coordinates at W = 224 moves coordinates."""
    rng = np.random.RandomState(2)
    img = rng.randn(1, 4, 224, 1).astype(np.float32)
    flow = np.zeros((1, 4, 224, 2), np.float32)
    want = np.asarray(jax.grad(lambda f: jax_flow_warp(jnp.asarray(img), f).sum())(
        jnp.asarray(flow)))
    tf = torch.from_numpy(flow).requires_grad_()
    flow_warp(torch.from_numpy(img), tf).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(want[0, :, 0, 0], img[0, :, 1, 0] - img[0, :, 0, 0], atol=ATOL)

    lf = torch.from_numpy(flow).requires_grad_()
    xs = torch.arange(224, dtype=torch.float32)[None, None, :] + lf[..., 0]
    ys = torch.arange(4, dtype=torch.float32)[None, :, None] + lf[..., 1]
    grid = torch.stack([2 * xs / 223 - 1, 2 * ys / 3 - 1], dim=-1)
    F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), grid, mode="bilinear",
                  padding_mode="border", align_corners=True).sum().backward()
    lib = lf.grad.numpy()
    assert np.all(lib[0, :, 0, 0] == 0.0)              # the border column: no gradient
    assert np.abs(lib - want).max() > 0.1              # and interior cells flip too
