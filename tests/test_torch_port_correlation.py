"""K3's plain version and autograd wiring against the JAX package's
correlation cost volume: value, gradient, channel order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.ops.correlation import correlation_pallas, correlation_xla
from avtubes_torch.ops import correlation as k3

ATOL = 1e-5   # fp32 sums in another order, unit-scale inputs (the bar of tests/test_ops.py)
WINDOWS = [(2, 1), (4, 2), (4, 3), (1, 1)]   # (max_disp, stride)


def _maps(seed, shape=(2, 8, 9, 16)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("max_disp,stride", WINDOWS)
def test_value_matches_xla(max_disp, stride):
    f1, f2 = _maps(0)
    want = np.asarray(correlation_xla(jnp.asarray(f1), jnp.asarray(f2), max_disp, stride))
    got = k3.correlation_cost_volume(torch.from_numpy(f1), torch.from_numpy(f2),
                                     max_disp, stride).numpy()
    assert got.shape == want.shape == (2, 8, 9, (2 * (max_disp // stride) + 1) ** 2)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("max_disp,stride", WINDOWS)
def test_gradients_match_xla_vjp(max_disp, stride):
    f1, f2 = _maps(1)
    d = (2 * (max_disp // stride) + 1) ** 2
    cot = np.random.RandomState(2).randn(2, 8, 9, d).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: correlation_xla(a, b, max_disp, stride),
                     jnp.asarray(f1), jnp.asarray(f2))
    want1, want2 = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    t1 = torch.from_numpy(f1).requires_grad_()
    t2 = torch.from_numpy(f2).requires_grad_()
    out = k3.correlation_cost_volume(t1, t2, max_disp, stride)
    got1, got2 = torch.autograd.grad(out, (t1, t2), torch.from_numpy(cot))
    np.testing.assert_allclose(got1.numpy(), want1, atol=ATOL)
    np.testing.assert_allclose(got2.numpy(), want2, atol=ATOL)


@pytest.mark.parametrize("max_disp,stride", WINDOWS)
def test_value_matches_pallas_kernel_in_interpret_mode(max_disp, stride):
    from jax.experimental.pallas import tpu as pltpu

    f1, f2 = _maps(3, (2, 8, 8, 16))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(correlation_pallas(jnp.asarray(f1), jnp.asarray(f2),
                                             max_disp, stride))
    got = k3.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2),
                               max_disp, stride).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gradcheck_float64():
    rng = np.random.RandomState(4)
    f1 = torch.from_numpy(rng.randn(1, 4, 5, 3)).requires_grad_()
    f2 = torch.from_numpy(rng.randn(1, 4, 5, 3)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: k3.correlation_plain(a, b, 2, 1), (f1, f2))
    assert torch.autograd.gradcheck(
        lambda a, b: k3.correlation_plain(a, b, 3, 2), (f1, f2))


def test_channel_order_dy_outer_and_identity_peak():
    """k = iy * n + ix with dy outer: a map against itself shifted by
    (dy, dx) = (1, -2) peaks at channel (1 + r) * n + (-2 + r)."""
    r, n = 2, 5
    f = np.random.RandomState(5).randn(1, 10, 10, 32).astype(np.float32)
    out = k3.correlation_cost_volume(torch.from_numpy(f), torch.from_numpy(f), r, 1)
    assert (out[0, r:-r, r:-r].argmax(-1) == r * n + r).all()
    moved = np.roll(f, (1, -2), axis=(1, 2))   # moved[i + 1, j - 2] = f[i, j]
    out = k3.correlation_cost_volume(torch.from_numpy(f), torch.from_numpy(moved), r, 1)
    assert (out[0, 3:-3, 3:-3].argmax(-1) == (1 + r) * n + (-2 + r)).all()
    assert k3.displacements(4, 3) == [-3, 0, 3]   # zero is always there


def test_gather_form_backward_equals_autograd():
    """The sums the backward kernel computes, written out on tensors: the
    gradient of f2 is the gradient-of-f1 sum with f1 as the source and
    neighbour k's coefficient taken from that neighbour's cotangent at
    channel D-1-k.  Held against autograd of the plain version."""
    max_disp, stride = 4, 2
    f1n, f2n = _maps(6, (2, 6, 7, 5))
    disps = k3.displacements(max_disp, stride)
    n, reach = len(disps), disps[-1]
    d = n * n
    f1 = torch.from_numpy(f1n).requires_grad_()
    f2 = torch.from_numpy(f2n).requires_grad_()
    cot = torch.from_numpy(np.random.RandomState(7).randn(2, 6, 7, d).astype(np.float32))
    want1, want2 = torch.autograd.grad(
        k3.correlation_plain(f1, f2, max_disp, stride), (f1, f2), cot)

    def gather(src, coefficient_of):
        pad = (0, 0, reach, reach, reach, reach)
        srcp = torch.nn.functional.pad(src.detach(), pad)
        cotp = torch.nn.functional.pad(cot, pad)
        out = torch.zeros_like(src)
        for iy, dy in enumerate(disps):
            for ix, dx in enumerate(disps):
                window = (slice(None), slice(reach + dy, reach + dy + 6),
                          slice(reach + dx, reach + dx + 7))
                out += coefficient_of(cotp, window, iy * n + ix)[..., None] * srcp[window]
        return out / src.shape[-1]

    got1 = gather(f2, lambda cotp, window, k: cot[..., k])
    got2 = gather(f1, lambda cotp, window, k: cotp[window][..., d - 1 - k])
    np.testing.assert_allclose(got1.numpy(), want1.numpy(), atol=ATOL)
    np.testing.assert_allclose(got2.numpy(), want2.numpy(), atol=ATOL)


def test_cpu_tensor_takes_the_plain_version_and_wrappers_refuse_it():
    f1, f2 = (torch.from_numpy(a) for a in _maps(8))
    before = (k3.correlation_forward_cuda.launches, k3.correlation_backward_cuda.launches)
    assert torch.equal(k3.correlation_cost_volume(f1, f2, 2, 1, impl="kernel"),
                       k3.correlation_plain(f1, f2, 2, 1))
    assert torch.equal(k3.correlation_cost_volume(f1, f2, 2, 1, impl="plain"),
                       k3.correlation_plain(f1, f2, 2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        k3.correlation_forward_cuda(f1, f2, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        k3.correlation_backward_cuda(torch.zeros(2, 8, 9, 25), f1, "f1", 2, 1)
    with pytest.raises(ValueError, match="impl"):
        k3.correlation_cost_volume(f1, f2, 2, 1, impl="auto")
    with pytest.raises(ValueError, match="stride"):
        k3.correlation_cost_volume(f1, f2, 2, 0)
    assert before == (k3.correlation_forward_cuda.launches,
                      k3.correlation_backward_cuda.launches)
