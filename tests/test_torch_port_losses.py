"""The port's losses against the JAX package's, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.losses import losses as jl
from avtubes_torch.losses import losses as tl

torch.set_num_threads(2)
ATOL = 1e-6


def _close(got: torch.Tensor, want) -> None:
    want = float(want)
    assert abs(float(got) - want) <= ATOL * max(1.0, abs(want)), (float(got), want)


@pytest.mark.parametrize("b,k", [(4, 6), (40, 42), (1, 3)])
@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_hardway_loss(b, k, scale):
    logits = (np.random.RandomState(b + k).randn(b, k) * scale).astype(np.float32)
    _close(tl.hardway_loss(torch.from_numpy(logits)), jl.hardway_loss(jnp.asarray(logits)))


def test_hardway_loss_is_float32_for_lower_precision_logits():
    logits = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    got = tl.hardway_loss(torch.from_numpy(logits).to(torch.bfloat16))
    assert got.dtype == torch.float32
    want = jl.hardway_loss(jnp.asarray(logits).astype(jnp.bfloat16))
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 2, 4, 4), (3, 16, 14, 14), (1, 5, 7, 9)])
@pytest.mark.parametrize("name", ["propagation_loss", "np_ratio_loss"])
def test_temporal_losses(shape, name):
    maps = np.random.RandomState(len(shape) + shape[1]).randn(*shape).astype(np.float32)
    _close(getattr(tl, name)(torch.from_numpy(maps)), getattr(jl, name)(jnp.asarray(maps)))


@pytest.mark.parametrize("shape", [(4, 14, 14), (2, 3, 7, 9)])
def test_flip_and_consistency_losses(shape):
    rng = np.random.RandomState(shape[-1])
    a, b = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _close(tl.flip_loss(ta, tb), jl.flip_loss(ja, jb))
    _close(tl.consistency_l2(ta, tb), jl.consistency_l2(ja, jb))
    # a map against its own mirror image costs nothing
    assert float(tl.flip_loss(ta, torch.flip(ta, dims=(-1,)))) == 0.0


def test_loss_gradients_match():
    import jax

    rng = np.random.RandomState(3)
    maps = rng.randn(2, 3, 5, 5).astype(np.float32)
    other = rng.randn(2, 3, 5, 5).astype(np.float32)

    def jloss(m):
        return (jl.propagation_loss(m) + jl.consistency_l2(m, jnp.asarray(other))
                + jl.hardway_loss(m.reshape(6, 25)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(maps)))
    t = torch.from_numpy(maps).requires_grad_()
    (tl.propagation_loss(t) + tl.consistency_l2(t, torch.from_numpy(other))
     + tl.hardway_loss(t.reshape(6, 25))).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=ATOL)
