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


# ---- the tiled algorithm (2-D tiles with halo, channel chunks in order, the
# ---- mirrored coefficient patch, both gradients from one call) on tensors

TILED_CASES = {
    # name: (shape, max_disp, stride, tile, chunk)
    "window_2_1": ((2, 8, 9, 16), 2, 1, (3, 4), 8),
    "window_4_2": ((2, 8, 9, 16), 4, 2, (3, 4), 8),
    "window_4_3": ((2, 8, 9, 16), 4, 3, (4, 8), 16),
    "window_1_1": ((2, 8, 9, 16), 1, 1, (2, 4), 4),
    "ragged_tile_edge": ((1, 7, 10, 8), 2, 1, (4, 8), 8),
    "channels_not_a_multiple_of_the_chunk": ((2, 6, 8, 20), 2, 1, (3, 4), 16),
    "window_larger_than_the_map": ((2, 5, 6, 8), 7, 1, (2, 4), 32),
    "the_plans_own_tile": ((3, 9, 12, 40), 2, 1, None, k3.TILE_CK),
}


@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_tiled_forward_matches_plain_and_xla(case):
    shape, max_disp, stride, tile, chunk = TILED_CASES[case]
    f1, f2 = _maps(10, shape)
    got = k3.correlation_tiled_plain(torch.from_numpy(f1), torch.from_numpy(f2),
                                     max_disp, stride, tile, chunk).numpy()
    plain = k3.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2),
                                 max_disp, stride).numpy()
    xla = np.asarray(correlation_xla(jnp.asarray(f1), jnp.asarray(f2), max_disp, stride))
    assert got.shape == plain.shape == xla.shape
    np.testing.assert_allclose(got, plain, atol=ATOL)
    np.testing.assert_allclose(got, xla, atol=ATOL)


@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_tiled_backward_both_matches_autograd_and_xla_vjp(case):
    shape, max_disp, stride, tile, chunk = TILED_CASES[case]
    f1, f2 = _maps(11, shape)
    d = (2 * (max_disp // stride) + 1) ** 2
    cot = np.random.RandomState(12).randn(*shape[:3], d).astype(np.float32)
    t1 = torch.from_numpy(f1).requires_grad_()
    t2 = torch.from_numpy(f2).requires_grad_()
    want1, want2 = torch.autograd.grad(
        k3.correlation_plain(t1, t2, max_disp, stride), (t1, t2), torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda a, b: correlation_xla(a, b, max_disp, stride),
                     jnp.asarray(f1), jnp.asarray(f2))
    xla1, xla2 = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    got1, got2 = k3.correlation_backward_both_plain(
        torch.from_numpy(cot), t1.detach(), t2.detach(), max_disp, stride, tile, chunk)
    for got, want, xla in ((got1, want1, xla1), (got2, want2, xla2)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), xla, atol=ATOL)


def test_tiled_backward_computes_only_what_is_wanted():
    f1, f2 = (torch.from_numpy(a) for a in _maps(13, (1, 5, 8, 8)))
    cot = torch.from_numpy(np.random.RandomState(14).randn(1, 5, 8, 25).astype(np.float32))
    both = k3.correlation_backward_both_plain(cot, f1, f2, 2)
    only1 = k3.correlation_backward_both_plain(cot, f1, f2, 2, want=(True, False))
    only2 = k3.correlation_backward_both_plain(cot, f1, f2, 2, want=(False, True))
    assert only1[1] is None and only2[0] is None
    assert torch.equal(only1[0], both[0]) and torch.equal(only2[1], both[1])


# ---- the plan: which kernel, which tile, from the geometry alone

# every geometry the smoke script checks on the card:
# name: ((B, H, W, C), max_disp, stride, aligned, expected variant)
SMOKE_GEOMETRIES = {
    "pretrain_step": ((20, 28, 28, 96), 4, 1, True, "tiled"),
    "clip_pairs_300": ((300, 28, 28, 96), 4, 1, True, "tiled"),
    "small": ((2, 8, 8, 16), 2, 1, True, "tiled"),
    "ragged_stride2": ((3, 7, 9, 10), 4, 2, True, "rowseg_scalar"),
    "stride_not_dividing_max_disp": ((2, 9, 7, 12), 4, 3, True, "rowseg_vec4"),
    "window_larger_than_map": ((2, 5, 6, 8), 7, 1, True, "tiled"),
    "ragged_last_segment": ((2, 5, 30, 96), 4, 1, True, "tiled"),
    "ragged_last_segment_stride2": ((2, 5, 30, 96), 4, 2, True, "rowseg_vec4"),
    "ragged_tiles": ((24, 30, 30, 32), 4, 1, True, "tiled"),
    "window_5x5": ((40, 14, 14, 24), 2, 1, True, "tiled"),
    "one_column_tiles": ((1, 6, 6, 96), 8, 1, True, "tiled"),
    "max_disp_zero": ((2, 6, 5, 20), 0, 1, True, "tiled"),
    "window_exceeds_shared_memory": ((1, 6, 6, 64), 20, 1, True, "direct"),
    "all_zero_f2": ((2, 8, 8, 16), 2, 1, True, "tiled"),
    "unaligned_pointers": ((4, 10, 12, 32), 3, 1, False, "rowseg_scalar"),
}
PLAN_GRID = dict(SMOKE_GEOMETRIES)
PLAN_GRID.update({
    "channels_10_stride_1": ((3, 7, 9, 10), 2, 1, True, "rowseg_scalar"),
    "one_pixel": ((1, 1, 1, 4), 1, 1, True, "tiled"),
    "wide_map": ((1, 3, 300, 8), 4, 1, True, "tiled"),
    "tall_map": ((1, 300, 3, 8), 4, 1, True, "tiled"),
    "large_map_one_image": ((1, 112, 112, 64), 4, 1, True, "tiled"),
    "window_33x33": ((2, 40, 40, 32), 16, 1, True, "tiled"),
    "window_41x41_stride_2": ((1, 6, 6, 64), 40, 2, True, "direct"),
})
SM_COUNT = 132


KINDS = {"forward": (False, 1), "backward_both": (True, 2), "backward_one": (True, 1)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", sorted(PLAN_GRID))
def test_plan_fits_the_block_and_covers_the_map(name, kind):
    (b, h, w, c), max_disp, stride, aligned, variant = PLAN_GRID[name]
    backward, gradients = KINDS[kind]
    plan = k3.correlation_plan(b, h, w, c, max_disp, stride, aligned, backward, gradients)
    assert set(plan) == set(k3.PLAN_FIELDS)
    assert plan["variant"] == variant
    assert k3.correlation_variant(b, h, w, c, max_disp, stride, aligned, backward,
                                  gradients) == variant
    assert plan["smem"] <= 232448 - 1024
    assert 32 <= plan["threads"] <= 320 and plan["threads"] % 32 == 0
    assert plan["stages"] in (1, 2)
    assert 1 <= plan["blocks"] < 2 ** 31
    if variant == "direct":
        return
    # the tiles cover every pixel of the map exactly once
    th, tw = plan["th"], plan["tw"]
    covered = np.zeros((h, w), np.int32)
    for i0 in range(0, h, th):
        for j0 in range(0, w, tw):
            covered[i0:i0 + th, j0:j0 + tw] += 1
    assert (covered == 1).all()
    if variant == "tiled":
        assert tw % k3.TILE_JT == 0 and plan["ck"] == k3.TILE_CK
        assert plan["blocks"] == b * -(-h // th) * -(-w // tw)
        n = 2 * max_disp + 1
        work = th * (tw // 4) * (k3.TILE_CK // 4 if backward else n * -(-n // k3.TILE_NX))
        assert work <= plan["threads"] < work + 32      # a thread per item
        if not backward and plan["stages"] == 1:
            assert plan["threads"] <= k3.DENSE_THREADS  # two such blocks fit an SM
    else:
        assert th == 1 and plan["blocks"] == b * h * -(-w // tw)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plan_fills_the_card_at_the_pretrain_and_clip_shapes(kind):
    backward, gradients = KINDS[kind]
    launched = {}
    for name in ("pretrain_step", "clip_pairs_300"):
        (b, h, w, c), max_disp, stride, aligned, _ = SMOKE_GEOMETRIES[name]
        plan = k3.correlation_plan(b, h, w, c, max_disp, stride, aligned, backward, gradients)
        launched[name] = plan["blocks"] * (gradients if backward else 1)
        # the halo is shared along rows too: far under the 19 re-reads of a
        # row segment of 7 columns
        reread = (plan["th"] + 8) * (plan["tw"] + 8) / (plan["th"] * plan["tw"])
        assert reread < 4.0
        if launched[name] <= SM_COUNT:
            assert plan["stages"] == 2      # alone on its SM: the ring overlaps
        else:
            assert plan["stages"] == 1      # blocks side by side overlap each other
            assert 2 * (plan["smem"] + 1024) <= k3.SM_SMEM
    # the pretrainer's 20 images: one wave that leaves few SMs idle, or two
    # blocks an SM at once; the clips' 300: many waves
    assert 0.9 * SM_COUNT <= launched["pretrain_step"] <= 2 * SM_COUNT
    assert launched["clip_pairs_300"] >= 10 * SM_COUNT


def test_plan_depends_on_alignment_and_channel_count_only_through_the_variant():
    tiled = k3.correlation_plan(4, 10, 12, 32, 3, 1, True)
    scalar = k3.correlation_plan(4, 10, 12, 32, 3, 1, False)
    assert (tiled["variant"], scalar["variant"]) == ("tiled", "rowseg_scalar")
    assert k3.correlation_variant(4, 10, 12, 30, 3, 1, True) == "rowseg_scalar"   # C % 4 != 0
    assert k3.correlation_variant(4, 10, 12, 32, 3, 2, True) == "rowseg_vec4"     # stride 2
    with pytest.raises(ValueError, match="stride"):
        k3.correlation_plan(4, 10, 12, 32, 3, 0, True)
    with pytest.raises(ValueError, match="empty"):
        k3.correlation_plan(0, 10, 12, 32, 3, 1, True)
    with pytest.raises(ValueError, match="gradients"):
        k3.correlation_plan(4, 10, 12, 32, 3, 1, True, True, 3)


def test_fused_backward_wrapper_refuses_cpu_tensors_and_counts_nothing():
    f1, f2 = (torch.from_numpy(a) for a in _maps(15))
    before = (k3.correlation_forward_cuda.launches, k3.correlation_backward_cuda.launches,
              k3.correlation_backward_cuda.gradients)
    with pytest.raises(ValueError, match="CUDA"):
        k3.correlation_backward_both_cuda(torch.zeros(2, 8, 9, 25), f1, f2, 2, 1)
    with pytest.raises(ValueError, match="wrt"):
        k3.correlation_backward_cuda(torch.zeros(2, 8, 9, 25), f1, "f3", 2, 1)
    # autograd on the CPU path goes through the plain version, not the kernels
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    k3.correlation_cost_volume(a, b, 2, 1).sum().backward()
    assert a.grad is not None and b.grad is not None
    assert before == (k3.correlation_forward_cuda.launches,
                      k3.correlation_backward_cuda.launches,
                      k3.correlation_backward_cuda.gradients)
