"""Port of the exact median mask (K2 module) against the JAX package.

The plain bit-space bisection of `avtubes_torch.ops.median_select` must be
bit-equal to the JAX package's sort oracle, its XLA bisection and its Pallas
kernel (interpret mode), ties and all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from avtubes.ops import median_select as jmed
from avtubes_torch.ops import median_select as tmed

SIDE = 224
N = SIDE * SIDE


def _tie_cases():
    rng = np.random.default_rng(0)
    generic = rng.random((4, N), dtype=np.float32)
    ties = rng.random((2, N), dtype=np.float32)
    ties[:, : N // 2] = 0.25                                   # heavy ties at k
    all_equal = np.zeros((1, N), dtype=np.float32)
    few = (np.round(rng.random((3, N)) * 8) / 8).astype(np.float32)
    return {"generic": generic, "heavy_ties": ties, "all_equal": all_equal,
            "few_distinct": few}


CASES = _tie_cases()


@pytest.mark.parametrize("case", list(CASES))
def test_kth_value_matches_sort_and_jax_bisect(case):
    x = CASES[case]
    k = N // 2
    want = np.sort(x, axis=1)[:, k]
    got = tmed.kth_value_bits(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jmed.kth_value_bits_xla(jnp.asarray(x), k)))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("jax_impl", ["sort", "bisect"])
def test_median_mask_matches_jax(case, jax_impl):
    pred = CASES[case].reshape(-1, SIDE, SIDE)
    k = N // 2
    want = np.asarray(jmed.median_mask(jnp.asarray(pred), k, impl=jax_impl))
    t = torch.from_numpy(pred)
    for impl in ("kernel", "plain", "sort"):  # 'kernel' on a CPU tensor = plain
        np.testing.assert_array_equal(tmed.median_mask(t, k, impl=impl).numpy(), want)


@pytest.mark.parametrize("case", ["generic", "heavy_ties"])
def test_median_mask_matches_pallas_interpret(case):
    pred = CASES[case].reshape(-1, SIDE, SIDE)
    k = N // 2
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmed.median_mask_pallas(jnp.asarray(pred), k))
    got = tmed.median_mask_plain(torch.from_numpy(pred), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_exact_above_one_and_any_k():
    """The search covers ALL finite non-negative f32: values beyond 1.0
    (un-normalized maps) give the exact k-th value, not a clamp at 1.0."""
    x = np.linspace(0.0, 2.0, 100, dtype=np.float32)[None]
    for k in (0, 50, 80, 99):
        got = float(tmed.kth_value_bits(torch.from_numpy(x), k)[0])
        assert got == float(np.sort(x[0])[k]), (k, got)
        assert got == float(jmed.kth_value_bits_xla(jnp.asarray(x), k)[0])
    big = np.asarray([[3e38, 1e30, 7.5, 0.0]], np.float32)
    assert float(tmed.kth_value_bits(torch.from_numpy(big), 3)[0]) == np.float32(3e38)


def test_odd_map_size():
    rng = np.random.default_rng(1)
    pred = rng.random((3, 37, 53), dtype=np.float32)
    k = 37 * 53 // 2
    t = torch.from_numpy(pred)
    assert torch.equal(tmed.median_mask(t, k), tmed.median_mask(t, k, impl="sort"))
    np.testing.assert_array_equal(
        tmed.median_mask(t, k).numpy(),
        np.asarray(jmed.median_mask(jnp.asarray(pred), k, impl="sort")))


def test_cuda_wrapper_refuses_cpu_tensor_and_bad_impl():
    pred = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmed.median_mask_cuda(pred, 8)
    with pytest.raises(ValueError, match="impl"):
        tmed.median_mask(pred, 8, impl="auto")
    assert tmed.median_mask_cuda.launches == 0


# ---------------------------------------------------------------------------
# The CUDA kernel's algorithm on tensors (`kth_value_radix`: three digit
# passes of 11 + 10 + 10 bits) against every other way to the same value.

def _radix_cases():
    rng = np.random.default_rng(2)
    n = 4096
    plateau = rng.random((3, n), dtype=np.float32)
    plateau[:, : n // 2] = 0.25
    denormal = rng.integers(0, 3000, (3, n)).astype(np.int32)
    denormal[:, ::3] = 0                       # exact zeros among denormals
    return {
        "random": rng.random((3, n), dtype=np.float32),
        "constant": np.full((2, n), 0.375, dtype=np.float32),
        "plateau": plateau,
        "above_one": (rng.random((3, n)) * 3e38).astype(np.float32),
        "denormal": denormal.view(np.float32),
    }


RADIX_CASES = _radix_cases()
RADIX_N = 4096
RADIX_KS = {"first": 0, "median": RADIX_N // 2, "last": RADIX_N - 1}


def test_radix_digits_cover_the_31_value_bits_once():
    covered = 0
    for shift, nbits in tmed.RADIX_DIGITS:
        mask = ((1 << nbits) - 1) << shift
        assert covered & mask == 0
        covered |= mask
    assert covered == 0x7FFFFFFF
    shifts = [s for s, _ in tmed.RADIX_DIGITS]
    assert shifts == sorted(shifts, reverse=True)      # most significant first


@pytest.mark.parametrize("k", list(RADIX_KS))
@pytest.mark.parametrize("case", list(RADIX_CASES))
@pytest.mark.parametrize("other", ["sort", "bisect", "jax_bisect"])
def test_kth_value_radix_is_bit_equal(case, k, other):
    x = RADIX_CASES[case]
    kk = RADIX_KS[k]
    got = tmed.kth_value_radix(torch.from_numpy(x), kk)
    if other == "sort":
        want = torch.sort(torch.from_numpy(x), dim=1).values[:, kk]
    elif other == "bisect":
        want = tmed.kth_value_bits(torch.from_numpy(x), kk)
    else:
        want = torch.from_numpy(np.array(jmed.kth_value_bits_xla(jnp.asarray(x), kk)))
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case,k", [*((c, "median") for c in RADIX_CASES),
                                    ("random", "first"), ("random", "last"),
                                    ("plateau", "first"), ("denormal", "last")])
def test_radix_mask_matches_pallas_interpret(case, k):
    pred = RADIX_CASES[case].reshape(-1, 64, 64)
    kk = RADIX_KS[k]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmed.median_mask_pallas(jnp.asarray(pred), kk))
    t = torch.from_numpy(pred)
    thr = tmed.kth_value_radix(t.reshape(t.shape[0], -1), kk)
    got = (t > thr[:, None, None]).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tmed.median_mask_plain(t, kk).numpy())


@settings(max_examples=60, deadline=None, database=None)
@given(n=st.integers(1, 700), distinct=st.integers(1, 40), seed=st.integers(0, 2 ** 16),
       scale=st.sampled_from([1e-42, 1e-3, 1.0, 3e36]), data=st.data())
def test_kth_value_radix_any_n_k_and_ties(n, distinct, seed, scale, data):
    k = data.draw(st.integers(0, n - 1))
    rng = np.random.default_rng(seed)
    values = (rng.random(distinct) * scale).astype(np.float32)
    x = values[rng.integers(0, distinct, (2, n))]
    got = tmed.kth_value_radix(torch.from_numpy(x), k).numpy()
    want = np.sort(x, axis=1)[:, k]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        tmed.kth_value_bits(torch.from_numpy(x), k).numpy().view(np.int32),
        want.view(np.int32))
