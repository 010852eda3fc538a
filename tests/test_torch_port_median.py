"""Port of the exact median mask (K2 module) against the JAX package.

The plain bit-space bisection of `avtubes_torch.ops.median_select` must be
bit-equal to the JAX package's sort oracle, its XLA bisection and its Pallas
kernel (interpret mode), ties and all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
