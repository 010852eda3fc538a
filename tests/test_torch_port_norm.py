"""The port's global BatchNorm (`avtubes_torch/models/norm.py`) in two gloo
ranks against the JAX package's `TorchBatchNorm` on the global batch (what
XLA computes under `jit` with the batch sharded): the output, the running
mean and variance (the latter with the GLOBAL n/(n-1)), and the gradients of
the input, weight and bias.  Float32 to 1e-5; bfloat16 at the stem's size of
a 112x112 frame and of a 16 kHz x 2 s spectrogram (`ROADMAP.md` host facts),
its float32 statistics to 1e-5 and its bfloat16 values to bf16's bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.models.norm import TorchBatchNorm
from avtubes_torch.models.norm import BatchNorm2d
from torch_port_ranks import run_ranks

torch.set_num_threads(2)
# (global N, C, H, W), dtype and the spread of the channel means; two ranks
# take N/2 each.  Conv outputs have channel means of the order of half a
# standard deviation: both packages' statistics are float32, in their own
# summation orders.  "far_from_zero" puts every mean 50 deviations out
CASES = {
    "float32": ((8, 16, 6, 5), torch.float32, 0.5),
    "bf16_frame_112": ((4, 64, 56, 56), torch.bfloat16, 0.5),    # stem of a 112x112 frame
    "bf16_spec_16k_2s": ((4, 64, 129, 31), torch.bfloat16, 0.5),  # stem of a 257x62 spectrogram
    "far_from_zero": ((8, 16, 6, 5), torch.float32, None),
}
FAR_MEAN = 50.0


def _case(shape, dtype, seed, mean_spread=0.5):
    """Inputs, BatchNorm state and a cotangent; `mean_spread` None puts
    every channel mean FAR_MEAN deviations from 0."""
    rng = np.random.RandomState(seed)
    c = shape[1]
    means = rng.randn(1, c, 1, 1)
    offset = FAR_MEAN * np.sign(means) if mean_spread is None else means * mean_spread
    x = (rng.randn(*shape) + offset).astype(np.float32)
    state = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
             "bias": torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)),
             "running_mean": torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)),
             "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
             "num_batches_tracked": torch.tensor(3)}
    return {"x": torch.from_numpy(x).to(dtype), "state": state,
            "cot": torch.from_numpy(rng.randn(*shape).astype(np.float32))}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = {name: _case(shape, dtype, i, spread)
             for i, (name, (shape, dtype, spread)) in enumerate(CASES.items())}
    ranks = run_ranks("norm", {"cases": cases}, tmp_path_factory.mktemp("norm"))
    return cases, ranks


def _jax(case, dtype):
    """TorchBatchNorm on the global batch (NHWC): y, new statistics and the
    gradients of the cotangent's sum, as NCHW numpy arrays."""
    st = {k: jnp.asarray(v.numpy()) for k, v in case["state"].items()
          if k != "num_batches_tracked"}
    x = jnp.asarray(case["x"].to(torch.float32).numpy()).transpose(0, 2, 3, 1).astype(dtype)
    cot = jnp.asarray(case["cot"].numpy()).transpose(0, 2, 3, 1)
    bn = TorchBatchNorm(dtype=dtype)

    def f(x, scale, bias):
        y, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": {"mean": st["running_mean"], "var": st["running_var"]}},
                          x, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, mut["batch_stats"])

    (_, (y, stats)), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        x, st["weight"], st["bias"])
    to_nchw = lambda a: np.asarray(a.astype(jnp.float32)).transpose(0, 3, 1, 2)  # noqa: E731
    return (to_nchw(y), {k: np.asarray(v) for k, v in stats.items()},
            (to_nchw(grads[0]), np.asarray(grads[1]), np.asarray(grads[2])))


def _gathered(ranks, name, key):
    return torch.cat([r[name][key].to(torch.float32) for r in ranks]).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_float32_is_the_jax_batchnorm_on_the_global_batch(world2):
    cases, ranks = world2
    case = cases["float32"]
    y, stats, (gx, gscale, gbias) = _jax(case, jnp.float32)
    np.testing.assert_allclose(_gathered(ranks, "float32", "y"), y, atol=1e-5)
    np.testing.assert_allclose(_gathered(ranks, "float32", "x_grad"), gx, atol=1e-5)
    # each rank's weight and bias gradients are its part: their sum is the
    # global batch's (the step averages them over the ranks after backward)
    wsum = sum(r["float32"]["weight_grad"] for r in ranks).numpy()
    bsum = sum(r["float32"]["bias_grad"] for r in ranks).numpy()
    assert _rel(wsum, gscale) <= 1e-5 and _rel(bsum, gbias) <= 1e-5
    for r in ranks:
        st = r["float32"]["state"]
        assert _rel(st["running_mean"].numpy(), stats["mean"]) <= 1e-5
        assert _rel(st["running_var"].numpy(), stats["var"]) <= 1e-5
        assert int(st["num_batches_tracked"]) == 4


def test_the_running_variance_takes_the_global_n(world2):
    """n/(n-1) with n = N·H·W of the GLOBAL batch (float64 by hand), not a
    rank's; and both ranks hold the same statistics."""
    cases, ranks = world2
    case = cases["float32"]
    x = case["x"].double().numpy()
    n = x.shape[0] * x.shape[2] * x.shape[3]
    var = x.transpose(1, 0, 2, 3).reshape(x.shape[1], -1).var(axis=1) * n / (n - 1)
    mean = x.mean(axis=(0, 2, 3))
    want_var = 0.9 * case["state"]["running_var"].double().numpy() + 0.1 * var
    want_mean = 0.9 * case["state"]["running_mean"].double().numpy() + 0.1 * mean
    for r in ranks:
        st = r["float32"]["state"]
        np.testing.assert_allclose(st["running_var"].numpy(), want_var, rtol=1e-5)
        np.testing.assert_allclose(st["running_mean"].numpy(), want_mean, rtol=1e-5, atol=1e-6)
    for k in ("running_mean", "running_var"):
        assert torch.equal(ranks[0]["float32"]["state"][k], ranks[1]["float32"]["state"][k])


def test_without_a_group_it_is_nn_batchnorm2d():
    case = _case((4, 8, 5, 5), torch.float32, 7)
    ours, theirs = BatchNorm2d(8), torch.nn.BatchNorm2d(8)
    ours.load_state_dict(case["state"])
    theirs.load_state_dict(case["state"])
    x1 = case["x"].clone().requires_grad_()
    x2 = case["x"].clone().requires_grad_()
    y1, y2 = ours(x1), theirs(x2)
    (y1 * case["cot"]).sum().backward()
    (y2 * case["cot"]).sum().backward()
    assert torch.equal(y1, y2) and torch.equal(x1.grad, x2.grad)
    assert all(torch.equal(a, b) for a, b in zip(ours.state_dict().values(),
                                                 theirs.state_dict().values()))


@pytest.mark.parametrize("name", ["bf16_frame_112", "bf16_spec_16k_2s"])
def test_bfloat16_statistics_in_float32_values_in_bfloat16(world2, name):
    """The statistics are float32 sums of the bfloat16 input: the JAX
    package's to 1e-5.  The output normalizes in bfloat16 (one rounding of
    the float32 affine map, as `nn.BatchNorm2d` does; the JAX package
    rounds after each of its bfloat16 operations): within 3 bfloat16 ulps of
    the JAX package's, and of a single-process `nn.BatchNorm2d`'s."""
    cases, ranks = world2
    case = cases[name]
    assert ranks[0][name]["y"].dtype == torch.bfloat16
    y, stats, (gx, _, _) = _jax(case, jnp.bfloat16)
    got = _gathered(ranks, name, "y")
    ulp = 2.0 ** -7 * np.maximum(np.abs(y), 1.0)
    assert (np.abs(got - y) <= 3 * ulp).all(), float((np.abs(got - y) / ulp).max())
    plain = torch.nn.BatchNorm2d(case["x"].shape[1])
    plain.load_state_dict(case["state"])
    x = case["x"].clone().requires_grad_()
    out = plain(x)
    (out.to(torch.float32) * case["cot"]).sum().backward()
    assert (np.abs(got - out.detach().to(torch.float32).numpy()) <= 3 * ulp).all()
    for r in ranks:
        st = r[name]["state"]
        assert _rel(st["running_mean"].numpy(), stats["mean"]) <= 1e-5
        assert _rel(st["running_var"].numpy(), stats["var"]) <= 1e-5
    # the input gradient: float32 arithmetic on bfloat16 data, against JAX's
    # bfloat16 autodiff, by the tensor's largest entry
    assert _rel(_gathered(ranks, name, "x_grad"), gx) <= 2e-2
    # the weight and bias gradients: float32 sums over the global batch, as a
    # single process's nn.BatchNorm2d sums them (the JAX package's come out
    # rounded to bfloat16, 7 bits, and part from either by up to 9 %)
    wsum = sum(r[name]["weight_grad"] for r in ranks).numpy()
    bsum = sum(r[name]["bias_grad"] for r in ranks).numpy()
    assert _rel(wsum, plain.weight.grad.numpy()) <= 1e-3
    assert _rel(bsum, plain.bias.grad.numpy()) <= 1e-3


def test_the_variance_of_a_channel_far_from_zero_keeps_its_precision(world2):
    """Channel means 50 standard deviations from 0: the JAX package's fast
    variance E[x²] - E[x]² in float32 loses its low bits to cancellation
    (here more than 1e-4 of the variance), while the port's global
    statistics (each rank's two-pass mean and squared deviations, combined
    in float64) stay within 1e-6 of float64."""
    cases, ranks = world2
    x = cases["far_from_zero"]["x"].numpy().transpose(1, 0, 2, 3).reshape(16, -1)
    n = x.shape[1]
    exact = x.astype(np.float64).var(axis=1) * n / (n - 1)
    xf = x.astype(np.float32)
    fast = (np.mean(xf * xf, axis=1, dtype=np.float32)
            - np.square(np.mean(xf, axis=1, dtype=np.float32))) * np.float32(n / (n - 1))
    assert np.abs(fast - exact).max() / exact.max() > 1e-4
    state = cases["far_from_zero"]["state"]
    for r in ranks:
        got = r["far_from_zero"]["state"]["running_var"].double().numpy()
        want = 0.9 * state["running_var"].double().numpy() + 0.1 * exact
        assert np.abs(got - want).max() / want.max() <= 1e-6
