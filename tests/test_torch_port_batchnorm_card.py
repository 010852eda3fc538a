"""The fused BatchNorm + add + ReLU kernels (`ops/batchnorm.py`,
`csrc/batchnorm.cu`) on the card, against the plain version in float32 on
the same bf16 inputs.  Needs a CUDA card and skips without one.  This file
imports no JAX, so it runs on a machine that has none:
`python -m pytest --noconftest tests/test_torch_port_batchnorm_card.py`
(the tests' `conftest.py` sets JAX up).

Tolerances: the kernels keep their statistics in float32 and float64 and
round each output once to bf16, so an output is the float32 plain version's
within bf16's half ulp (2^-9, relative) plus the float32 arithmetic's own
error; the sums of the gradients within float32 summation.  The gradient
is left out where the plain version's output before the ReLU lies within
1e-4 of 0: there the two masks may disagree by a rounding of the
statistics, and each would be right."""

import numpy as np
import pytest
import torch

from avtubes_torch.ops import batchnorm as ops

CL3D = torch.channels_last_3d
EPS, MOMENTUM = 1e-5, 0.1
#: R3D-18's widths; (N, T, H, W) that gives 25,088 rows, enough to fill the
#: grid (528 blocks at every width) and use several groups of the combine
WIDTHS = (64, 128, 256, 512)
NTHW = (4, 8, 28, 28)
KINDS = {"relu": (False, True), "add_relu": (True, True), "none": (False, False)}
#: bf16's relative half ulp, with room for the float32 arithmetic before it
Y_RTOL = 2.0 ** -8
KINK = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(card, c, seed, residual):
    gen = torch.Generator(card).manual_seed(seed)
    shape = (NTHW[0], c, *NTHW[1:])
    means = torch.randn(1, c, 1, 1, 1, device=card, generator=gen)
    x = (torch.randn(shape, device=card, generator=gen) * 2 + means).to(torch.bfloat16)
    r = torch.randn(shape, device=card, generator=gen).to(torch.bfloat16) if residual else None
    dy = torch.randn(shape, device=card, generator=gen).to(torch.bfloat16)
    params = {"weight": torch.rand(c, device=card, generator=gen) + 0.5,
              "bias": torch.randn(c, device=card, generator=gen) * 0.1,
              "running_mean": torch.randn(c, device=card, generator=gen) * 0.1,
              "running_var": torch.rand(c, device=card, generator=gen) + 0.5}
    as_cl = (lambda t: None if t is None else t.contiguous(memory_format=CL3D))  # noqa: E731
    return as_cl(x), as_cl(r), as_cl(dy), params


def _run(fn, x, r, dy, params, relu, momentum=MOMENTUM):
    """y, the gradients of x, weight, bias and residual, and the running
    statistics after one call of `fn` (kernels or plain) on fresh copies."""
    p = {k: v.clone().requires_grad_(k in ("weight", "bias")) for k, v in params.items()}
    x = x.detach().clone().requires_grad_(True)
    r = None if r is None else r.detach().clone().requires_grad_(True)
    y = fn(x, p["weight"], p["bias"], p["running_mean"], p["running_var"], momentum, EPS, r,
           relu)
    y.backward(dy.to(y.dtype))
    return {"y": y.detach(), "dx": x.grad, "dweight": p["weight"].grad,
            "dbias": p["bias"].grad, "dresidual": None if r is None else r.grad,
            "running_mean": p["running_mean"], "running_var": p["running_var"]}


def _plain32(x, r, dy, params, relu):
    return _run(ops.batchnorm_act_plain, x.float(), None if r is None else r.float(),
                dy.float(), params, relu)


def _pre_relu(x, r, params):
    """The plain float32 output before the ReLU."""
    v = torch.nn.functional.batch_norm(x.float(), None, None, params["weight"], params["bias"],
                                       True, 0.0, EPS)
    return v if r is None else v + r.float()


def _close(got, want, rtol, what, atol_of_max=1e-4):
    got, want = got.double(), want.double()
    atol = atol_of_max * float(want.abs().max())
    bad = ((got - want).abs() > atol + rtol * want.abs())
    assert not bool(bad.any()), (f"{what}: {int(bad.sum())} of {bad.numel()} values off, "
                                 f"worst {float((got - want).abs().max())}")


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("c", WIDTHS)
def test_the_kernels_are_the_plain_version_in_float32(card, c, kind):
    residual, relu = KINDS[kind]
    x, r, dy, params = _inputs(card, c, seed=c, residual=residual)
    if relu:   # no gradient at the ReLU's kink (the module docstring)
        dy = torch.where(_pre_relu(x, r, params).abs() < KINK, 0.0, dy.float()).to(dy.dtype)
        dy = dy.contiguous(memory_format=CL3D)
    got = _run(ops.batchnorm_act, x, r, dy, params, relu)
    want = _plain32(x, r, dy, params, relu)
    assert got["y"].dtype == torch.bfloat16 and got["y"].is_contiguous(memory_format=CL3D)
    _close(got["y"], want["y"], Y_RTOL, "y", 1e-5)
    _close(got["dx"], want["dx"], Y_RTOL, "dx")
    _close(got["dweight"], want["dweight"], 1e-4, "dweight")
    _close(got["dbias"], want["dbias"], 1e-4, "dbias")
    if residual:
        assert torch.equal(got["dresidual"].float(), want["dresidual"])   # dy masked: exact
    else:
        assert got["dresidual"] is None
    _close(got["running_mean"], want["running_mean"], 1e-5, "running_mean", 1e-6)
    _close(got["running_var"], want["running_var"], 1e-5, "running_var", 1e-6)
    # the statistics themselves, against float64 over the bf16 values
    mean, invstd = ops.bn_stats_cuda(x, None, None, 0.0, EPS)
    xd = x.double()
    var64, mean64 = torch.var_mean(xd, dim=(0, 2, 3, 4), correction=0)
    _close(mean, mean64, 1e-6, "mean", 1e-6)
    _close(invstd, (var64 + EPS).rsqrt(), 1e-5, "invstd", 0)


@pytest.mark.card
def test_a_channel_whose_mean_is_ten_thousand_times_its_spread(card):
    """Every value of channel 0 is a = 256 but one in 10,000 lies one bf16
    ulp above (258): mean / std = 1.2e4.  E[x^2] - E[x]^2 in float32 would
    lose the variance (E[x^2] = 65,536.1 has a rounding step of 0.0078,
    16 times the variance of 4.8e-4); Welford's update and Chan's
    combination keep it."""
    c = 64
    x, _, _, params = _inputs(card, c, seed=7, residual=False)
    rows = x.numel() // c
    col = torch.full((rows,), 256.0, device=card)
    col[::10000] = 258.0
    flat = x.permute(0, 2, 3, 4, 1).reshape(rows, c)      # a view in channels-last
    flat[:, 0] = col.to(torch.bfloat16)
    var64, mean64 = torch.var_mean(x.double(), dim=(0, 2, 3, 4), correction=0)
    assert float(mean64[0] / var64[0].sqrt()) > 9e3
    p = {k: v.clone() for k, v in params.items()}
    mean, invstd = ops.bn_stats_cuda(x, p["running_mean"], p["running_var"], MOMENTUM, EPS)
    var = invstd.double().pow(-2) - EPS
    assert abs(float(var[0] / var64[0]) - 1) < 1e-3, (float(var[0]), float(var64[0]))
    _close(mean[:1], mean64[:1], 1e-7, "mean", 0)
    unbiased = var64 * rows / (rows - 1)
    want_var = (1 - MOMENTUM) * params["running_var"].double() + MOMENTUM * unbiased
    assert abs(float(p["running_var"][0] / want_var[0]) - 1) < 1e-5


@pytest.mark.card
def test_momentum_zero_leaves_the_running_statistics_as_they_are(card):
    x, r, dy, params = _inputs(card, 128, seed=3, residual=True)
    got = _run(ops.batchnorm_act, x, r, dy, params, True, momentum=0.0)
    assert torch.equal(got["running_mean"], params["running_mean"])
    assert torch.equal(got["running_var"], params["running_var"])


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
def test_two_runs_are_bit_equal(card, kind):
    residual, relu = KINDS[kind]
    x, r, dy, params = _inputs(card, 256, seed=5, residual=residual)
    first = _run(ops.batchnorm_act, x, r, dy, params, relu)
    second = _run(ops.batchnorm_act, x, r, dy, params, relu)
    for k, v in first.items():
        assert (v is None and second[k] is None) or torch.equal(v, second[k]), k


def _tube_state(card, remat=False, video_arch="r3d18", frames=4, size=112):
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.fullmodel import FullModel
    from avtubes_torch.train.state import create_train_state

    model = FullModel(generator=torch.Generator().manual_seed(0), compute_dtype="bfloat16",
                      remat=remat, video_arch=video_arch, image_size=size, frames=frames)
    return create_train_state(model.to(card), OptimConfig())


def _tube_batch(card, b=2, t=4, size=112):
    gen = torch.Generator(card).manual_seed(11)
    video = torch.randn(b, t, size, size, 3, device=card, generator=gen)
    spec = torch.randn(b, 257, 62, 1, device=card, generator=gen)
    return video, spec


def _counters():
    return (ops.bn_stats_cuda.launches, ops.bn_apply_cuda.launches,
            ops.bn_backward_reduce_cuda.launches, ops.bn_backward_elemt_cuda.launches,
            ops.BatchNormAct.dy_copies)


def _grads_and_state(state):
    model = state.model
    return ({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k or "num_batches" in k})


@pytest.mark.card
def test_a_bf16_tube_step_launches_20_and_20_and_copies_no_gradient(card):
    """The published widths: each of R3D-18's 20 BatchNorm3d is one
    statistics and one apply launch forward, one reduce and one elementwise
    launch backward; every incoming gradient arrives channels-last."""
    from avtubes_torch.train.steps import train3d_step

    state = _tube_state(card)
    video, spec = _tube_batch(card)
    before = _counters()
    metrics = train3d_step(state, video, spec)
    torch.cuda.synchronize()
    after = _counters()
    assert np.isfinite(float(metrics["loss"]))
    assert tuple(a - b for a, b in zip(after, before)) == (20, 20, 20, 20, 0)


@pytest.mark.card
def test_the_flagship_and_timesformer_steps_launch_none(card):
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.avenet import AVENet
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import train3d_step

    before = _counters()
    state = _tube_state(card, video_arch="timesformer_b16", frames=2, size=224)
    video, spec = _tube_batch(card, b=2, t=2, size=224)
    train3d_step(state, video, spec)
    del state
    model = AVENet(generator=torch.Generator().manual_seed(0), compute_dtype="bfloat16")
    state = create_train_state(model.to(card), OptimConfig())
    frames = torch.randn(4, 112, 112, 3, device=card)
    spec = torch.randn(4, 257, 62, 1, device=card)
    model.train()
    out = model(frames, spec)
    out.logits.float().sum().backward()
    torch.cuda.synchronize()
    assert _counters() == before


@pytest.mark.card
def test_a_bf16_remat_tube_step_is_the_plain_step(card):
    """As `test_torch_port_remat.py` holds on the CPU: under `--remat` the
    backward recomputes each BatchNorm with momentum 0, and the kernels'
    statistics are the same bits each time, so the loss and the running
    statistics are the plain step's, and each gradient is within what two
    plain steps differ by (cuDNN's weight gradients may sum in another
    order from run to run; equal where the plain ones are)."""
    from avtubes_torch.losses.losses import hardway_loss

    video, spec = _tube_batch(card)
    results = []
    for remat in (False, False, True):
        state = _tube_state(card, remat=remat)
        state.model.train()
        loss = hardway_loss(state.model.forward_shared_audio(spec, video).logits)
        loss.backward()
        results.append((float(loss), *_grads_and_state(state)))
        del state
    (loss, grads, stats), (_, grads2, _), (rloss, rgrads, rstats) = results
    assert rloss == loss
    for k in stats:
        assert torch.equal(rstats[k], stats[k]), k
    assert rgrads.keys() == grads.keys()
    for k, g in grads.items():
        spread = float((grads2[k] - g).abs().max())
        assert float((rgrads[k] - g).abs().max()) <= spread, k
