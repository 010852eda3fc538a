"""The flow-guided consistency step of the port against the JAX package's:
the 16x shrink of the flow field, the frozen flow net's field inside the
step, one `flow_train_step` (its three terms, every BatchNorm statistic, the
parameters after one Adam update) with the flow on and off, a free-running
curve, the frozen flow net and the fused step's view 1.  The trainer, its
CLI and the pretrainer on real clip pairs are in
`test_torch_port_flow_trainer.py`.

The audio tower, whose jitted JAX gradient is wrong on the CPU
(ROADMAP.md host facts), is held to the JAX package's eager gradient,
taken by the chain rule: jitted up to the pooled audio features and eager
through the audio tower (`torch_port_util.py::chained_eager_audio_update`).
The weight of the warp term and `compute_flow` are static arguments of the
JAX step, so each is a program of its own (about 11 s of compiling on the
CPU): the JAX package is run at weight 0.1 with the flow.  Its forward is
the same at weight 0 and without the flow (`avtubes/train/flow.py:96-117`:
the same `forward_shared_audio`, the warp term reading 0.0 without the
flow), so the port's terms and statistics there are held to that run's,
the loss being the CE."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from avtubes.losses import hardway_loss as jax_hardway_loss
from avtubes.models.flownet import FlowNetLite as JaxFlowNetLite
from avtubes.models.hardway import HardwayConfig as JaxHardwayConfig
from avtubes.models.hardway import hardway_head as jax_hardway_head
from avtubes.ops.warp import flow_warp as jax_flow_warp
from avtubes.train import flow as jflow
from avtubes_torch.core.convert import avenet_from_flax, flownet_from_flax
from avtubes_torch.data.transforms import augment_view1
from avtubes_torch.models.flownet import FlowNetLite
from avtubes_torch.train import flow as tflow
from avtubes_torch.train import flow_pretrain as tfp
from test_torch_port_train_step import JAX_TX, LR, _states
from torch_port_util import (
    IMG,
    assert_adam_update_follows,
    assert_relative_by_tensor,
    augment_draws_from_jax_key,
    chained_eager_audio_update,
    jax_avenet_state,
    numpy_init,
    numpy_variables,
    spec_cfgs,
)

torch.set_num_threads(2)
B, T = 2, 3
WEIGHT = 0.1
TERMS = ("loss", "hardway_loss", "warp_consistency")
RTOL = 1e-5          # the terms, relative: float32 sums in another order (3.1e-6 measured)


@pytest.fixture(scope="module")
def host_state():
    return jax.device_get(jax_avenet_state(0, JAX_TX))


@pytest.fixture(scope="module")
def flow_variables():
    """JAX FlowNetLite weights made with numpy: He fan-out kernels, zero
    biases, the init's softmax temperature of 10, and a flow head that is
    not zero (the init's is), so the net's output is more than its
    soft-argmax prior."""
    shapes = jax.eval_shape(lambda r: JaxFlowNetLite().init(
        r, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, IMG, IMG, 3))), jax.random.PRNGKey(7))
    variables = numpy_init(shapes, 7)
    variables["params"]["corr_temp"] = np.full((1,), 10.0, np.float32)
    head = variables["params"]["flow_head"]["kernel"]
    variables["params"]["flow_head"]["kernel"] = (
        0.05 * np.random.RandomState(8).randn(*head.shape)).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def jax_flow(flow_variables):
    """The JAX step's flow field on the batch of seed 1: its net on the
    frames un-normalized to [0, 1] (`avtubes/train/flow.py:86-91`)."""
    frames, _ = _batch(1)
    raw = jnp.asarray(frames) * jnp.asarray(IMAGENET_STD) + jnp.asarray(IMAGENET_MEAN)
    return jax.jit(JaxFlowNetLite().apply)(
        flow_variables, raw[:, :-1].reshape(B * (T - 1), IMG, IMG, 3),
        raw[:, 1:].reshape(B * (T - 1), IMG, IMG, 3))


def _flow_net(variables) -> FlowNetLite:
    net = FlowNetLite(generator=torch.Generator().manual_seed(1))
    net.load_state_dict(flownet_from_flax(variables["params"]), strict=True)
    return net.eval().requires_grad_(False)


def _batch(seed: int):
    _, cfg = spec_cfgs()
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, IMG, IMG, 3).astype(np.float32),
            rng.randn(B, *cfg.shape, 1).astype(np.float32))


@pytest.fixture(scope="module")
def jax_step(host_state, flow_variables):
    """The JAX package's step at weight 0.1 on the batch of seed 1: (state
    after it, its metrics)."""
    frames, spec = (jnp.asarray(a) for a in _batch(1))
    js = jax.tree_util.tree_map(jnp.asarray, host_state)
    js, mj = jflow.flow_train_step(js, flow_variables, frames, spec, WEIGHT, False, True)
    return js, {k: float(v) for k, v in mj.items()}


@pytest.fixture(scope="module")
def port_step(host_state, flow_variables):
    """`port_step(weight, compute_flow)`: the port's step from the JAX
    state on the batch of seed 1, taken once for each pair: (state after
    it, its metrics, the parameters before it).  Read, never changed."""
    steps = {}

    def step(weight, compute_flow=True):
        if (weight, compute_flow) not in steps:
            _, state = _states(host_state)
            before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            frames, spec = (torch.from_numpy(a) for a in _batch(1))
            mt = tflow.flow_train_step(state, _flow_net(flow_variables), frames, spec, weight,
                                       compute_flow=compute_flow)
            steps[weight, compute_flow] = state, {k: float(v) for k, v in mt.items()}, before
        return steps[weight, compute_flow]

    return step


@pytest.fixture(scope="module")
def eager_audio(host_state, jax_flow):
    """The JAX package's audio-tower gradient of CE + 0.1 warp on the batch
    of seed 1, its audio tower's part taken without jit, and the audio
    parameters its optimizer makes of it."""
    js = jax.tree_util.tree_map(jnp.asarray, host_state)
    frames, spec = (jnp.asarray(a) for a in _batch(1))

    def loss(aud, variables, frames, jax_flow):   # avtubes/train/flow.py:96-117
        img = js.apply_fn(variables, frames.reshape(B * T, IMG, IMG, 3), train=True,
                          mutable=["batch_stats"], method="encode_image")[0]
        out = jax_hardway_head(img, jnp.repeat(aud, T, axis=0), JaxHardwayConfig())
        pos = out.pos.reshape(B, T, *out.pos.shape[1:])
        h, w = pos.shape[2:]
        flow_hw = jax.image.resize(jax_flow, (B * (T - 1), h, w, 2), method="linear") * (h / IMG)
        warped = jax_flow_warp(pos[:, :-1].reshape(B * (T - 1), h, w, 1), flow_hw)
        warp = jnp.abs(warped - pos[:, 1:].reshape(B * (T - 1), h, w, 1)).mean()
        return jax_hardway_loss(out.logits) + WEIGHT * warp

    return chained_eager_audio_update(
        js, spec, loss, avenet_from_flax, {"params": js.params, "batch_stats": js.batch_stats},
        frames, jax_flow)


# ------------------------------------------------------------ the flow field

@pytest.mark.parametrize("size", [224, 64])
def test_resize_linear_shrinks_16x_as_jax_image_resize(size):
    """The step shrinks the flow 224 -> 14 at the recipe (64 -> 4 here): a
    triangle filter 16 pixels wide (2.98e-8 measured)."""
    x = np.random.RandomState(size).randn(3, size, size, 2).astype(np.float32)
    out = size // 16
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, out, out, 2), "linear"))
    got = tfp.resize_linear(torch.from_numpy(x), out, out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_the_flow_field_inside_the_step_is_the_jax_package_s(flow_variables, jax_flow):
    """On the frames un-normalized to [0, 1], as the JAX step feeds its flow
    net (3.4e-5 px measured on fields of ~20 px)."""
    frames, _ = _batch(1)
    want = np.asarray(jax_flow)
    got = tflow.frame_pair_flow(_flow_net(flow_variables), torch.from_numpy(frames))
    assert got.shape == (B * (T - 1), IMG, IMG, 2) and got.grad_fn is None
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # fed the normalized frames instead, the net gives another field
    wrong = _flow_net(flow_variables)(torch.from_numpy(frames[:, :-1].reshape(-1, IMG, IMG, 3)),
                                      torch.from_numpy(frames[:, 1:].reshape(-1, IMG, IMG, 3)))
    assert float((wrong - got).abs().max()) > 1.0


# ------------------------------------------------------------------ one step

def _stats_errors(js, model) -> dict[str, float]:
    want = avenet_from_flax(numpy_variables(js))
    got = model.state_dict()
    return {k: float((got[k] - v).abs().max() / v.abs().max())
            for k, v in want.items() if "running" in k}


@pytest.mark.parametrize("weight,compute_flow", [(WEIGHT, True), (0.0, True), (0.0, False)],
                         ids=["weight_0.1", "weight_0", "no_flow"])
def test_one_step_gives_the_terms_and_one_update_of_every_statistic(
        port_step, jax_step, weight, compute_flow):
    js, mj = jax_step
    if weight == 0:                   # the same forward: the loss is the CE
        mj = {**mj, "loss": mj["hardway_loss"],
              "warp_consistency": mj["warp_consistency"] if compute_flow else 0.0}
    state, mt, _ = port_step(weight, compute_flow)
    assert set(mt) == set(mj) == set(TERMS)
    for k in TERMS:
        assert abs(mt[k] - mj[k]) <= RTOL * abs(mj[k]), (k, mt[k], mj[k])
    assert (mt["warp_consistency"] > 0) == compute_flow
    if not compute_flow:
        assert mt["warp_consistency"] == 0.0 and mt["loss"] == mt["hardway_loss"]
    assert state.step == int(js.step) == 1
    # one forward: one EMA step of each tower's statistics (2.0e-6 measured)
    errs = _stats_errors(js, state.model)
    assert max(errs.values()) <= RTOL, max(errs.items(), key=lambda kv: kv[1])
    for bn in (state.model.imgnet.bn1, state.model.audnet.bn1,
               state.model.audnet.layer4[1].bn2):
        assert int(bn.num_batches_tracked) == 1


def test_the_parameters_after_one_adam_update(port_step, jax_step):
    """At weight 0.1 the image tower against the JAX package's jitted step
    (the audio tower against its eager gradient, below).  The warp term's
    gradient reaches the towers through `pos`: without it the image tower's
    gradient is another."""
    js, _ = jax_step
    state, _, before = port_step(WEIGHT)
    assert_adam_update_follows(state.model.imgnet.named_parameters(prefix="imgnet"),
                               avenet_from_flax(numpy_variables(js)), before, LR)
    with_warp = state.model.imgnet.layer4[1].conv2.weight.grad
    state0, _, _ = port_step(0.0)
    assert not torch.allclose(with_warp, state0.model.imgnet.layer4[1].conv2.weight.grad)


def test_the_audio_gradient_is_the_eager_jax_gradient(port_step, eager_audio):
    state, _, _ = port_step(WEIGHT)
    got = {n: p.grad for n, p in state.model.audnet.named_parameters(prefix="audnet")}
    assert_relative_by_tensor(got, eager_audio[0], 1e-4)


def test_the_audio_parameters_after_one_adam_update(port_step, eager_audio):
    """At weight 0.1: the audio tower against the JAX package's optimizer
    applied to its eager gradient."""
    state, _, before = port_step(WEIGHT)
    assert_adam_update_follows(state.model.audnet.named_parameters(prefix="audnet"),
                               eager_audio[1], before, LR)


def test_the_flow_net_is_frozen(host_state, flow_variables, monkeypatch):
    """No flow-net parameter is in the optimizer or gets a gradient, the flow
    field carries no graph (so the cost volume's backward never runs), and
    the net's parameters are bit-unchanged after steps."""
    _, state = _states(host_state)
    net = _flow_net(flow_variables)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    fields = []
    real = tflow.frame_pair_flow

    def spy(*args):
        fields.append(real(*args))
        return fields[-1]

    monkeypatch.setattr(tflow, "frame_pair_flow", spy)
    for seed in (1, 2):
        frames, spec = (torch.from_numpy(a) for a in _batch(seed))
        tflow.flow_train_step(state, net, frames, spec, WEIGHT)
    optimized = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    assert not optimized & {id(p) for p in net.parameters()}
    assert all(p.grad is None and not p.requires_grad for p in net.parameters())
    assert len(fields) == 2 and all(f.grad_fn is None and not f.requires_grad for f in fields)
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_three_free_running_steps_follow_the_jax_loss_curve(host_state, flow_variables,
                                                            jax_step):
    """Each package updates its own weights (Adam near zero gradients, the
    jitted audio gradient): every term of the curve is held to 5e-3 of the
    loss (measured after three steps: the warp term parts by 2.6e-3 of
    0.10, 1.4e-3 of the loss)."""
    js, state = _states(host_state)
    net = _flow_net(flow_variables)
    for seed in (1, 2, 3):
        frames, spec = _batch(seed)
        # the arguments as `jax_step` gives them: one compiled program
        js, mj = jflow.flow_train_step(js, flow_variables, jnp.asarray(frames),
                                       jnp.asarray(spec), WEIGHT, False, True)
        mt = tflow.flow_train_step(state, net, torch.from_numpy(frames),
                                   torch.from_numpy(spec), WEIGHT)
        for k in TERMS:
            assert abs(float(mt[k]) - float(mj[k])) <= 5e-3 * float(mj["loss"]), (k, mt, mj)
    assert state.step == int(js.step) == 3


def test_a_weight_without_the_flow_raises(host_state):
    _, state = _states(host_state)
    frames, spec = (torch.from_numpy(a) for a in _batch(1))
    with pytest.raises(ValueError, match="compute_flow"):
        tflow.flow_train_step(state, None, frames, spec, WEIGHT, compute_flow=False)
    assert state.step == 0


def test_the_fused_step_takes_view_1_with_the_flips_of_the_jax_key(host_state,
                                                                    flow_variables):
    """The JAX package's fused step draws both views from its key and trains
    on the first; the port computes view 1 alone from the flips that key
    gives it (view 1 against the JAX package's: `test_torch_port_train3d.py::
    test_fused_step_with_view_1_s_flips_from_the_jax_key`), then runs the
    step."""
    jcfg, cfg = spec_cfgs()
    rng = np.random.RandomState(4)
    clips = rng.randint(0, 256, (B, T, IMG, IMG, 3), dtype=np.uint8)
    waves = np.clip(rng.randn(B, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    flip1 = augment_draws_from_jax_key(key, B, IMG, IMG).flip1
    assert flip1.tolist() in ([True, False], [False, True]), flip1
    view = augment_view1(torch.from_numpy(clips), flip1)
    _, fused = _states(host_state)
    _, plain = _states(host_state)
    net = _flow_net(flow_variables)
    got = tflow.flow_fused_train_step(fused, net, torch.from_numpy(clips),
                                      torch.from_numpy(waves), flip1, cfg, WEIGHT)
    from avtubes_torch.data.spectrogram import log_spectrogram

    spec = log_spectrogram(torch.from_numpy(waves), cfg)[..., None]
    want = tflow.flow_train_step(plain, net, view, spec, WEIGHT)
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
