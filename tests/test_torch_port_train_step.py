"""The flagship training step of the port against the JAX package's: the
two-view forward, one step, a three-step trajectory at lr 1e-4 and the audio
tower's second BatchNorm update.  The fused step and the per-module norms
are in `test_torch_port_fused_step.py`, the eval steps in
`test_torch_port_eval.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.config import OptimConfig as JaxOptimConfig
from avtubes.train import steps as jsteps
from avtubes.train.state import make_optimizer as jax_make_optimizer
from avtubes_torch.core.config import OptimConfig
from avtubes_torch.core.convert import avenet_from_flax
from avtubes_torch.train import steps as tsteps
from avtubes_torch.train.state import create_train_state
from torch_port_util import (
    IMG,
    jax_state,
    numpy_variables,
    port_model,
    spec_cfgs,
)

LR = 1e-4            # the rate at which Adam's eps-sized updates are small (ROADMAP Queue 3)
STEPS_PER_EPOCH = 4
B, T = 2, 2
TERMS = ("loss", "hardway_loss", "aug_loss", "l2_loss", "consistency_loss")
# The JAX package's optimizer, built once: it is static in the train state,
# so one object keeps one compiled step for every test here.
JAX_TX = jax_make_optimizer(JaxOptimConfig(learning_rate=LR), STEPS_PER_EPOCH)


@pytest.fixture(scope="module")
def host_state():
    """The JAX state at lr 1e-4, on the host: built (and its step compiled)
    once for the module; each test takes fresh device copies of it."""
    js = jax_state(0)
    return jax.device_get(js.replace(tx=JAX_TX, opt_state=JAX_TX.init(js.params)))


def _states(host):
    """(JAX state, the port's TrainState with the same weights)."""
    js = jax.tree_util.tree_map(jnp.asarray, host)
    model = port_model(js).train()
    state = create_train_state(model, dataclasses.replace(OptimConfig(), learning_rate=LR),
                               STEPS_PER_EPOCH)
    return js, state


def _batch(rng):
    _, cfg = spec_cfgs()
    frames = rng.randn(B, T, IMG, IMG, 3).astype(np.float32)
    augmented = frames + 0.1 * rng.randn(*frames.shape).astype(np.float32)
    spec = rng.randn(B, *cfg.shape, 1).astype(np.float32)
    return frames, augmented, spec


def _both_steps(js, state, batch):
    js, mj = jsteps.hardway_train_step(js, *(jnp.asarray(a) for a in batch), 0.1)
    mt = tsteps.hardway_train_step(state, *(torch.from_numpy(a) for a in batch), 0.1)
    return js, {k: float(v) for k, v in mj.items()}, {k: float(v) for k, v in mt.items()}


def _stats_errors(js, model) -> dict[str, float]:
    """max |port - JAX| / max |JAX| of every running statistic, by tensor."""
    want = avenet_from_flax(numpy_variables(js))
    got = model.state_dict()
    return {k: float((got[k] - v).abs().max() / v.abs().max())
            for k, v in want.items() if "running" in k}


def _sync_weights(js, model) -> None:
    """The JAX state's parameters into the port's model, its statistics kept."""
    want = avenet_from_flax(numpy_variables(js))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(want[name])


# --------------------------------------------------------------------- forward

def test_two_view_forward_matches_and_updates_the_statistics_in_order(host_state):
    js, state = _states(host_state)
    frames, augmented, spec = _batch(np.random.RandomState(0))
    fold = lambda a: a.reshape(B * T, *a.shape[2:])  # noqa: E731
    apply = jax.jit(lambda v, f, a, s: js.apply_fn(v, f, a, s, T, train=True,
                                                   mutable=["batch_stats"],
                                                   method="two_view_forward"))
    (o1, o2), mut = apply({"params": js.params, "batch_stats": js.batch_stats},
                          jnp.asarray(fold(frames)), jnp.asarray(fold(augmented)),
                          jnp.asarray(spec))
    model = state.model
    with torch.no_grad():
        t1, t2 = model.two_view_forward(torch.from_numpy(fold(frames)),
                                        torch.from_numpy(fold(augmented)),
                                        torch.from_numpy(spec), T)
    for got, want in ((t1, o1), (t2, o2)):
        for field in ("heatmap", "logits", "weighted_map"):
            w = np.asarray(getattr(want, field))
            np.testing.assert_allclose(getattr(got, field).numpy(), w,
                                       atol=1e-4 * max(1.0, np.abs(w).max()))
    # the image tower saw two updates (clean, then augmented), the audio one
    errs = _stats_errors(js.replace(batch_stats=mut["batch_stats"]), model)
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    assert int(model.imgnet.bn1.num_batches_tracked) == 2
    assert int(model.audnet.bn1.num_batches_tracked) == 1


# ------------------------------------------------------------------ the steps

def test_one_step_gives_the_four_terms_and_the_statistics(host_state):
    js, state = _states(host_state)
    js, mj, mt = _both_steps(js, state, _batch(np.random.RandomState(1)))
    assert set(mt) == set(mj) == set(TERMS)
    for k in TERMS:
        assert abs(mt[k] - mj[k]) <= 1e-4 * abs(mj[k]), (k, mt[k], mj[k])
    assert state.step == int(js.step) == 1
    errs = _stats_errors(js, state.model)
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    # both towers counted two batches, as the original's two forwards do
    assert int(state.model.audnet.layer1[0].bn1.num_batches_tracked) == 2


def test_three_free_running_steps_at_lr_1e_4_follow_the_jax_loss_curve(host_state):
    """Each package updates its own weights.  They do not stay bit-close: a
    pre-activation within float32 noise of 0 switches a ReLU in one package
    only (a conv's gradient then differs by up to 8 % in a few channels), and
    Adam's first updates are lr * sign(g) wherever |g| is far above eps, so
    every gradient whose sign that noise decides moves its weight 2 lr apart.
    After one such update the losses part by 3e-4 to 2e-3 of the loss (six
    seeds); the bar is 5e-3.  The arithmetic of each step is held to 1e-4
    in the next test, with the weights kept equal."""
    js, state = _states(host_state)
    rng = np.random.RandomState(2)
    for _ in range(3):
        js, mj, mt = _both_steps(js, state, _batch(rng))
        for k in TERMS:
            assert abs(mt[k] - mj[k]) <= 5e-3 * abs(mj["loss"]), (k, mt[k], mj[k])
    assert state.step == int(js.step) == 3


def _three_synced_steps(js, state, rng):
    """Three steps of both packages, the port's weights set to JAX's after
    each; (per-step losses of JAX, of the port, statistics errors)."""
    want, got, errs = [], [], []
    for _ in range(3):
        js, mj, mt = _both_steps(js, state, _batch(rng))
        want.append(mj)
        got.append(mt)
        errs.append(_stats_errors(js, state.model))
        _sync_weights(js, state.model)
    return want, got, errs


def test_three_steps_with_the_weights_kept_equal(host_state):
    """Losses and every running statistic over three steps at lr 1e-4, from
    equal weights at each step: the BatchNorm updates compound (two EMA
    steps a step in both towers) and must stay within 1e-4."""
    js, state = _states(host_state)
    want, got, errs = _three_synced_steps(js, state, np.random.RandomState(3))
    for step, (mj, mt, e) in enumerate(zip(want, got, errs)):
        for k in TERMS:
            assert abs(mt[k] - mj[k]) <= 1e-4 * abs(mj[k]), (step, k, mt[k], mj[k])
        assert max(e.values()) <= 1e-4, (step, max(e.items(), key=lambda kv: kv[1]))


def test_without_the_second_audio_update_the_statistics_part(host_state, monkeypatch):
    """The same three steps with `_advance_audio_stats` skipped: the audio
    tower's running statistics fail the bar above by orders of magnitude;
    the image tower's, updated by two real forwards, still meet it."""
    monkeypatch.setattr(tsteps, "_advance_audio_stats", lambda *a, **k: None)
    js, state = _states(host_state)
    _, _, errs = _three_synced_steps(js, state, np.random.RandomState(3))
    for e in errs:
        audio = max(v for k, v in e.items() if k.startswith("audnet."))
        image = max(v for k, v in e.items() if k.startswith("imgnet."))
        assert audio > 1e-2 > 1e-4 >= image, (audio, image)
