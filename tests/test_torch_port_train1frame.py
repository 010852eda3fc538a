"""The 1-frame hard-way trainer of the port against the JAX package's: one
`hardway_1frame_train_step` (loss, the BatchNorm statistics advanced ONCE,
the audio tower's too, the audio tower's gradient, and the parameters after
one Adam update), the fused step with the flips drawn from the JAX key, and
the trainer end to end with its hard-way test (its CLI on a machine without
a card is in `test_torch_port_hygiene.py`).

The audio tower is held to the JAX package's EAGER gradient: its JITTED
gradient of the audio tower on the CPU is not the gradient of its loss (a
finite difference in float64 says so, below), while the eager one and the
port's are."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.losses import hardway_loss as jax_hardway_loss
from avtubes.train import steps as jsteps
from avtubes_torch.core.checkpoint import latest_checkpoint
from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.convert import avenet_from_flax
from avtubes_torch.losses.losses import hardway_loss
from avtubes_torch.train import hardway_1frame
from avtubes_torch.train import steps as tsteps
from test_torch_port_train_step import JAX_TX, LR, _states
from torch_port_util import (
    IMG,
    assert_adam_update_follows,
    assert_relative_by_tensor,
    eager_adam_update,
    flips_from_jax_key,
    jax_state,
    numpy_variables,
    port_model,
    spec_cfgs,
)

torch.set_num_threads(2)
B = 3
SMALL = ["--synthetic", "--image_size", "64", "--batch_size", "2", "--samplerate", "8000",
         "--audio_seconds", "1", "--n_threads", "2", "--learning_rate", "1e-4",
         "--eval_batch_size", "3"]
CPU32 = ["--device", "cpu", "--compute_dtype", "float32"]


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A trainer's checkpoints (hundreds of MB at full width) are removed
    after each test: the suite keeps its temporary directories."""
    yield
    for path in tmp_path.glob("*_ep*"):
        path.unlink()


@pytest.fixture(scope="module")
def host_state():
    js = jax_state(0)
    return jax.device_get(js.replace(tx=JAX_TX, opt_state=JAX_TX.init(js.params)))


def _batch(rng):
    _, cfg = spec_cfgs()
    return (rng.randn(B, IMG, IMG, 3).astype(np.float32),
            rng.randn(B, *cfg.shape, 1).astype(np.float32))


@pytest.fixture(scope="module")
def eager_audio(host_state):
    """The JAX package's eager audio-tower gradient on the batch of seed 2,
    and the audio parameters its optimizer makes of it (port names)."""
    js = jax.tree_util.tree_map(jnp.asarray, host_state)
    frames, spec = (jnp.asarray(a) for a in _batch(np.random.RandomState(2)))
    return eager_adam_update(
        js, lambda v: js.apply_fn(v, frames, spec, train=True, mutable=["batch_stats"])[0],
        avenet_from_flax)


def _step_on_batch_2(host_state):
    """Both packages' steps on the batch of seed 2: (the JAX state
    after it, the port's state after it, the port's parameters before it)."""
    js, state = _states(host_state)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    batch = _batch(np.random.RandomState(2))
    js, _ = jsteps.hardway_1frame_train_step(js, *(jnp.asarray(a) for a in batch))
    tsteps.hardway_1frame_train_step(state, *(torch.from_numpy(a) for a in batch))
    return js, state, before


def _stats_errors(js, model) -> dict[str, float]:
    want = avenet_from_flax(numpy_variables(js))
    got = model.state_dict()
    return {k: float((got[k] - v).abs().max() / v.abs().max())
            for k, v in want.items() if "running" in k}


def test_one_step_gives_the_loss_and_advances_every_statistic_once(host_state):
    js, state = _states(host_state)
    batch = _batch(np.random.RandomState(1))
    js, mj = jsteps.hardway_1frame_train_step(js, *(jnp.asarray(a) for a in batch))
    mt = tsteps.hardway_1frame_train_step(state, *(torch.from_numpy(a) for a in batch))
    assert set(mt) == set(mj) == {"loss"}
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= 1e-4 * abs(float(mj["loss"]))
    assert state.step == int(js.step) == 1
    errs = _stats_errors(js, state.model)
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    # one forward: one EMA step in both towers (no `_advance_audio_stats`)
    for bn in (state.model.imgnet.bn1, state.model.audnet.bn1,
               state.model.audnet.layer4[1].bn2):
        assert int(bn.num_batches_tracked) == 1


def test_the_audio_gradient_is_the_eager_jax_gradient(host_state, eager_audio):
    """The port's audio-tower gradient of one step against the JAX package's
    eager one, by tensor (measured: 3.3e-5 of a tensor's largest entry)."""
    _, state, _ = _step_on_batch_2(host_state)
    got = {n: p.grad for n, p in state.model.audnet.named_parameters(prefix="audnet")}
    assert_relative_by_tensor(got, eager_audio[0], 1e-4)


def test_the_parameters_after_one_adam_update(host_state, eager_audio):
    """The image tower against the JAX package's jitted step, the audio
    tower against the JAX package's optimizer applied to its eager gradient
    (the jitted audio gradient is wrong, below)."""
    js, state, before = _step_on_batch_2(host_state)
    assert_adam_update_follows(state.model.imgnet.named_parameters(prefix="imgnet"),
                               avenet_from_flax(numpy_variables(js)), before, LR)
    assert_adam_update_follows(state.model.audnet.named_parameters(prefix="audnet"),
                               eager_audio[1], before, LR)


def test_the_jax_package_s_jitted_audio_gradient_misses_its_finite_difference(host_state):
    """Along the direction in which the two packages' audio-tower gradients
    differ most, a central difference of the loss in float64 agrees with the
    port's gradient, not with the JAX package's jitted one (on the CPU, jax
    0.9.0: the jitted audio gradient parts from the eager one by 86-110 % of
    its largest entry at every spectrogram geometry tried, in AVENet and
    FullModel alike; the image towers agree)."""
    js = jax.tree_util.tree_map(jnp.asarray, host_state)
    frames, spec = _batch(np.random.RandomState(3))

    def loss(params):
        out, _ = js.apply_fn({"params": params, "batch_stats": js.batch_stats},
                             jnp.asarray(frames), jnp.asarray(spec), train=True,
                             mutable=["batch_stats"])
        return jax_hardway_loss(out.logits)

    jit_grads = avenet_from_flax({"params": jax.device_get(jax.jit(jax.grad(loss))(js.params)),
                                  "batch_stats": numpy_variables(js)["batch_stats"]})
    model = port_model(js).train()
    hardway_loss(model(torch.from_numpy(frames), torch.from_numpy(spec)).logits).backward()
    names = [n for n, _ in model.audnet.named_parameters(prefix="audnet")]
    port_grads = dict(model.named_parameters())
    d = {n: port_grads[n].grad.double() - jit_grads[n].double() for n in names}
    norm = torch.sqrt(sum((v ** 2).sum() for v in d.values()))
    u = {n: v / norm for n, v in d.items()}

    m64 = port_model(js).train().double()
    m64.imgnet.compute_dtype = m64.audnet.compute_dtype = torch.float64
    params64 = dict(m64.named_parameters())
    x, a = torch.from_numpy(frames).double(), torch.from_numpy(spec).double()

    def shifted(eps: float) -> float:
        m = port_model(js).train().double()
        m.imgnet.compute_dtype = m.audnet.compute_dtype = torch.float64
        with torch.no_grad():
            for n, p in m.named_parameters():
                if n in u:
                    p.add_(u[n], alpha=eps)
            return float(hardway_loss(m(x, a).logits))

    eps = 1e-5
    fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
    hardway_loss(m64(x, a).logits).backward()
    exact = float(sum((params64[n].grad * u[n]).sum() for n in names))
    along_port = float(sum((port_grads[n].grad.double() * u[n]).sum() for n in names))
    along_jit = float(sum((jit_grads[n].double() * u[n]).sum() for n in names))
    # the difference steps over a few ReLU and max-pool kinks: 1.5e-3 measured
    assert abs(fd - exact) <= 1e-2 * abs(exact), (fd, exact)
    assert abs(along_port - exact) <= 1e-3 * abs(exact), (along_port, exact)
    assert abs(along_jit - exact) >= 0.5 * abs(exact), (along_jit, exact)


def test_fused_step_with_the_flips_from_the_jax_key(host_state):
    jcfg, cfg = spec_cfgs()
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    waves = np.clip(rng.randn(B, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    flips = flips_from_jax_key(key, B)
    assert 0 < int(flips.sum()) < B, flips          # both ways exercised
    js, state = _states(host_state)
    js, mj = jsteps.hardway_1frame_fused_step(js, jnp.asarray(frames), jnp.asarray(waves), key,
                                              jcfg)
    mt = tsteps.hardway_1frame_fused_step(state, torch.from_numpy(frames),
                                          torch.from_numpy(waves), flips, cfg)
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= 1e-4 * abs(float(mj["loss"]))
    errs = _stats_errors(js, state.model)
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])


def _records(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.open()]


def test_the_trainer_trains_tests_records_checkpoints_and_resumes(tmp_path):
    args = [*CPU32, *SMALL, "--frame_density", "4", "--steps", "2", "--epochs", "1",
            "--summaries_dir", str(tmp_path), "--record_qualitative", "2"]
    final = hardway_1frame.run(ExperimentConfig.from_args(args), steps_cap=2)
    # the JAX package's keys: the step's and the hard-way test's
    assert set(final) == {"loss", "hardway_ciou", "hardway_auc", "hardway_n"}
    assert np.isfinite(final["loss"]) and final["hardway_n"] == 8
    assert 0.0 <= final["hardway_ciou"] <= 1.0 and 0.0 <= final["hardway_auc"] <= 1.0
    assert latest_checkpoint(tmp_path, "hardway1frm").name == "hardway1frm_ep0"
    assert torch.load(tmp_path / "hardway1frm_ep0", weights_only=True)["step"] == 2
    assert sorted(p.name for p in (tmp_path / "images").iterdir()) == [
        "synthetic_0_hardway_0.jpg", "synthetic_1_hardway_0.jpg"]
    cfg = ExperimentConfig.from_args([*args, "--epochs", "2", "--use_pretrained"])
    hardway_1frame.run(cfg, steps_cap=2)
    steps = [r["step"] for r in _records(tmp_path / "hardway1frm.metrics.jsonl") if "loss" in r]
    assert steps == [1, 2, 3, 4]
    assert latest_checkpoint(tmp_path, "hardway1frm").name == "hardway1frm_ep1"


def test_the_trainer_takes_the_middle_frame_whatever_frame_density(tmp_path, monkeypatch):
    seen = []
    real = tsteps.hardway_1frame_fused_step

    def spy(state, frames, *args, **kwargs):
        seen.append(tuple(frames.shape))
        return real(state, frames, *args, **kwargs)

    monkeypatch.setattr(hardway_1frame, "hardway_1frame_fused_step", spy)
    cfg = ExperimentConfig.from_args([*CPU32, *SMALL, "--frame_density", "16", "--steps", "1",
                                      "--epochs", "1", "--summaries_dir", str(tmp_path)])
    hardway_1frame.run(cfg, steps_cap=1, do_eval=False)
    assert seen == [(2, 64, 64, 3)]


def test_unported_options_raise(tmp_path):
    cfg = ExperimentConfig.from_args(["--device", "cpu", *SMALL, "--remat",
                                      "--summaries_dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        hardway_1frame.run(cfg, steps_cap=1)
    assert not list(tmp_path.iterdir())
