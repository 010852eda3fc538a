"""The 3D tube trainer's step in the port against the JAX package's: one
`train3d_step` (loss, NP-ratio, both towers' BatchNorm statistics after ONE
update each, the audio tower's gradient against the JAX package's eager
one, the parameters after one Adam update), the fused step with view 1's
flips from the JAX key, and three free-running steps; and the view-1 flips
that the 1-frame, 3D and consistency trainers draw by `draw_view1_flips`.
The evaluations and the trainer are in `test_torch_port_eval3d.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.config import OptimConfig as JaxOptimConfig
from avtubes.train import steps as jsteps
from avtubes_torch.core.config import OptimConfig
from avtubes_torch.core.convert import flax_path, fullmodel_from_flax
from avtubes_torch.data.transforms import augment_view1, normalize_imagenet
from avtubes_torch.train import steps as tsteps
from avtubes_torch.train.state import create_train_state
from torch_port_util import (
    IMG,
    assert_adam_update_follows,
    assert_relative_by_tensor,
    augment_draws_from_jax_key,
    eager_adam_update,
    jax_fullmodel_state,
    numpy_variables,
    port_fullmodel,
    spec_cfgs,
)

torch.set_num_threads(2)
LR = 1e-4            # the rate at which Adam's eps-sized updates are small (ROADMAP Queue 3)
B, T = 2, 2
TERMS = ("loss", "np_ratio")


@pytest.fixture(scope="module")
def host_state():
    """The JAX FullModel state at lr 1e-4, on the host, built once."""
    return jax.device_get(jax_fullmodel_state(0, JaxOptimConfig(learning_rate=LR)))


def _states(host):
    js = jax.tree_util.tree_map(jnp.asarray, host)
    model = port_fullmodel(js).train()
    state = create_train_state(model, dataclasses.replace(OptimConfig(), learning_rate=LR), 4)
    return js, state


def _batch(rng):
    _, cfg = spec_cfgs()
    video = rng.randn(B, T, IMG, IMG, 3).astype(np.float32)
    spec = rng.randn(B, *cfg.shape, 1).astype(np.float32)
    return video, spec


@pytest.fixture(scope="module")
def eager_audio(host_state):
    """The JAX package's eager audio-tower gradient of `train3d_step`'s loss
    on the batch of seed 2 (audio encoded once a clip and tiled over T), and
    the audio parameters its optimizer makes of it (port names)."""
    js = jax.tree_util.tree_map(jnp.asarray, host_state)
    video, spec = (jnp.asarray(a) for a in _batch(np.random.RandomState(2)))
    return eager_adam_update(
        js, lambda v: js.apply_fn(v, spec, video, train=True, mutable=["batch_stats"],
                                  method="forward_shared_audio")[0],
        fullmodel_from_flax)


def _both_steps(js, state, batch):
    js, mj = jsteps.train3d_step(js, *(jnp.asarray(a) for a in batch))
    mt = tsteps.train3d_step(state, *(torch.from_numpy(a) for a in batch))
    return js, {k: float(v) for k, v in mj.items()}, {k: float(v) for k, v in mt.items()}


def _errors(js, model, kind: str) -> dict[str, float]:
    """max |port - JAX| / max |JAX| of every running statistic ('running')
    or parameter ('param'), by tensor."""
    want = fullmodel_from_flax(numpy_variables(js))
    got = model.state_dict()
    names = ({n for n in want if "running" in n} if kind == "running"
             else {n for n, _ in model.named_parameters()})
    return {k: float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in names}


def test_one_step_gives_the_loss_np_ratio_and_one_update_of_each_tower(host_state):
    js, state = _states(host_state)
    # --watch_every's norms carry the JAX package's keys and values
    want = jsteps.pytree_group_norms(js.params, "param_norm")
    got = tsteps.pytree_group_norms(state.model.named_parameters(), "param_norm")
    assert set(got) == set(want) and "param_norm/vidnet/stem" in got
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * float(v), k
    js, mj, mt = _both_steps(js, state, _batch(np.random.RandomState(1)))
    assert set(mt) == set(mj) == set(TERMS)
    for k in TERMS:
        assert abs(mt[k] - mj[k]) <= 1e-4 * abs(mj[k]), (k, mt[k], mj[k])
    assert state.step == int(js.step) == 1
    errs = _errors(js, state.model, "running")
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    # one forward, one BatchNorm update in each tower: no second audio update
    for bn in (state.model.vidnet.layer1[0].bn1, state.model.audnet.layer1[0].bn1,
               state.model.audnet.bn1):
        assert int(bn.num_batches_tracked) == 1


def _flax_tree(named) -> dict:
    """The port's named FullModel tensors as the JAX package's nested tree
    (kernels back to DHWIO / HWIO)."""
    tree: dict = {}
    for name, t in named:
        a = t.detach().numpy()
        a = a.transpose({5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0)}.get(a.ndim, range(a.ndim)))
        *path, leaf = flax_path(name)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree


def test_the_audio_gradient_is_the_eager_jax_gradient(host_state, eager_audio):
    """The port's audio-tower gradient of one step, through the features
    tiled over T, against the JAX package's eager one, by tensor (measured:
    3.3e-5 of a tensor's largest entry)."""
    js, state = _states(host_state)
    _both_steps(js, state, _batch(np.random.RandomState(2)))
    got = {n: p.grad for n, p in state.model.audnet.named_parameters(prefix="audnet")}
    assert_relative_by_tensor(got, eager_audio[0], 1e-4)


def test_the_parameters_after_one_adam_update(host_state, eager_audio):
    """Adam's first update is lr * g / (|g| + eps).  (a) The arithmetic: the
    JAX package's optimizer applied to the port's gradients gives the port's
    parameters.  (b) End to end: the tube encoder against the JAX package's
    jitted step, the audio tower against its optimizer applied to its eager
    gradient (the jitted audio gradient on the CPU is wrong:
    `test_torch_port_train1frame.py::
    test_the_jax_package_s_jitted_audio_gradient_misses_its_finite_difference`)."""
    import optax

    js, state = _states(host_state)
    params0 = jax.device_get(js.params)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    js, _, _ = _both_steps(js, state, _batch(np.random.RandomState(2)))
    # (a) the same gradients through the JAX package's optimizer
    grads = _flax_tree((n, p.grad) for n, p in state.model.named_parameters())
    opt_state = js.tx.init(params0)
    updates, _ = js.tx.update(grads, opt_state, params0)
    want = fullmodel_from_flax({"params": jax.device_get(optax.apply_updates(params0, updates)),
                                "batch_stats": numpy_variables(js)["batch_stats"]})
    for name, p in state.model.named_parameters():
        # one rounding of the parameter (an ulp) and of the update
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=2 ** -23,
                                   atol=1e-3 * LR, err_msg=name)
    # (b) each tower against the JAX package
    assert_adam_update_follows(state.model.vidnet.named_parameters(prefix="vidnet"),
                               fullmodel_from_flax(numpy_variables(js)), before, LR)
    assert_adam_update_follows(state.model.audnet.named_parameters(prefix="audnet"),
                               eager_audio[1], before, LR)


def test_fused_step_with_view_1_s_flips_from_the_jax_key(host_state):
    jcfg, cfg = spec_cfgs()
    rng = np.random.RandomState(4)
    clips = rng.randint(0, 256, (B, T, IMG, IMG, 3), dtype=np.uint8)
    waves = np.clip(rng.randn(B, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    # a key whose draws flip one clip of two (so the flip is exercised both ways)
    key = jax.random.PRNGKey(3)
    flip1 = augment_draws_from_jax_key(key, B, IMG, IMG).flip1
    assert flip1.tolist() in ([True, False], [False, True]), flip1
    js, state = _states(host_state)
    js, mj = jsteps.train3d_fused_step(js, jnp.asarray(clips), jnp.asarray(waves), key, jcfg,
                                       IMG)
    mt = tsteps.train3d_fused_step(state, torch.from_numpy(clips), torch.from_numpy(waves),
                                   flip1, cfg)
    for k in TERMS:
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-4 * abs(float(mj[k])), k
    errs = _errors(js, state.model, "running")
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    # view 1 is the clip flipped where the draw says so, and nothing else
    view = augment_view1(torch.from_numpy(clips), flip1)
    for i, flipped in enumerate(flip1.tolist()):
        clip = torch.from_numpy(clips[i]).flip(-2) if flipped else torch.from_numpy(clips[i])
        torch.testing.assert_close(view[i], normalize_imagenet(clip), rtol=0, atol=0)


def test_three_free_running_steps_at_lr_1e_4_follow_the_jax_loss_curve(host_state):
    """Each package updates its own weights: eps-sized gradients whose sign
    float noise decides, and the jitted step's wrong audio gradient on the
    CPU, part them after the first update.  The loss curve is held to 5e-3
    as the flagship step's is (measured: 1.3e-3 after three steps).  The
    NP-ratio, a difference of heatmap sums between neighbouring frames, is
    held with the weights kept equal (1e-4, above), not here: free-running
    it parted by 7 % after three steps."""
    js, state = _states(host_state)
    rng = np.random.RandomState(5)
    for _ in range(3):
        js, mj, mt = _both_steps(js, state, _batch(rng))
        assert abs(mt["loss"] - mj["loss"]) <= 5e-3 * abs(mj["loss"]), (mt, mj)
        assert np.isfinite(mt["np_ratio"])
    assert state.step == int(js.step) == 3


# each trainer whose view-1 flips `train3d.draw_view1_flips` draws: its module,
# its fused step, the step's argument that takes the flips, the generator's
# seed offset, the flags of a 1-step run on the synthetic set and `run`'s options
FLIP_TRAINERS = {
    "1frame": ("hardway_1frame", "hardway_1frame_fused_step", 3, 3,
               ["--image_size", "64", "--samplerate", "8000", "--audio_seconds", "1",
                "--eval_batch_size", "3"], {"do_eval": False}),
    "tube3d": ("train3d", "train3d_fused_step", 3, 2,
               ["--image_size", "32", "--frame_density", "2", "--samplerate", "8000",
                "--audio_seconds", "1"], {"do_eval": False}),
    "flow": ("flow", "flow_fused_train_step", 4, 4,
             ["--image_size", "64", "--frame_density", "3", "--samplerate", "8000",
              "--audio_seconds", "1"], {"flow_loss_weight": 0.1}),
}


@pytest.mark.parametrize("kind", FLIP_TRAINERS)
def test_the_trainers_draw_each_step_s_flips_by_draw_view1_flips(kind, tmp_path, monkeypatch):
    """One call of `draw_view1_flips` a step, with the global batch, from
    the epoch's generator (`(seed + k) * 1_000_003 + epoch`); the fused
    step gets this rank's rows of that draw."""
    import importlib

    from avtubes_torch.core.config import ExperimentConfig
    from avtubes_torch.core.distributed import rows_of
    from avtubes_torch.train import train3d

    name, step_name, flips_at, offset, flags, options = FLIP_TRAINERS[kind]
    trainer = importlib.import_module(f"avtubes_torch.train.{name}")
    draws, stepped = [], []
    real_draw, real_step = train3d.draw_view1_flips, getattr(trainer, step_name)

    def draw(gen, batch):
        flips = real_draw(gen, batch)
        draws.append((gen.initial_seed(), batch, flips))
        return flips

    def step(*args, **kwargs):
        stepped.append(args[flips_at])
        return real_step(*args, **kwargs)

    monkeypatch.setattr(trainer, "draw_view1_flips", draw)
    monkeypatch.setattr(trainer, step_name, step)
    batch, seed = 2, 5
    cfg = ExperimentConfig.from_args(
        ["--synthetic", "--device", "cpu", "--compute_dtype", "float32", *flags,
         "--batch_size", str(batch), "--n_threads", "2", "--learning_rate", "1e-4",
         "--epochs", "1", "--steps", "1", "--seed", str(seed),
         "--summaries_dir", str(tmp_path)])
    trainer.run(cfg, steps_cap=1, **options)
    want_seed = (seed + offset) * 1_000_003 + 0
    assert [(s, b) for s, b, _ in draws] == [(want_seed, batch)]
    assert torch.equal(draws[0][2], torch.rand(batch, generator=torch.Generator().manual_seed(
        want_seed)) < 0.5)
    assert len(stepped) == 1 and torch.equal(stepped[0], draws[0][2][rows_of(batch)])
    for path in tmp_path.glob("*_ep*"):
        path.unlink()
