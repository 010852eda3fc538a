"""`--remat` in the port: each backbone call a checkpoint segment
(`avtubes_torch/models/remat.py`).

A remat step is the plain step: for the flagship two-view step, the 1-frame
step, the consistency step and the 3D step, the loss, every gradient and
every parameter after the update agree with the plain step's within 1e-6
relative in float32 (they come out bit-equal on the CPU), and every BatchNorm
running statistic and batch count is bit-equal, although the backward pass
runs each backbone's forward again in training mode.  The port's remat
steps meet the JAX package's `AVENet(remat=True)` / `FullModel(remat=True)`
on the same weights at the bars of the plain steps' tests: the terms and
statistics at 1e-4, the image and video towers' updates against the jitted
JAX step, and the audio tower's gradient against the EAGER JAX gradient of
the remat model (jax 0.9.0's jitted audio gradient is wrong on the CPU:
ROADMAP host facts).  The 3D audio tower is held through the plain step:
its remat gradient equals the plain one on the CPU, which
`test_torch_port_train3d.py` holds to the eager JAX gradient.  The
trainers' CLIs take `--remat` on the CPU and write the plain model's
`state_dict` keys."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.config import ExperimentConfig as JaxExperimentConfig
from avtubes.core.config import OptimConfig as JaxOptimConfig
from avtubes.losses import hardway_loss as jax_hardway_loss
from avtubes.models import AVENet as JaxAVENet
from avtubes.models import FullModel as JaxFullModel
from avtubes.models.hardway import hardway_head as jax_hardway_head
from avtubes.train import steps as jsteps
from avtubes_torch.cli import flow as flow_cli
from avtubes_torch.cli import train_hardway as train_hardway_cli
from avtubes_torch.core.config import ExperimentConfig, OptimConfig
from avtubes_torch.core.convert import avenet_from_flax, fullmodel_from_flax
from avtubes_torch.models import remat as remat_mod
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.models.flownet import FlowNetLite
from avtubes_torch.models.fullmodel import FullModel
from avtubes_torch.train import flow, hardway_1frame, train3d
from avtubes_torch.train import steps as tsteps
from avtubes_torch.train.state import create_train_state
from test_torch_port_train_step import JAX_TX, LR, _states
from torch_port_util import (
    IMG,
    assert_adam_update_follows,
    assert_relative_by_tensor,
    chained_eager_audio_update,
    jax_fullmodel_state,
    jax_state,
    numpy_variables,
    port_fullmodel,
    spec_cfgs,
)

torch.set_num_threads(2)
RTOL = 1e-6          # remat against plain, float32: the same operations in the same order
B, T = 2, 2
SMALL = ["--synthetic", "--image_size", "64", "--batch_size", "2", "--frame_density", "2",
         "--samplerate", "8000", "--audio_seconds", "1", "--n_threads", "2",
         "--compute_dtype", "float32", "--epochs", "1", "--steps", "1", "--eval_batch_size", "4"]
HARDWAY = JaxExperimentConfig().hardway


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    yield
    for path in tmp_path.rglob("*_ep*"):
        path.unlink()


def _clips(rng, b=B, t=T, seconds=1):
    _, cfg = spec_cfgs(seconds)
    return (rng.randn(b, t, IMG, IMG, 3).astype(np.float32),
            rng.randn(b, *cfg.shape, 1).astype(np.float32))


# ------------------------------------------------- remat against plain, in the port

def _two_view(state, rng, seconds=1):
    frames, spec = _clips(rng, seconds=seconds)
    augmented = frames + 0.1 * rng.randn(*frames.shape).astype(np.float32)
    return tsteps.hardway_train_step(state, *(torch.from_numpy(a)
                                              for a in (frames, augmented, spec)))


def _one_frame(state, rng):
    frames, spec = _clips(rng, t=1)
    return tsteps.hardway_1frame_train_step(state, torch.from_numpy(frames[:, 0]),
                                            torch.from_numpy(spec))


def _consistency(state, rng):
    frames, spec = _clips(rng, t=3)
    net = FlowNetLite(generator=torch.Generator().manual_seed(7)).eval()
    return flow.flow_train_step(state, net, torch.from_numpy(frames), torch.from_numpy(spec),
                                flow_loss_weight=0.5)


def _tube(state, rng):
    video, spec = _clips(rng)
    return tsteps.train3d_step(state, torch.from_numpy(video), torch.from_numpy(spec))


STEPS = {"two_view": (AVENet, _two_view), "one_frame": (AVENet, _one_frame),
         "consistency": (AVENet, _consistency), "tube3d": (FullModel, _tube)}


def _run(model_cls, step, remat: bool, compute_dtype: str = "float32"):
    """One step from seeded weights: (metrics, gradients, state_dict after)."""
    model = model_cls(generator=torch.Generator().manual_seed(0), compute_dtype=compute_dtype,
                      remat=remat)
    state = create_train_state(model, OptimConfig(learning_rate=LR), 4)
    metrics = step(state, np.random.RandomState(5))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {k: v.clone() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("name", sorted(STEPS))
def test_a_remat_step_is_the_plain_step(name, monkeypatch):
    segments = []
    real = remat_mod.checkpoint
    monkeypatch.setattr(remat_mod, "checkpoint",
                        lambda fn, *a, **k: segments.append(fn) or real(fn, *a, **k))
    model_cls, step = STEPS[name]
    plain = _run(model_cls, step, remat=False)
    assert not segments
    got = _run(model_cls, step, remat=True)
    # one segment a backbone call: two image calls and one audio call in the
    # two-view step, one of each elsewhere
    assert len(segments) == (3 if name == "two_view" else 2), len(segments)
    for k, v in plain[0].items():
        assert abs(got[0][k] - v) <= RTOL * abs(v), (k, got[0][k], v)
    assert got[1].keys() == plain[1].keys()
    assert_relative_by_tensor(got[1], plain[1], RTOL)
    assert got[2].keys() == plain[2].keys()
    stats = [k for k in plain[2] if "running" in k or "num_batches" in k]
    assert stats
    for k in stats:
        assert torch.equal(got[2][k], plain[2][k]), k
    params = {k: got[2][k] for k in plain[1]}
    assert_relative_by_tensor(params, {k: plain[2][k] for k in plain[1]}, RTOL)


def test_a_bf16_remat_step_is_the_plain_bf16_step():
    """In bfloat16 too: the statistics bit-equal, and the loss and gradients
    of the two-view step the plain step's (the recomputation takes each
    BatchNorm's forward code path again).  The spectrograms are 8 kHz x 2 s
    (257x30): at 257x15 the CPU's bf16 stride-2 convolution is wrong
    (ROADMAP host facts)."""
    def step(state, rng):
        return _two_view(state, rng, seconds=2)

    plain = _run(AVENet, step, remat=False, compute_dtype="bfloat16")
    got = _run(AVENet, step, remat=True, compute_dtype="bfloat16")
    assert np.isfinite(list(plain[0].values())).all()
    assert got[0] == plain[0]
    assert_relative_by_tensor(got[1], plain[1], RTOL)
    for k in plain[2]:
        if "running" in k or "num_batches" in k:
            assert torch.equal(got[2][k], plain[2][k]), k


def test_the_recomputation_leaves_every_statistic_as_the_forward_left_it():
    """The forward advances each BatchNorm once per call (the image tower
    twice in the two-view step, the audio tower once and then once more in
    closed form); the backward's recomputation advances nothing and
    restores each layer's momentum and batch count object."""
    model = AVENet(generator=torch.Generator().manual_seed(0), remat=True).train()
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    counts = [bn.num_batches_tracked for bn in bns]
    frames, spec = _clips(np.random.RandomState(6))
    out, out2 = model.two_view_forward(torch.from_numpy(frames.reshape(B * T, IMG, IMG, 3)),
                                       torch.from_numpy(frames.reshape(B * T, IMG, IMG, 3)),
                                       torch.from_numpy(spec), T)
    after_forward = {k: v.clone() for k, v in model.state_dict().items()}
    (out.logits.sum() + out2.weighted_map.sum()).backward()
    for k, v in model.state_dict().items():
        assert torch.equal(v, after_forward[k]), k
    assert int(model.imgnet.bn1.num_batches_tracked) == 2
    assert int(model.audnet.bn1.num_batches_tracked) == 1
    assert all(bn.momentum == 0.1 for bn in bns)
    assert all(bn.num_batches_tracked is c for bn, c in zip(bns, counts))


def test_no_segment_in_eval_mode_or_without_grad(monkeypatch):
    segments = []
    real = remat_mod.checkpoint
    monkeypatch.setattr(remat_mod, "checkpoint",
                        lambda fn, *a, **k: segments.append(fn) or real(fn, *a, **k))
    model = AVENet(generator=torch.Generator().manual_seed(0), remat=True)
    plain = AVENet(generator=torch.Generator().manual_seed(0))
    frames, spec = _clips(np.random.RandomState(7), t=1)
    x = (torch.from_numpy(frames[:, 0]), torch.from_numpy(spec))
    assert torch.equal(model.eval()(*x).heatmap, plain.eval()(*x).heatmap)
    with torch.no_grad():
        assert torch.equal(model.train()(*x).heatmap, plain.train()(*x).heatmap)
    assert not segments
    for k, v in plain.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert model.state_dict().keys() == plain.state_dict().keys()


# ------------------------------------------------- against the JAX package's remat

@pytest.fixture(scope="module")
def host_state():
    """`test_torch_port_train_step.py`'s JAX AVENet state at lr 1e-4, on the
    host (its weights keep the image tower's Adam update within the bar of
    `assert_adam_update_follows`: Adam's first update is lr * sign(g), and
    other weights put more gradients within float noise of 0)."""
    js = jax_state(0)
    return jax.device_get(js.replace(tx=JAX_TX, opt_state=JAX_TX.init(js.params)))


def _remat_states(host):
    """(the JAX state whose model is `AVENet(remat=True)`, the port's
    TrainState with the same weights and remat on)."""
    js, state = _states(host)
    state.model.remat = True
    return js.replace(apply_fn=JaxAVENet(hardway=HARDWAY, remat=True).apply), state


def _stats_errors(js, model, convert) -> dict[str, float]:
    want = convert(numpy_variables(js))
    got = model.state_dict()
    return {k: float((got[k] - v).abs().max() / v.abs().max())
            for k, v in want.items() if "running" in k}


def test_the_two_view_remat_step_matches_the_jax_package_s(host_state):
    js, state = _remat_states(host_state)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    rng = np.random.RandomState(1)
    frames, spec = _clips(rng)
    augmented = frames + 0.1 * rng.randn(*frames.shape).astype(np.float32)
    batch = (frames, augmented, spec)
    js, mj = jsteps.hardway_train_step(js, *(jnp.asarray(a) for a in batch), 0.1)
    mt = tsteps.hardway_train_step(state, *(torch.from_numpy(a) for a in batch), 0.1)
    assert set(mt) == set(mj)
    for k in mj:
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-4 * abs(float(mj[k])), k
    errs = _stats_errors(js, state.model, avenet_from_flax)
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    assert int(state.model.imgnet.bn1.num_batches_tracked) == 2
    assert int(state.model.audnet.layer1[0].bn1.num_batches_tracked) == 2
    assert_adam_update_follows(state.model.imgnet.named_parameters(prefix="imgnet"),
                               avenet_from_flax(numpy_variables(js)), before, LR)


def test_the_audio_gradient_of_a_remat_step_is_the_eager_jax_gradient(host_state):
    """The 1-frame step's audio tower under remat against the JAX package's
    eager gradient of `AVENet(remat=True)`, by tensor (1e-4 of a tensor's
    largest entry, the plain step's bar): the remat audio tower pulled back
    eagerly, the head and loss on the jitted image features
    (`chained_eager_audio_update`)."""
    js, state = _remat_states(host_state)
    frames, spec = _clips(np.random.RandomState(2), t=1)
    frames = frames[:, 0]
    variables = {"params": js.params, "batch_stats": js.batch_stats}
    img = jax.jit(lambda v, f: js.apply_fn(v, f, train=True, mutable=["batch_stats"],
                                           method="encode_image")[0])(variables,
                                                                      jnp.asarray(frames))

    def loss_of_audio_features(feats, img):
        return jax_hardway_loss(jax_hardway_head(img, feats, HARDWAY).logits)

    eager_grads, _ = chained_eager_audio_update(js, jnp.asarray(spec), loss_of_audio_features,
                                                avenet_from_flax, img)
    tsteps.hardway_1frame_train_step(state, torch.from_numpy(frames), torch.from_numpy(spec))
    got = {n: p.grad for n, p in state.model.audnet.named_parameters(prefix="audnet")}
    assert_relative_by_tensor(got, eager_grads, 1e-4)


def test_the_3d_remat_step_matches_the_jax_package_s():
    host = jax.device_get(jax_fullmodel_state(0, JaxOptimConfig(learning_rate=LR)))
    js = jax.tree_util.tree_map(jnp.asarray, host)
    js = js.replace(apply_fn=JaxFullModel(hardway=HARDWAY, remat=True).apply)
    model = port_fullmodel(js).train()
    model.remat = True
    state = create_train_state(model, dataclasses.replace(OptimConfig(), learning_rate=LR), 4)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = _clips(np.random.RandomState(3))
    js, mj = jsteps.train3d_step(js, *(jnp.asarray(a) for a in batch))
    mt = tsteps.train3d_step(state, *(torch.from_numpy(a) for a in batch))
    for k in ("loss", "np_ratio"):
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-4 * abs(float(mj[k])), k
    errs = _stats_errors(js, model, fullmodel_from_flax)
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    assert int(model.vidnet.bn1.num_batches_tracked) == int(model.audnet.bn1.num_batches_tracked) == 1
    assert_adam_update_follows(model.vidnet.named_parameters(prefix="vidnet"),
                               fullmodel_from_flax(numpy_variables(js)), before, LR)


# ------------------------------------------------------------------- the CLIs

def test_cli_train_hardway_remat_trains_one_step_on_the_cpu(tmp_path, monkeypatch):
    segments = []
    real = remat_mod.checkpoint
    monkeypatch.setattr(remat_mod, "checkpoint",
                        lambda fn, *a, **k: segments.append(fn) or real(fn, *a, **k))
    final = train_hardway_cli.main([*SMALL, "--device", "cpu", "--remat",
                                    "--summaries_dir", str(tmp_path)])
    assert np.isfinite(final["loss"]) and final["hardway_n"] == 8
    assert len(segments) == 3        # one step: two image segments, one audio
    saved = torch.load(tmp_path / "hardway16_ep0", weights_only=True)["params"]
    assert saved.keys() == AVENet().state_dict().keys()


def _run_1frame(argv):
    return hardway_1frame.run(ExperimentConfig.from_args(argv), steps_cap=1, do_eval=False)


def _run_3d(argv):
    return train3d.run(ExperimentConfig.from_args(argv), steps_cap=1, do_eval=False)


def _run_flow(argv):
    return flow_cli.main([*argv, "--flow_loss_weight", "0.1"])


@pytest.mark.parametrize("run", [_run_1frame, _run_flow, _run_3d], ids=["1frame", "flow", "3d"])
def test_every_trainer_takes_remat(run, tmp_path, monkeypatch):
    """The flag reaches the 1-frame, consistency and 3D trainers through
    their `build_model`: one step runs its two backbone calls as segments."""
    segments = []
    real = remat_mod.checkpoint
    monkeypatch.setattr(remat_mod, "checkpoint",
                        lambda fn, *a, **k: segments.append(fn) or real(fn, *a, **k))
    final = run([*SMALL, "--device", "cpu", "--remat", "--summaries_dir", str(tmp_path)])
    assert np.isfinite(final["loss"])
    assert len(segments) == 2
