"""The flow pretrainer of the port against the JAX package: losses, the
numpy generators, the optimizer, a training trajectory, checkpoints, CLI."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avtubes.core.config import ExperimentConfig as JaxExperimentConfig
from avtubes.core.config import OptimConfig as JaxOptimConfig
from avtubes.models.flownet import FlowNetLite as JaxFlowNetLite
from avtubes.train import flow_pretrain as jfp
from avtubes.train.state import make_lr_schedule as jax_lr_schedule
from avtubes.train.state import make_optimizer as jax_make_optimizer
from avtubes_torch.cli import flow as flow_cli
from avtubes_torch.core.checkpoint import (
    PreemptionGuard,
    checkpoint_path,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from avtubes_torch.core.config import (
    DataConfig,
    ExperimentConfig,
    OptimConfig,
    TrainConfig,
)
from avtubes_torch.core.convert import flownet_from_flax
from avtubes_torch.models.flownet import FlowNetLite
from avtubes_torch.train import flow_pretrain as tfp
from avtubes_torch.train.state import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
)
from avtubes_torch.utils.logging import MetricLogger

torch.set_num_threads(2)


def _pairs(seed, batch=2, size=64):
    return jfp.translating_pairs(np.random.RandomState(seed), batch, size, max_shift=6)[:2]


# ------------------------------------------------------------------ losses

def test_charbonnier_and_smoothness_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 7, 3).astype(np.float32)
    flow = rng.randn(2, 9, 7, 2).astype(np.float32)
    image = rng.rand(2, 9, 7, 3).astype(np.float32)
    np.testing.assert_allclose(tfp.charbonnier(torch.from_numpy(x)).numpy(),
                               np.asarray(jfp.charbonnier(jnp.asarray(x))), atol=1e-6)
    for kwargs_j, kwargs_t in (
            ({}, {}),
            ({"image": jnp.asarray(image), "edge_alpha": 10.0},
             {"image": torch.from_numpy(image), "edge_alpha": 10.0}),
            ({"image": jnp.asarray(image), "edge_alpha": 0.0},
             {"image": torch.from_numpy(image), "edge_alpha": 0.0})):
        want = float(jfp.smoothness_loss(jnp.asarray(flow), **kwargs_j))
        got = float(tfp.smoothness_loss(torch.from_numpy(flow), **kwargs_t))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("h,w", [(64, 64), (52, 76)])
def test_resize_linear_is_jax_image_resize_antialias_included(h, w):
    x = np.random.RandomState(1).rand(2, h, w, 3).astype(np.float32)
    for s in (2, 4, 8):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, h // s, w // s, 3), "linear"))
        got = tfp.resize_linear(torch.from_numpy(x), h // s, w // s).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    # plain bilinear is NOT what the JAX package computes when it shrinks
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(h // 4, w // 4), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, h // 4, w // 4, 3), "linear"))
    assert np.abs(plain - want).max() > 1e-2


@pytest.mark.parametrize("h,w", [(64, 64), (52, 76)])
def test_multiscale_photometric_value_and_flow_gradient(h, w):
    rng = np.random.RandomState(2)
    im1 = rng.rand(2, h, w, 3).astype(np.float32)
    im2 = np.roll(im1, (2, -3), axis=(1, 2))
    flow = (rng.randn(2, h, w, 2) * 2).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda f: jfp.multiscale_photometric(jnp.asarray(im1), jnp.asarray(im2), f))(
            jnp.asarray(flow))
    tf = torch.from_numpy(flow).requires_grad_()
    got = tfp.multiscale_photometric(torch.from_numpy(im1), torch.from_numpy(im2), tf)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    scale = float(np.abs(np.asarray(want_g)).max())
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_g), atol=1e-3 * scale)


# -------------------------------------------------------------- generators

def test_numpy_generators_draw_the_same_arrays():
    for size in (32, 64):
        np.testing.assert_array_equal(
            tfp.smooth_pattern(np.random.RandomState(3), size),
            jfp.smooth_pattern(np.random.RandomState(3), size))
        for a, b in zip(tfp.translating_pairs(np.random.RandomState(4), 3, size),
                        jfp.translating_pairs(np.random.RandomState(4), 3, size)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tfp._affine_field(np.random.RandomState(5), size),
            jfp._affine_field(np.random.RandomState(5), size))
        np.testing.assert_array_equal(
            tfp._two_object_field(np.random.RandomState(6), size),
            jfp._two_object_field(np.random.RandomState(6), size))


@pytest.mark.parametrize("kind", ["affine", "two_object"])
def test_warped_pairs_and_epe_match(kind):
    got = tfp.warped_pairs(np.random.RandomState(7), 2, 48, kind=kind)
    want = jfp.warped_pairs(np.random.RandomState(7), 2, 48, kind=kind)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)   # through each package's flow_warp
    np.testing.assert_array_equal(got[2], want[2])
    assert tfp.epe(np.zeros_like(got[2]), got[2]) == jfp.epe(np.zeros_like(want[2]), want[2])


def test_synthetic_batches_follow_the_same_order_of_draws():
    cfg_t = ExperimentConfig(data=DataConfig(synthetic=True, image_size=32),
                             optim=OptimConfig(batch_size=2), train=TrainConfig(seed=3))
    cfg_j = JaxExperimentConfig.from_args(["--synthetic", "--image_size", "32",
                                           "--batch_size", "2", "--seed", "3"])
    for (a1, a2), (b1, b2) in zip(tfp._synthetic_pair_batches(cfg_t, 1, 4),
                                  jfp._synthetic_pair_batches(cfg_j, 1, 4)):
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_allclose(a2, b2, atol=1e-6)


# --------------------------------------------------------------- optimizer

def test_lr_schedule_is_piecewise_constant_like_optax():
    cfg_t = OptimConfig(learning_rate=3e-3, lr_milestones=(2, 5, 9), lr_gamma=0.1)
    cfg_j = JaxOptimConfig(learning_rate=3e-3, lr_milestones=(2, 5, 9), lr_gamma=0.1)
    for steps_per_epoch in (1, 3):
        want = jax_lr_schedule(cfg_j, steps_per_epoch)
        got = make_lr_schedule(cfg_t, steps_per_epoch)
        for step in range(0, 32):
            assert abs(cfg_t.learning_rate * got(step) - float(want(step))) <= 1e-9, step


def test_adam_with_coupled_decay_and_milestones_matches_optax():
    rng = np.random.RandomState(8)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = rng.randn(8, 5, 3).astype(np.float32)
    cfg_kwargs = dict(learning_rate=1e-2, weight_decay=1e-2, lr_milestones=(3, 6), lr_gamma=0.5)
    tx = jax_make_optimizer(JaxOptimConfig(**cfg_kwargs), 1)
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    optimizer, scheduler = make_optimizer([w], OptimConfig(**cfg_kwargs), 1)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g.copy())
        optimizer.step()
        scheduler.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), atol=2e-6)


# -------------------------------------------------------------- trajectory

def test_five_training_steps_follow_the_jax_trajectory():
    # at the pretrainer's own learning rate.  Adam's first updates are
    # lr * g / (|g| + 1e-8): where a gradient is of the size of eps, float32
    # noise in it moves the weight by a good part of lr in either package, so
    # the two trajectories part at a rate set by lr (at 1e-3 the losses differ
    # by 1.5e-3 after five steps, with first-step gradients equal to 1e-7)
    lr = 1e-4
    state_j = jfp.create_flow_state(jax.random.PRNGKey(0), 64, learning_rate=lr)
    model = FlowNetLite(generator=torch.Generator().manual_seed(1))
    model.load_state_dict(flownet_from_flax(jax.device_get(state_j.params)), strict=True)
    cfg = dataclasses.replace(OptimConfig(), learning_rate=lr, weight_decay=0.0,
                              lr_milestones=())
    state_t = create_train_state(model, cfg)
    batches = [_pairs(10 + i) for i in range(5)]
    losses_j, losses_t = [], []
    for im1, im2 in batches:
        state_j, mj = jfp.flow_pretrain_step(state_j, jnp.asarray(im1), jnp.asarray(im2))
        mt = tfp.flow_pretrain_step(state_t, torch.from_numpy(im1), torch.from_numpy(im2))
        assert set(mt) == set(mj) == {"loss", "photometric", "smoothness"}
        losses_j.append([float(mj[k]) for k in sorted(mj)])
        losses_t.append([float(mt[k]) for k in sorted(mt)])
    assert state_t.step == int(state_j.step) == 5
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    p1, p2 = _pairs(99)
    want = np.asarray(JaxFlowNetLite().apply({"params": state_j.params},
                                             jnp.asarray(p1), jnp.asarray(p2)))
    with torch.no_grad():
        got = state_t.model(torch.from_numpy(p1), torch.from_numpy(p2)).numpy()
    # 0.01 px on flows of several px, after the drift described above
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=1e-2)


# ------------------------------------------------------- run, checkpoints

def _cfg(tmp_path, **train):
    return ExperimentConfig(
        data=DataConfig(synthetic=True, image_size=32),
        optim=OptimConfig(batch_size=2, epochs=1),
        train=TrainConfig(summaries_dir=str(tmp_path), log_every=1, device="cpu", **train))


def test_run_pretrain_writes_a_checkpoint_that_restores(tmp_path):
    metrics = tfp.run_pretrain(_cfg(tmp_path), steps_cap=2)
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["epe_affine"])
    path = checkpoint_path(tmp_path, "flownet", 0)
    assert path.is_file() and latest_checkpoint(tmp_path, "flownet") == path
    records = [json.loads(line) for line in (tmp_path / "flownet.metrics.jsonl").open()]
    assert [r["step"] for r in records if "loss" in r] == [1, 2]

    fresh = tfp.create_flow_state(torch.Generator().manual_seed(123), device="cpu")
    restored, epoch = restore_checkpoint(path, fresh)
    assert epoch == 0 and restored.step == 2
    saved = torch.load(path, weights_only=True)
    assert set(saved) == {"params", "opt_state", "step", "epoch"}
    for name, value in restored.model.state_dict().items():
        assert torch.equal(value, saved["params"][name]), name
    moments = restored.optimizer.state_dict()["state"]
    assert len(moments) == len(list(restored.model.parameters()))
    assert float(moments[0]["step"]) == 2.0
    # the restored net gives the same flow as the one that was saved
    again = tfp.create_flow_state(torch.Generator().manual_seed(5), device="cpu")
    restore_checkpoint(path, again)
    p1, p2 = (torch.from_numpy(a) for a in _pairs(11, size=32))
    with torch.no_grad():
        assert torch.equal(restored.model(p1, p2), again.model(p1, p2))

    # --use_pretrained resumes after the last finished epoch: nothing left to do
    assert tfp.run_pretrain(_cfg(tmp_path, use_pretrained=True), steps_cap=2) == {}
    # and a later epoch lands beside it; a stray temporary file is no checkpoint
    save_checkpoint(tmp_path, "flownet", 3, restored)
    (tmp_path / "flownet_ep9.tmp77").write_bytes(b"")
    assert latest_checkpoint(tmp_path, "flownet") == checkpoint_path(tmp_path, "flownet", 3)
    assert latest_checkpoint(tmp_path / "nowhere", "flownet") is None


def test_restore_is_strict_about_names(tmp_path):
    state = tfp.create_flow_state(torch.Generator().manual_seed(0), device="cpu")
    path = save_checkpoint(tmp_path, "flownet", 0, state)
    payload = torch.load(path, weights_only=True)
    payload["params"].pop("corr_temp")
    torch.save(payload, path)
    with pytest.raises(RuntimeError, match="corr_temp"):
        restore_checkpoint(path, state)


def test_what_is_not_ported_raises(tmp_path, capsys):
    """What this test once held to raise is ported now, and runs on the CPU:
    the pretrainer on real clip pairs (`_clip_pair_batches`, over the
    on-disk synthetic dataset) and the flow-consistency trainer through the
    CLI with `--flow_loss_weight` and with `--no_flow`."""
    from avtubes_torch.data.synthetic import write_synthetic_dataset

    data = tmp_path / "data"
    write_synthetic_dataset(data, n_videos=2, frames=3, samplerate=8000, seconds=1,
                            image_hw=(40, 40))
    real = ExperimentConfig.from_args(
        ["--data_path", str(data), "--metadata_dir", str(data / "metadata"), "--image_size",
         "32", "--frame_density", "3", "--batch_size", "2", "--samplerate", "8000",
         "--audio_seconds", "1", "--epochs", "1", "--device", "cpu", "--n_threads", "2",
         "--summaries_dir", str(tmp_path / "pretrain")])
    metrics = tfp.run_pretrain(real, steps_cap=1)
    assert np.isfinite(metrics["loss"]) and (tmp_path / "pretrain" / "flownet_ep0").is_file()
    consistency = ["--synthetic", "--device", "cpu", "--image_size", "32", "--frame_density",
                   "2", "--batch_size", "2", "--samplerate", "8000", "--audio_seconds", "1",
                   "--compute_dtype", "float32", "--epochs", "1", "--steps", "1",
                   "--n_threads", "2"]
    final = flow_cli.main([*consistency, "--summaries_dir", str(tmp_path / "on"),
                           "--flow_loss_weight", "0.1"])
    assert np.isfinite(final["loss"]) and final["warp_consistency"] > 0
    final = flow_cli.main([*consistency, "--summaries_dir", str(tmp_path / "off"), "--no_flow"])
    assert final["warp_consistency"] == 0.0
    assert capsys.readouterr().out.count("final:") == 2
    for run in ("on", "off"):
        assert (tmp_path / run / "flow_ep0").is_file()
        (tmp_path / run / "flow_ep0").unlink()


def test_cli_train_flow_on_the_cpu(tmp_path, capsys):
    metrics = flow_cli.main(["--train_flow", "--synthetic", "--image_size", "32",
                             "--batch_size", "2", "--epochs", "1", "--steps", "1",
                             "--summaries_dir", str(tmp_path), "--device", "cpu",
                             "--flow_loss_weight", "0.5", "--no_flow"])
    assert np.isfinite(metrics["loss"])
    assert (tmp_path / "flownet_ep0").is_file()
    assert "final:" in capsys.readouterr().out


def test_config_tree_parses_flag_for_flag_like_the_jax_package():
    argv = ["--testset", "vggss", "--image_size", "96", "--batch_size", "6",
            "--learning_rate", "1e-3", "--weight_decay", "0.0", "--epochs", "3",
            "--frame_density", "4", "--use_pretrained", "--pretrained_path", "x",
            "--seed", "7", "--compute_dtype", "float32", "--synthetic", "--steps", "5",
            "--remat", "--audio_transport", "float32", "--jitter_order", "fixed",
            "--conv3d_impl", "sum", "--epsilon", "0.5", "--summaries_dir", "out/"]
    want = dataclasses.asdict(JaxExperimentConfig.from_args(argv))
    got = dataclasses.asdict(ExperimentConfig.from_args(argv))
    assert got["train"].pop("device") == "cuda"
    assert got["train"].pop("video_arch") == "r3d18"      # the port's own tube encoders
    assert got == want
    assert ExperimentConfig.from_args(["--device", "cpu"]).train.device == "cpu"
    assert ExperimentConfig.from_args(
        ["--video_arch", "timesformer_b16"]).train.video_arch == "timesformer_b16"
    assert dataclasses.asdict(ExperimentConfig())["data"] == \
        dataclasses.asdict(JaxExperimentConfig())["data"]


def test_metric_logger_and_preemption_guard(tmp_path, capsys):
    logger = MetricLogger(tmp_path, run_name="run")
    logger.log(step=3, loss=torch.tensor(0.5), note="x")
    logger.close()
    record = json.loads((tmp_path / "run.metrics.jsonl").read_text())
    assert record["step"] == 3 and record["loss"] == 0.5 and record["note"] == "x"
    assert "[metrics]" in capsys.readouterr().out
    silent = MetricLogger(tmp_path, run_name="off", enabled=False)
    silent.log(step=1, loss=1.0)
    assert not (tmp_path / "off.metrics.jsonl").exists()

    guard = PreemptionGuard()
    try:
        assert not guard.preempted
        guard._handler(15, None)
        assert guard.preempted
    finally:
        guard.restore()
