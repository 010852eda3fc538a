"""The flow-guided consistency trainer of the port and its CLI
(`train/flow.py::run`, `cli/flow.py`): with the flow and without, the
pretrainer's `flownet_ep<N>` auto-loaded, the warm start from a `.pth.tar`
written by `cli/export_torch`, the resume from `flow_ep<N>` and the
preemption save; and the pretrainer on real clip pairs
(`flow_pretrain.py::_clip_pair_batches`, bit-equal to the JAX package's).
The step itself is held against the JAX package's in
`test_torch_port_flow_consistency.py`."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from avtubes import native
from avtubes.core.config import ExperimentConfig as JaxExperimentConfig
from avtubes.train import flow_pretrain as jfp
from avtubes_torch.cli import export_torch
from avtubes_torch.cli import flow as flow_cli
from avtubes_torch.core.checkpoint import latest_checkpoint, save_checkpoint
from avtubes_torch.core.config import ExperimentConfig, OptimConfig
from avtubes_torch.data.synthetic import write_synthetic_dataset
from avtubes_torch.train import flow as tflow
from avtubes_torch.train import flow_pretrain as tfp
from avtubes_torch.train.state import create_train_state
from torch_port_util import IMG, jax_avenet_state, port_model

torch.set_num_threads(2)
B, T = 2, 3
WEIGHT = 0.1
TERMS = ("loss", "hardway_loss", "warp_consistency")
SMALL = ["--synthetic", "--device", "cpu", "--compute_dtype", "float32", "--image_size",
         str(IMG), "--frame_density", str(T), "--batch_size", str(B), "--samplerate", "8000",
         "--audio_seconds", "1", "--n_threads", "2", "--learning_rate", "1e-4"]


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A trainer's checkpoints and exports (up to a hundred MB each) are
    removed after each test: the suite keeps its temporary directories."""
    yield
    for pattern in ("*_ep*", "*.pth.tar"):
        for path in tmp_path.rglob(pattern):
            path.unlink()


# ------------------------------------------------------------ trainer and CLI

def _records(path) -> list[dict]:
    return [json.loads(line) for line in path.open()]


def test_the_cli_trains_with_the_flow_and_without(tmp_path, capsys):
    final = flow_cli.main([*SMALL, "--epochs", "1", "--steps", "2", "--summaries_dir",
                           str(tmp_path / "on"), "--flow_loss_weight", "0.1"])
    out = capsys.readouterr().out
    assert set(final) == set(TERMS) and final["warp_consistency"] > 0
    assert np.isfinite(list(final.values())).all()
    assert "WARNING: flow_loss_weight > 0 with a random-init flow net" in out
    assert "final:" in out
    assert latest_checkpoint(tmp_path / "on", "flow").name == "flow_ep0"
    assert [r["step"] for r in _records(tmp_path / "on" / "flow.metrics.jsonl")
            if "loss" in r] == [1, 2]
    final = flow_cli.main([*SMALL, "--epochs", "1", "--steps", "1", "--summaries_dir",
                           str(tmp_path / "off"), "--no_flow"])
    out = capsys.readouterr().out
    assert final["warp_consistency"] == 0.0 and "'warp_consistency': 0.0" in out
    assert "WARNING" not in out


def test_a_weight_without_the_flow_raises_before_anything_is_written(tmp_path):
    with pytest.raises(ValueError, match="compute_flow"):
        flow_cli.main([*SMALL, "--summaries_dir", str(tmp_path), "--flow_loss_weight", "0.1",
                       "--no_flow"])
    assert not list(tmp_path.iterdir())


def test_the_pretrainer_s_flow_net_is_loaded_and_stays_frozen(tmp_path, capsys, monkeypatch):
    """`flownet_ep<N>` of a port pretrainer run in the same summaries dir is
    loaded into the flow net; `flow_ep<N>` and `flownet_ep<N>` are told apart."""
    cfg = ExperimentConfig.from_args([*SMALL, "--epochs", "1", "--summaries_dir",
                                      str(tmp_path)])
    tfp.run_pretrain(cfg, steps_cap=1)
    saved = torch.load(tmp_path / "flownet_ep0", weights_only=True)["params"]
    seen = []
    real = tflow.flow_fused_train_step

    def spy(state, flow_net, *args, **kwargs):
        seen.append(flow_net)
        return real(state, flow_net, *args, **kwargs)

    monkeypatch.setattr(tflow, "flow_fused_train_step", spy)
    tflow.run(cfg, steps_cap=2, flow_loss_weight=WEIGHT)
    assert "[flow] loaded pretrained flow net" in capsys.readouterr().out
    assert len(seen) == 2 and seen[0] is seen[1]
    for k, v in seen[0].state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert latest_checkpoint(tmp_path, "flow").name == "flow_ep0"
    assert latest_checkpoint(tmp_path, "flownet").name == "flownet_ep0"
    save_checkpoint(tmp_path, "flownet", 3, create_train_state(seen[0], OptimConfig()))
    assert latest_checkpoint(tmp_path, "flow").name == "flow_ep0"


def test_warm_start_from_export_torch_then_resume(tmp_path, capsys, monkeypatch):
    """`cli/export_torch` writes the `.pth.tar` that `--use_pretrained
    --pretrained_path` warm-starts AVENet from; a `flow_ep<N>` resumes."""
    model = port_model(jax_avenet_state(0))
    save_checkpoint(tmp_path / "hw", "hardway16", 0, create_train_state(model, OptimConfig()))
    ref = tmp_path / "hw.pth.tar"
    export_torch.main(["--device", "cpu", "--summaries_dir", str(tmp_path / "hw"), "--out",
                       str(ref)])
    seen = []
    real = tflow.flow_fused_train_step

    def spy(state, *args, **kwargs):
        if not seen:
            seen.append({k: v.clone() for k, v in state.model.state_dict().items()})
        return real(state, *args, **kwargs)

    monkeypatch.setattr(tflow, "flow_fused_train_step", spy)
    run_dir = str(tmp_path / "run")
    flow_cli.main([*SMALL, "--epochs", "1", "--steps", "2", "--summaries_dir", run_dir,
                   "--use_pretrained", "--pretrained_path", str(ref)])
    assert "warm-started from reference checkpoint" in capsys.readouterr().out
    for k, v in model.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(seen[0][k], v), k
    flow_cli.main([*SMALL, "--epochs", "2", "--steps", "2", "--summaries_dir", run_dir,
                   "--use_pretrained"])
    assert "resumed from" in capsys.readouterr().out
    steps = [r["step"] for r in _records(tmp_path / "run" / "flow.metrics.jsonl") if "loss" in r]
    assert steps == [1, 2, 3, 4]
    assert latest_checkpoint(run_dir, "flow").name == "flow_ep1"


def test_a_preempted_epoch_is_saved_under_the_previous_number(tmp_path, monkeypatch):
    class Preempted(tflow.PreemptionGuard):
        def __init__(self):
            super().__init__()
            self.preempted = True            # the signal arrives during the first step

    monkeypatch.setattr(tflow, "PreemptionGuard", Preempted)
    cfg = ExperimentConfig.from_args([*SMALL, "--epochs", "2", "--summaries_dir",
                                      str(tmp_path)])
    final = tflow.run(cfg, steps_cap=2)
    assert np.isfinite(final["loss"])
    assert sorted(p.name for p in tmp_path.glob("flow_ep*")) == ["flow_ep-1"]
    assert torch.load(tmp_path / "flow_ep-1", weights_only=True)["step"] == 1


# ------------------------------------------------------- pretraining on clips

@pytest.fixture
def dataset(tmp_path, monkeypatch):
    """The on-disk synthetic dataset, read by the JAX package through PIL
    and numpy (the port has no native decoder)."""
    monkeypatch.setattr(native, "available", lambda: False)
    root = tmp_path / "data"
    write_synthetic_dataset(root, n_videos=3, frames=T, samplerate=8000, seconds=1,
                            image_hw=(72, 80))
    return ["--data_path", str(root), "--metadata_dir", str(root / "metadata"),
            "--image_size", str(IMG), "--frame_density", str(T), "--batch_size", "2",
            "--samplerate", "8000", "--audio_seconds", "1", "--n_threads", "2",
            "--summaries_dir", str(tmp_path / "ckpt")]


def test_clip_pair_batches_are_the_jax_package_s(dataset):
    cfg_t = ExperimentConfig.from_args(dataset)
    cfg_j = JaxExperimentConfig.from_args(dataset)
    got = list(tfp._clip_pair_batches(cfg_t, 1))
    want = list(jfp._clip_pair_batches(cfg_j, 1))
    assert len(got) == len(want) == 1
    for (a1, a2), (b1, b2) in zip(got, want):
        assert a1.shape == (2 * (T - 1), IMG, IMG, 3) and a1.dtype == np.float32
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)
        np.testing.assert_array_equal(a1[1], a2[0])        # consecutive frames of one clip


def test_run_pretrain_runs_on_clip_pairs(dataset):
    cfg = ExperimentConfig.from_args([*dataset, "--device", "cpu", "--epochs", "1"])
    assert not cfg.data.synthetic
    metrics = tfp.run_pretrain(cfg, steps_cap=1)
    assert set(metrics) == {"loss", "photometric", "smoothness"}      # no probe: no EPE
    assert np.isfinite(list(metrics.values())).all()
    ckpt = latest_checkpoint(cfg.train.summaries_dir, "flownet")
    assert ckpt.name == "flownet_ep0" and torch.load(ckpt, weights_only=True)["step"] == 1
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, device="cuda"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tfp.run_pretrain(cfg, steps_cap=1)
