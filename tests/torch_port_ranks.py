"""Runs a job of the port in several gloo ranks on the CPU, for the tests of
`avtubes_torch/core/distributed.py`, `models/norm.py`, `parallel/`, the
flagship trainer across processes, and the trainers whose `--batch_size` is
the global batch (their steps, the rows loader, the sharded evaluation).

`run_ranks(job, payload, tmp_path)` saves `payload` (tensors and plain
containers) with `torch.save`, starts one process of this file per rank
(`python tests/torch_port_ranks.py <job> <dir> <world>`, the
JAX package's AVTUBES_COORDINATOR trio in the environment, so each rank goes
through `maybe_initialize(device="cpu")` onto gloo), waits for all of them
with one deadline, kills every rank when it expires, and returns what each
rank saved.  The workers import torch and the port only: no JAX.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
#: a hung collective fails its test within this many seconds
TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(port: int, rank: int, world: int) -> dict:
    """The environment of one rank: the coordinator trio, two intra-op
    threads (several ranks share the host with other test workers)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(AVTUBES_COORDINATOR=f"127.0.0.1:{port}", AVTUBES_NUM_PROCESSES=str(world),
               AVTUBES_PROCESS_ID=str(rank), OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]))
    return env


def wait_all(procs: list[subprocess.Popen], timeout: float = TIMEOUT_S) -> list[str]:
    """Wait for every process within one deadline; on expiry kill them all
    and fail.  Returns each one's output (stdout and stderr together)."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0] for p in procs]
        raise AssertionError(f"ranks did not finish within {timeout} s:\n"
                             + "\n".join(log[-3000:] for log in logs)) from None
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"a rank failed (exit {p.returncode}):\n{out[-6000:]}"
    return outs


def launch(cmd: list[str], world: int, ranks: list[int] | None = None
           ) -> list[subprocess.Popen]:
    """Start `cmd` once per rank of `ranks` (default: every rank of the
    world), each with its rank's environment."""
    port = free_port()
    return [subprocess.Popen(cmd, env=rank_env(port, r, world), cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in (range(world) if ranks is None else ranks)]


def start_ranks(job: str, payload: dict, tmp_path: Path, world: int = 2,
                timeout: float = TIMEOUT_S):
    """Start `job_<job>(payload, rank, world)` (a function of this file) in
    `world` gloo ranks; returns a function that waits for them (one
    deadline, `timeout` from now) and returns what each rank's call
    returned, in rank order.  The caller can work meanwhile."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp_path / "payload.pt")
    procs = launch([sys.executable, __file__, job, str(tmp_path), str(world)], world)
    deadline = time.monotonic() + timeout

    def finish() -> list[dict]:
        wait_all(procs, max(1.0, deadline - time.monotonic()))
        results = []
        for r in range(world):
            path = tmp_path / f"rank{r}.pt"
            results.append(torch.load(path, weights_only=False))
            path.unlink()
        (tmp_path / "payload.pt").unlink()
        return results

    return finish


def run_ranks(job: str, payload: dict, tmp_path: Path, world: int = 2,
              timeout: float = TIMEOUT_S) -> list[dict]:
    """`start_ranks`, waited for."""
    return start_ranks(job, payload, tmp_path, world, timeout)()


# ---------------------------------------------------------------- the jobs
# Each takes (payload, rank, world) in an initialized gloo group and returns
# what the test reads.

def job_collectives(p: dict, rank: int, world: int) -> dict:
    """`all_gather_rows` forward and backward, the preemption consensus,
    the barrier, and the agreed step counts."""
    from avtubes_torch.core import distributed as dd

    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    gathered = dd.all_gather_rows(x)
    # every rank weighs the gathered rows by its own factor (rank + 1): the
    # owner of a row must receive the sum of all ranks' weights
    (gathered * (rank + 1)).sum().backward()
    dd.barrier("test")
    return {
        "gathered": gathered.detach(), "gather_grad": x.grad,
        "preempt_one": dd.preempted_anywhere(rank == 1, torch.device("cpu")),
        "preempt_none": dd.preempted_anywhere(False, torch.device("cpu")),
        "agreed": {tuple(case): dd.agreed_steps_per_epoch(*case) for case in p["agreed"]},
        "shard": dd.data_shard(), "primary": dd.is_primary(),
        "backend": torch.distributed.get_backend(),
    }


def job_heads(p: dict, rank: int, world: int) -> dict:
    """The gathered and per-device pool heads on this rank's rows, and the
    gradients of a fixed cotangent of their outputs."""
    from avtubes_torch.models.hardway import HardwayConfig
    from avtubes_torch.parallel import (
        hardway_head_device_pool,
        hardway_head_gathered_pool,
        hardway_head_global_pool,
    )

    b = p["img"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for name, head in (("gathered", hardway_head_gathered_pool),
                       ("global", hardway_head_global_pool),
                       ("device", hardway_head_device_pool)):
        img = p["img"][rows].clone().requires_grad_()
        aud = p["aud"][rows].clone().requires_grad_()
        o = head(img, aud, HardwayConfig())
        cot = p["cot_device" if name == "device" else "cot_global"]
        loss = ((o.logits * cot["logits"][rows]).sum() + (o.heatmap * cot["heatmap"][rows]).sum()
                + (o.weighted_map * cot["weighted"][rows]).sum())
        loss.backward()
        out[name] = {"logits": o.logits.detach(), "heatmap": o.heatmap.detach(),
                     "weighted": o.weighted_map.detach(), "img_grad": img.grad,
                     "aud_grad": aud.grad}
    return out


def job_norm(p: dict, rank: int, world: int) -> dict:
    """One training forward and backward of the global BatchNorm on this
    rank's rows, per case."""
    from avtubes_torch.models.norm import BatchNorm2d

    out = {}
    for name, case in p["cases"].items():
        b = case["x"].shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        bn = BatchNorm2d(case["x"].shape[1], eps=1e-5, momentum=0.1)
        bn.load_state_dict(case["state"])
        bn.train()
        x = case["x"][rows].clone().requires_grad_()
        y = bn(x)
        (y.to(torch.float32) * case["cot"][rows]).sum().backward()
        out[name] = {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
                     "bias_grad": bn.bias.grad,
                     "state": {k: v.clone() for k, v in bn.state_dict().items()}}
    return out


def job_step(p: dict, rank: int, world: int) -> dict:
    """One flagship step on this rank's rows, per (pool, remat, dtype)
    case, from the same weights: the metrics, the gradients before Adam
    (what every rank applies), the running statistics and the parameters
    after the update.  float32 is the fused step as the trainer runs it;
    float64 runs its parts (K1's plain version and the augmentation in
    float32, whose values do not depend on the batch's other clips) with the
    backbones in float64, where float32 noise decides nothing."""
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
    from avtubes_torch.data.transforms import AugmentDraws, augment_train_batch
    from avtubes_torch.models.avenet import AVENet
    from avtubes_torch.models.hardway import HardwayConfig
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import hardway_fused_train_step, hardway_train_step

    b = p["clips"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    draws = AugmentDraws(**p["draws"]).rows(rank * b, (rank + 1) * b)
    cfg = SpectrogramConfig(**p["spec"])
    out = {}
    for pool, remat, dtype in p["cases"]:
        # the per-device pool's block: one rank's frames of a world of two
        # (what a world of one emulates on the concatenated batch)
        model = AVENet(hardway=HardwayConfig(pool_block=p["pool_block"]),
                       generator=torch.Generator().manual_seed(1), remat=remat)
        model.load_state_dict(p["weights"])
        if dtype == "float64":
            model.double()
            model.imgnet.compute_dtype = model.audnet.compute_dtype = torch.float64
        state = create_train_state(model, OptimConfig(learning_rate=p["lr"]), 4)
        if dtype == "float32":
            metrics = hardway_fused_train_step(state, p["clips"][rows], p["waves"][rows], draws,
                                               cfg, 0.1, p["image_size"], negative_pool=pool)
        else:
            spec = log_spectrogram(p["waves"][rows], cfg)[..., None].double()
            v1, v2 = augment_train_batch(p["clips"][rows], draws, p["image_size"])
            metrics = hardway_train_step(state, v1.double(), v2.double(), spec, 0.1,
                                         negative_pool=pool)
        out[(pool, remat, dtype)] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: q.grad.clone() for n, q in model.named_parameters()},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if "running" in k or "num_batches" in k},
            "params": {n: q.detach().clone() for n, q in model.named_parameters()},
        }
    return out


def job_trainer(p: dict, rank: int, world: int) -> dict:
    """The flagship trainer's `run` with a preemption signal caught on the
    last rank alone during the first epoch: every rank must stop at that
    epoch's end, the primary alone save it (under its own number) and log."""
    import avtubes_torch.train.hardway as hardway
    from avtubes_torch.core import checkpoint
    from avtubes_torch.core.config import ExperimentConfig

    saves = []
    real_save = checkpoint.save_checkpoint

    def recording_save(*a, **k):
        saves.append(a[2])
        return real_save(*a, **k)

    hardway.save_checkpoint = recording_save
    if rank == world - 1:
        class Signalled(hardway.PreemptionGuard):
            def __init__(self):
                super().__init__()
                self.preempted = True

        hardway.PreemptionGuard = Signalled
    final = hardway.run(ExperimentConfig.from_args(p["args"]), steps_cap=p["steps"])
    return {"final": final, "saves": saves}


def _as_float64(model) -> None:
    """`model` and the compute dtype of its backbones in float64."""
    model.double()
    for name in ("imgnet", "audnet", "vidnet"):
        if hasattr(model, name):
            getattr(model, name).compute_dtype = torch.float64


def job_mesh_steps(p: dict, rank: int, world: int) -> dict:
    """One step of each trainer whose `--batch_size` is the global batch,
    on this rank's rows of it, per (kind, dtype) case, from the same
    weights: the metrics, the gradients before Adam (what every rank
    applies), the running statistics and the audio tower after it.  Kinds: '1frame'
    (`hardway_1frame_train_step`), '3d' (`train3d_step`), 'flow'
    (`flow_train_step`, weight 0.1, the frozen flow net in float32),
    'pretrain' (`flow_pretrain_step`, FlowNetLite in float32 whatever its
    input's type)."""
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.avenet import AVENet
    from avtubes_torch.models.flownet import FlowNetLite
    from avtubes_torch.models.fullmodel import FullModel
    from avtubes_torch.train.flow import flow_train_step
    from avtubes_torch.train.flow_pretrain import create_flow_state, flow_pretrain_step
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import hardway_1frame_train_step, train3d_step

    out = {}
    for kind, dtype in p["cases"]:
        inputs = p["inputs"][kind]
        b = inputs[0].shape[0] // world
        x = [a[rank * b:(rank + 1) * b].to(getattr(torch, dtype)) for a in inputs]
        if kind == "pretrain":
            state = create_flow_state(torch.Generator().manual_seed(11), 1e-4, device="cpu")
            metrics = flow_pretrain_step(state, *x)
        else:
            model = (FullModel if kind == "3d" else AVENet)(
                generator=torch.Generator().manual_seed(1))
            model.load_state_dict(p["weights"][kind])
            if dtype == "float64":
                _as_float64(model)
            state = create_train_state(model, OptimConfig(learning_rate=1e-4), 4)
            if kind == "1frame":
                metrics = hardway_1frame_train_step(state, *x)
            elif kind == "3d":
                metrics = train3d_step(state, *x)
            else:
                flow_net = FlowNetLite(generator=torch.Generator().manual_seed(7)).eval()
                flow_net.requires_grad_(False)
                metrics = flow_train_step(state, flow_net, x[0].float(), x[1], 0.1)
        model = state.model
        out[(kind, dtype)] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: q.grad.clone() for n, q in model.named_parameters()},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if "running" in k or "num_batches" in k},
            "audio_params": {n: q.detach().clone() for n, q in model.named_parameters()
                             if n.startswith("audnet.")},
        }
    return out


def job_timesformer_step(p: dict, rank: int, world: int) -> dict:
    """One `train3d_step` in float64 of FullModel with a small TimeSformer
    tube encoder (`p["tower"]`, its weights `p["weights"]`) on this rank's
    rows of the global batch: the metrics and the gradients before Adam."""
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.fullmodel import FullModel
    from avtubes_torch.models.timesformer import TimeSformer
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import train3d_step

    model = FullModel(generator=torch.Generator().manual_seed(1))
    model.vidnet, model.video_arch = TimeSformer(**p["tower"]), "timesformer_b16"
    model.load_state_dict(p["weights"])
    _as_float64(model)
    b = p["video"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    state = create_train_state(model, OptimConfig(learning_rate=1e-4), 4)
    metrics = train3d_step(state, p["video"][rows].double(), p["spec"][rows].double())
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: q.grad.clone() for n, q in model.named_parameters()}}


def job_norm3d(p: dict, rank: int, world: int) -> dict:
    """One training forward and backward of the global `BatchNorm3d` on this
    rank's rows, per case, in the case's memory format; and one forward of
    the same layer under `models/remat.py`'s frozen recomputation."""
    from avtubes_torch.models.norm import BatchNorm3d
    from avtubes_torch.models.remat import running_stats_frozen

    out = {}
    for name, case in p["cases"].items():
        b = case["x"].shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        bn = BatchNorm3d(case["x"].shape[1], eps=1e-5, momentum=0.1).double()
        bn.load_state_dict(case["state"])
        bn.train()
        x = case["x"][rows].clone().contiguous(memory_format=case["format"]).requires_grad_()
        y = bn(x)
        (y * case["cot"][rows]).sum().backward()
        state = {k: v.clone() for k, v in bn.state_dict().items()}
        with torch.no_grad(), running_stats_frozen(bn):
            y_frozen = bn(x)
        out[name] = {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
                     "bias_grad": bn.bias.grad, "state": state,
                     "channels_last": y.is_contiguous(memory_format=torch.channels_last_3d),
                     "y_frozen": y_frozen, "state_after_frozen": bn.state_dict()}
    return out


class CountingSource:
    """A source of `n` small samples whose `load` records the indices it
    was asked for and raises `SkippedSampleError` for those in `bad`."""

    def __init__(self, n: int, bad=()):
        self.n, self.bad, self.loaded = n, set(bad), []

    def __len__(self) -> int:
        return self.n

    def load(self, idx: int, rng):
        from avtubes_torch.data.pipeline import SkippedSampleError

        self.loaded.append(idx)
        if idx in self.bad:
            raise SkippedSampleError(f"sample {idx} is bad")
        return {"clip": np.full((2, 3), idx, np.int64) + rng.randint(0, 1000, (2, 3)),
                "id": f"s{idx}"}


def job_rows_loader(p: dict, rank: int, world: int) -> dict:
    """The rows loader's epochs over a counting source, per case: the
    batches this rank yields, the indices it loaded and the skip counts."""
    from avtubes_torch.core.config import DataConfig
    from avtubes_torch.data.pipeline import BatchLoader, SyntheticSource

    out = {}
    for name, case in p["cases"].items():
        src = (SyntheticSource(DataConfig(image_size=16, frame_density=2, samplerate=8000,
                                          audio_seconds=1), n=case["n"])
               if case.get("synthetic") else CountingSource(case["n"], case["bad"]))
        loader = BatchLoader(src, case["batch"], num_workers=2, seed=5, rows=(rank, world))
        batches = list(loader.epoch(case["epoch"], limit=case.get("limit", 0)))
        out[name] = {"batches": batches, "loaded": getattr(src, "loaded", None),
                     "epoch_skipped": loader.epoch_skipped, "len": len(loader)}
    return out


def job_eval(p: dict, rank: int, world: int) -> dict:
    """`evaluate_hardway(sharded=True)` of the given AVENet weights on a
    synthetic set whose last batch needs padding: the primary's metrics
    and evaluated ids (the others': empty)."""
    from avtubes_torch.core.config import DataConfig
    from avtubes_torch.data.pipeline import BatchLoader, SyntheticSource
    from avtubes_torch.data.spectrogram import SpectrogramConfig
    from avtubes_torch.models.avenet import AVENet
    from avtubes_torch.train.evaluate import evaluate_hardway
    from avtubes_torch.train.hardway import _synthetic_gt_lookup

    d = DataConfig(**p["data"])
    model = AVENet(generator=torch.Generator().manual_seed(1))
    model.load_state_dict(p["weights"])
    loader = BatchLoader(SyntheticSource(d, n=p["n"], clip=False, seed=1), p["batch"],
                         num_workers=1, shuffle=False, drop_last=False)
    ids: list = []
    metrics = evaluate_hardway(model, loader, d, SpectrogramConfig(d.samplerate,
                                                                   d.audio_seconds),
                               _synthetic_gt_lookup(), evaluated_ids=ids, sharded=True)
    return {"metrics": metrics, "ids": ids}


def job_mesh_trainer(p: dict, rank: int, world: int) -> dict:
    """The 1-frame trainer's `run` (a global `--batch_size`) with a
    preemption signal caught on the last rank alone during the first
    epoch: every rank must finish that epoch, stop at its end, and the
    primary alone save it (under its own number) and log."""
    import avtubes_torch.train.hardway as hardway
    import avtubes_torch.train.hardway_1frame as hardway_1frame
    from avtubes_torch.core import checkpoint
    from avtubes_torch.core.config import ExperimentConfig

    saves = []
    real_save = checkpoint.save_checkpoint

    def recording_save(*a, **k):
        saves.append(a[2])
        return real_save(*a, **k)

    hardway.save_checkpoint = recording_save
    if rank == world - 1:
        class Signalled(hardway_1frame.PreemptionGuard):
            def __init__(self):
                super().__init__()
                self.preempted = True

        hardway_1frame.PreemptionGuard = Signalled
    final = hardway_1frame.run(ExperimentConfig.from_args(p["args"]), steps_cap=p["steps"])
    return {"final": final, "saves": saves}


def main() -> None:
    job, out_dir, world = sys.argv[1], Path(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(2)
    from avtubes_torch.core import distributed as dd

    dd.maybe_initialize("cpu", timeout=datetime.timedelta(seconds=TIMEOUT_S))
    assert dd.world_size() == world and torch.distributed.is_initialized()
    rank = dd.rank()
    payload = torch.load(out_dir / "payload.pt", weights_only=False)
    result = globals()[f"job_{job}"](payload, rank, world)
    torch.save(result, out_dir / f"rank{rank}.pt")
    dd.barrier("done")
    dd.shutdown()


if __name__ == "__main__":
    main()
