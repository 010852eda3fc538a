"""Training steps at a fixed batch, one after another, as a trainer's epoch
runs them on prefetched batches.

Parameters (a cell's `params`):
  step          'flagship' (`avtubes_torch.train.steps.hardway_fused_train_step`,
                the 16-frame two-view hard-way step) or 'tube3d'
                (`train3d_fused_step`, the 3D tube step)
  batch, frames clips a step and frames a clip
  pool          distinct batches made on the card and cycled through
  log_every     the trainer's cadence of reading the step's metrics back
  steps_per_epoch  what the learning-rate schedule counts its epochs in
  warmup_steps  the set-up's steps of the window's own call and feed
  checked_steps the steps after the window that the reference follows
  trace_steps   the steps the traced run profiles after its window

Set-up builds ONE train state (the program's model, loaded with the
benchmark's weights, and its Adam state) and warms it with `warmup_steps`
steps of the window's call and feed.  The window hands that same state on,
step after step, until its time is up, reading the metrics back every
`log_every` steps as `train/hardway.py::train_epoch` does, and ends in a
synchronise.  Each step's draws come from the program's own host draw
(`sample_augment_draws`; the 3D step's flips as `train/train3d.py` draws
them).

After the window (and the traced stretch) `replay` puts the benchmark's
weights and BatchNorm statistics back into the same model in place, zeroes
Adam's moments and counts in place, rewinds the schedule, and runs
`checked_steps` steps through the same call on distinct batches, with
draws from a fresh generator.  What the reference needs of them is
recorded: each step's loss, each leaf's first gradient as Adam took it (its
first moment over 1 - beta1 after one step), each leaf's change and each
BatchNorm statistic's change over those steps, and the draws.  The
reference then runs those steps from the same weights and inputs in float32
(TF32 off), with draws of its own from the same generator, or, as the
control, with every stored backbone tensor in float8.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from perfbench import inputs
from perfbench.harness import (Check, Context, limits_of, median_leaf_gap, relative_gap,
                               worst_leaf_gap)
from perfbench.reference import augment, training
from perfbench.reference.arith import Arith
from perfbench.weights import make_weights

KIND = "train"
#: the program's modules a run of this traffic imports
PROGRAM_MODULES = ("avtubes_torch.train.steps", "avtubes_torch.train.hardway",
                   "avtubes_torch.train.train3d")


def _program_config(ctx: Context):
    from avtubes_torch.core.config import ExperimentConfig, OptimConfig, TrainConfig
    from avtubes_torch.models.hardway import HardwayConfig

    c, p = ctx.config, ctx.params
    o = c["optim"]
    return ExperimentConfig(
        optim=OptimConfig(learning_rate=o["learning_rate"], weight_decay=o["weight_decay"],
                          lr_milestones=tuple(o["lr_milestones"]), lr_gamma=o["lr_gamma"],
                          batch_size=p["batch"], loss_weight=o["loss_weight"]),
        train=TrainConfig(compute_dtype=c["compute_dtype"], seed=0, log_every=p["log_every"],
                          device=str(ctx.device)),
        hardway=HardwayConfig(**c["head"]))


def _spec_config(cfg: dict):
    from avtubes_torch.data.spectrogram import SpectrogramConfig

    a = cfg["audio"]
    return SpectrogramConfig(samplerate=a["samplerate"], seconds=a["seconds"],
                             nperseg=a["nperseg"], noverlap=a["noverlap"])


class Steps:
    """The program's train state, its batches, and the step callable."""

    def __init__(self, ctx: Context):
        from avtubes_torch.core.device import disable_tf32
        from avtubes_torch.train import hardway, train3d
        from avtubes_torch.train.state import create_train_state

        self.ctx = ctx
        p, c = ctx.params, ctx.config
        disable_tf32()                       # as the training CLIs do
        weights = make_weights(c, ctx.seed, ctx.device)
        ctx.clock.lap("weights")
        prog_cfg = _program_config(ctx)
        build = hardway.build_model if p["step"] == "flagship" else train3d.build_model
        with torch.device(ctx.device):
            model = build(prog_cfg, torch.Generator(device=ctx.device).manual_seed(0))
        model.load_state_dict(weights, strict=True)
        del weights
        self.state = create_train_state(model, prog_cfg.optim, p["steps_per_epoch"])
        group = self.state.optimizer.param_groups[0]
        o = c["optim"]
        if (tuple(group["betas"]), group["eps"]) != (tuple(o["betas"]), o["eps"]):
            raise ValueError(f"the program's Adam has betas {group['betas']} and eps "
                             f"{group['eps']}; the configuration states {o['betas']}, {o['eps']}")
        self.spec_cfg = _spec_config(c)
        ctx.clock.lap("model")
        a = c["audio"]
        self.pool = inputs.clip_pool(ctx.seed, p["pool"], p["batch"], p["frames"],
                                     c["image_size"], a["samplerate"] * a["seconds"], ctx.device)
        self.draws = inputs.draws_generator(ctx.seed, "window")
        self.taken = 0
        # the schedule as it starts, for `replay`
        self.fresh_schedule = (self.state.scheduler.state_dict(),
                               [g["lr"] for g in self.state.optimizer.param_groups])
        ctx.clock.lap("inputs")

    def next_draws(self):
        """One step's draws, as the trainers draw them on the host."""
        from avtubes_torch.data.transforms import sample_augment_draws

        p = self.ctx.params
        if p["step"] == "flagship":
            return sample_augment_draws(p["batch"], self.draws, "random",
                                        self.ctx.config["image_size"])
        return inputs.flip_draws(self.draws, p["batch"])["flip1"]

    def step(self, draws=None) -> dict:
        """One step of the window's call and feed; its metrics as tensors."""
        from avtubes_torch.train import steps

        p, c = self.ctx.params, self.ctx.config
        batch = self.pool[self.taken % len(self.pool)]
        self.taken += 1
        d = self.next_draws() if draws is None else draws
        with torch.profiler.record_function("perfbench.step"):
            if p["step"] == "flagship":
                return steps.hardway_fused_train_step(
                    self.state, batch["clips"], batch["waves"], d, self.spec_cfg,
                    c["optim"]["loss_weight"], c["image_size"])
            return steps.train3d_fused_step(self.state, batch["clips"], batch["waves"], d,
                                            self.spec_cfg)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(ctx: Context) -> Steps:
    st = Steps(ctx)
    for _ in range(ctx.params["warmup_steps"]):
        st.step()
    _sync(ctx.device)
    ctx.clock.lap("warmup")
    return st


def _is_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


@torch.no_grad()
def _rewind(st: Steps, weights: dict) -> None:
    """The benchmark's weights and statistics back into the model, Adam's
    state and the schedule back to their start, every tensor in place."""
    st.state.model.load_state_dict(weights, strict=True)
    for leaf in st.state.optimizer.state.values():
        for v in leaf.values():
            if torch.is_tensor(v):
                v.zero_()
    schedule, lrs = st.fresh_schedule
    st.state.scheduler.load_state_dict(schedule)
    for group, lr in zip(st.state.optimizer.param_groups, lrs):
        group["lr"] = lr
    st.state.step = 0


def replay(ctx: Context, st: Steps) -> None:
    """The checked steps, through the window's own call on the warmed
    state, from the benchmark's weights; recorded in `st.checked`."""
    beta1 = ctx.config["optim"]["betas"][0]
    weights = make_weights(ctx.config, ctx.seed, ctx.device)
    _rewind(st, weights)
    model = st.state.model
    params = dict(model.named_parameters())
    stats = {k: v for k, v in model.named_buffers() if _is_stat(k)}
    st.draws = inputs.draws_generator(ctx.seed, "checked")
    st.taken = 0
    st.checked = {"losses": [], "grad_norm": {}, "draws": []}
    for i in range(ctx.params["checked_steps"]):
        d = st.next_draws()
        st.checked["draws"].append(d)
        metrics = st.step(d)
        st.checked["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            opt_state = st.state.optimizer.state
            st.checked["grad_norm"] = {
                k: float(torch.linalg.vector_norm(opt_state[v]["exp_avg"]) / (1.0 - beta1))
                for k, v in params.items() if "exp_avg" in opt_state.get(v, {})}
    st.checked["change_norm"] = {k: float(torch.linalg.vector_norm(v.detach() - weights[k]))
                                 for k, v in params.items()}
    st.checked["stats_change_norm"] = {
        k: float(torch.linalg.vector_norm(v - weights[k])) for k, v in stats.items()}
    del weights
    _sync(ctx.device)


def _run_steps(st: Steps, until: float | None, count: int | None) -> dict:
    log_every = st.ctx.params["log_every"]
    n, bad = 0, 0
    while True:
        metrics = st.step()
        n += 1
        if n % log_every == 0:
            logged = {k: float(v) for k, v in metrics.items()}
            bad += int(not all(math.isfinite(v) for v in logged.values()))
        if (until is not None and time.perf_counter() >= until) or n == count:
            break
    _sync(st.ctx.device)
    return {"steps": n, "non_finite_logs": bad}


def window(ctx: Context, st: Steps, seconds: float) -> dict:
    t0 = time.perf_counter()
    out = _run_steps(st, t0 + seconds, None)
    out["window_s"] = time.perf_counter() - t0
    out["clips"] = out["steps"] * ctx.params["batch"]
    out["attempted"] = out["steps"]
    out["failed"] = out["non_finite_logs"]
    return out


def traced(ctx: Context, st: Steps, capture) -> dict:
    with capture:
        out = _run_steps(st, None, ctx.params["trace_steps"])
    return out


def release(ctx: Context, st: Steps) -> None:
    st.state = st.pool = None


def reference_steps(ctx: Context, precision: str = "float32", rows: int | None = None) -> dict:
    """The checked steps in the plain reference, from the benchmark's
    weights and inputs of this seed (`rows`: only each batch's first rows,
    a planted fault)."""
    p, c = ctx.params, ctx.config
    a = c["audio"]
    weights = make_weights(c, ctx.seed, ctx.device)
    pool = inputs.clip_pool(ctx.seed, p["pool"], p["batch"], p["frames"], c["image_size"],
                            a["samplerate"] * a["seconds"], ctx.device)
    g = inputs.draws_generator(ctx.seed, "checked")
    batches = []
    for i in range(p["checked_steps"]):
        d = (augment.augment_draws(g, p["batch"], c["image_size"]) if p["step"] == "flagship"
             else inputs.flip_draws(g, p["batch"]))
        b = {**pool[i % len(pool)], "draws": d, "flip1": d["flip1"]}
        if rows is not None:
            b = {"clips": b["clips"][:rows], "waves": b["waves"][:rows], "flip1": d["flip1"][:rows],
                 "draws": {k: v[:rows] for k, v in d.items()}}
        batches.append(b)
    del pool
    out = training.run_steps(p["step"], weights, c, batches, Arith(precision))
    out["draws"] = [b["draws"] for b in batches]
    return out


def draws_mismatch(program: list, reference: list) -> int:
    """Draws of the checked steps in which the program's host draw differs
    from the reference's own: every element counts."""
    bad = 0
    for got, want in zip(program, reference):
        if dataclasses.is_dataclass(got):
            got = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)}
        for k, v in want.items():
            g = got.get(k)
            bad += (v.numel() if g is None or g.shape != v.shape
                    else int((g.to(v.dtype) != v).sum()))
    return bad


def compare(ctx: Context, program: dict, reference: dict, details: dict | None = None
            ) -> list[Check]:
    """The numbers that the cell's limits name, of:
      loss_gap         the worst step's relative loss gap;
      grad_gap         the worst leaf's first gradient as the optimizer took it;
      grad_median_gap  the median leaf's gap of that gradient;
      change_gap       the worst leaf's change over the checked steps,
                       leaving out the leaves whose reference gradient is
                       under a thousandth of the median leaf's (they move
                       by round-off alone);
      stats_gap        the worst BatchNorm running statistic's change;
      draws_mismatch   the program's host draws against the reference's.
    `details` gets the worst leaves, both gradient numbers and every step's
    gap."""
    lim = limits_of(ctx.cell)
    steps = len(reference["losses"])
    have = len(program["losses"])
    gaps = [relative_gap(program["losses"][i]["loss"], reference["losses"][i]["loss"])
            if i < have else math.inf for i in range(steps)]
    leaves = sorted(reference["grad_norm"])
    grad_gap, grad_leaf = worst_leaf_gap(program["grad_norm"], reference["grad_norm"], leaves)
    raw = reference["raw_grad_norm"]
    median = sorted(raw.values())[len(raw) // 2]
    moving = [k for k in leaves if raw[k] >= 1e-3 * median]
    change_gap, change_leaf = worst_leaf_gap(program["change_norm"], reference["change_norm"],
                                             moving)
    stats_gap, stats_leaf = worst_leaf_gap(program.get("stats_change_norm", {}),
                                           reference["stats_change_norm"],
                                           sorted(reference["stats_change_norm"]))
    numbers = {"loss_gap": max(gaps), "grad_gap": grad_gap,
               "grad_median_gap": median_leaf_gap(program["grad_norm"], reference["grad_norm"],
                                                  leaves),
               "change_gap": change_gap, "stats_gap": stats_gap}
    if "draws_mismatch" in lim:
        numbers["draws_mismatch"] = float(
            draws_mismatch(program["draws"], reference["draws"])
            if len(program.get("draws", [])) == steps else math.inf)
    if details is not None:
        details.update(loss_gaps=gaps, grad_leaf=grad_leaf, change_leaf=change_leaf,
                       stats_leaf=stats_leaf, left_out=sorted(set(leaves) - set(moving)),
                       numbers=numbers)
    return [Check(name, numbers[name], limit) for name, limit in lim.items()]


def check(ctx: Context, st: Steps, window_out: dict) -> list[Check]:
    reference = reference_steps(ctx)
    return compare(ctx, st.checked, reference)
