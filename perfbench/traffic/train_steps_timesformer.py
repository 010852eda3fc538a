"""The 3D tube step with TimeSformer-B/16 as FullModel's tube encoder, at a
fixed batch, one step after another, as `train_steps.py` runs the R3D-18
tube step: the same feed (a pool of batches made on the card, host draws
each step, the metrics read back every `log_every` steps), the same window,
traced stretch and replay, and the same comparison (`train_steps.compare`).

What differs: the configuration's `video_arch` builds the program's model
(`train/train3d.py::build_model`, the trainer's own) with the clip's frames
and size; the weights come from `perfbench/weights_timesformer.py`; each
step's view-1 flips are the program's own draw (`train3d.draw_view1_flips`)
and the check holds them to the reference's, draw for draw; the reference
is `reference/timesformer.py`, which runs the tower `reference_chunk` clips
at a time, each group recomputed in its backward pass.  Beside
`train_steps.compare`'s numbers the check compares each of the tower's
leaves' first gradient as a vector (`tower_grad_error`): the norms alone
hardly move when the tower's mathematics is wrong, since at its random
start the loss barely depends on the video features.

Parameters (a cell's `params`) are `train_steps.py`'s, with `step`
'tube3d', and `reference_chunk`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from perfbench import inputs
from perfbench.harness import Check, Context, limits_of
from perfbench.reference import timesformer
from perfbench.reference.arith import Arith
from perfbench.traffic import train_steps
from perfbench.traffic.train_steps import _is_stat, _rewind, _sync
from perfbench.weights_timesformer import make_weights

KIND = "train"
PROGRAM_MODULES = train_steps.PROGRAM_MODULES
# the window, the traced stretch and the end are the R3D-18 step's
window, traced, release = train_steps.window, train_steps.traced, train_steps.release


def _program_config(ctx: Context):
    """`train_steps`' program configuration with the configuration's tube
    encoder over clips of its frames and size."""
    cfg = train_steps._program_config(ctx)
    vid = ctx.config["nets"]["video"]
    if (ctx.params["frames"], ctx.config["image_size"]) != (vid["num_frames"], vid["img_size"]):
        raise ValueError(f"the cell's clips ({ctx.params['frames']} frames at "
                         f"{ctx.config['image_size']}^2) are not the tower's "
                         f"({vid['num_frames']} at {vid['img_size']}^2)")
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_size=vid["img_size"],
                                      frame_density=vid["num_frames"]),
        train=dataclasses.replace(cfg.train, video_arch=ctx.config["video_arch"]))


class Steps(train_steps.Steps):
    """`train_steps.Steps` with this tower and the program's flip draw."""

    def __init__(self, ctx: Context):
        from avtubes_torch.core.device import disable_tf32
        from avtubes_torch.train import train3d
        from avtubes_torch.train.state import create_train_state

        self.ctx = ctx
        p, c = ctx.params, ctx.config
        disable_tf32()                       # as the training CLIs do
        weights = make_weights(c, ctx.seed, ctx.device)
        ctx.clock.lap("weights")
        prog_cfg = _program_config(ctx)
        with torch.device(ctx.device):
            model = train3d.build_model(prog_cfg,
                                        torch.Generator(device=ctx.device).manual_seed(0))
        model.load_state_dict(weights, strict=True)
        del weights
        self.state = create_train_state(model, prog_cfg.optim, p["steps_per_epoch"])
        group = self.state.optimizer.param_groups[0]
        o = c["optim"]
        if (tuple(group["betas"]), group["eps"]) != (tuple(o["betas"]), o["eps"]):
            raise ValueError(f"the program's Adam has betas {group['betas']} and eps "
                             f"{group['eps']}; the configuration states {o['betas']}, {o['eps']}")
        self.spec_cfg = train_steps._spec_config(c)
        ctx.clock.lap("model")
        a = c["audio"]
        self.pool = inputs.clip_pool(ctx.seed, p["pool"], p["batch"], p["frames"],
                                     c["image_size"], a["samplerate"] * a["seconds"], ctx.device)
        self.draws = inputs.draws_generator(ctx.seed, "window")
        self.taken = 0
        self.fresh_schedule = (self.state.scheduler.state_dict(),
                               [g["lr"] for g in self.state.optimizer.param_groups])
        ctx.clock.lap("inputs")

    def next_draws(self):
        """One step's view-1 flips, the trainer's own host draw."""
        from avtubes_torch.train.train3d import draw_view1_flips

        return draw_view1_flips(self.draws, self.ctx.params["batch"])


def setup(ctx: Context) -> Steps:
    st = Steps(ctx)
    for _ in range(ctx.params["warmup_steps"]):
        st.step()
    _sync(ctx.device)
    ctx.clock.lap("warmup")
    return st


def replay(ctx: Context, st: Steps) -> None:
    """`train_steps.replay` with this configuration's weights, the draws
    recorded for the check."""
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
        st.checked["draws"].append({"flip1": d})
        metrics = st.step(d)
        st.checked["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            opt_state = st.state.optimizer.state
            st.checked["grads"] = {k: opt_state[v]["exp_avg"] / (1.0 - beta1)
                                   for k, v in params.items() if "exp_avg" in opt_state.get(v, {})}
            st.checked["grad_norm"] = {k: float(torch.linalg.vector_norm(g))
                                       for k, g in st.checked["grads"].items()}
    st.checked["change_norm"] = {k: float(torch.linalg.vector_norm(v.detach() - weights[k]))
                                 for k, v in params.items()}
    st.checked["stats_change_norm"] = {
        k: float(torch.linalg.vector_norm(v - weights[k])) for k, v in stats.items()}
    del weights
    _sync(ctx.device)


def reference_steps(ctx: Context, precision: str = "float32", rows: int | None = None) -> dict:
    """The checked steps in the plain reference, from this seed's weights,
    inputs and the reference's own flip draws (`rows`: only each batch's
    first rows, a planted fault)."""
    p, c = ctx.params, ctx.config
    a = c["audio"]
    weights = make_weights(c, ctx.seed, ctx.device)
    pool = inputs.clip_pool(ctx.seed, p["pool"], p["batch"], p["frames"], c["image_size"],
                            a["samplerate"] * a["seconds"], ctx.device)
    g = inputs.draws_generator(ctx.seed, "checked")
    batches = []
    for i in range(p["checked_steps"]):
        d = inputs.flip_draws(g, p["batch"])
        b = {**pool[i % len(pool)], "draws": d, "flip1": d["flip1"]}
        if rows is not None:
            b = {"clips": b["clips"][:rows], "waves": b["waves"][:rows],
                 "flip1": d["flip1"][:rows], "draws": {k: v[:rows] for k, v in d.items()}}
        batches.append(b)
    del pool
    out = timesformer.run_steps(weights, c, batches, Arith(precision), p["reference_chunk"])
    out["draws"] = [b["draws"] for b in batches]
    return out


def tower_grad_errors(program: dict, reference: dict, prefix: str) -> dict[str, float]:
    """Each tower leaf's first gradient as the program's optimizer took it,
    against the reference's: the norm of their difference over the larger
    of the reference's norm of that leaf and of the median tower leaf; a
    leaf the program did not report reads infinity."""
    leaves = sorted(k for k in reference if k.startswith(prefix + "."))
    norms = {k: float(torch.linalg.vector_norm(reference[k])) for k in leaves}
    median = float(np.median(list(norms.values())))
    out = {}
    for k in leaves:
        g = program.get(k)
        out[k] = math.inf if g is None else float(
            torch.linalg.vector_norm(g.float() - reference[k].to(g.device))
        ) / max(norms[k], median, 1e-30)
    return {k: math.inf if math.isnan(v) else v for k, v in out.items()}


def compare(ctx: Context, program: dict, reference: dict, details: dict | None = None
            ) -> list[Check]:
    """`train_steps.compare`'s numbers and
      tower_grad_error         the worst tower leaf's `tower_grad_errors`;
      tower_grad_median_error  the median tower leaf's,
    each beside the cell's limit of its name."""
    lim = limits_of(ctx.cell)
    ours = ("tower_grad_error", "tower_grad_median_error")
    cell = dataclasses.replace(ctx.cell, spec={
        **ctx.cell.spec, "limits": {k: v for k, v in lim.items() if k not in ours}})
    held = {} if details is None else details
    train_steps.compare(dataclasses.replace(ctx, cell=cell), program, reference, held)
    errors = tower_grad_errors(program.get("grads", {}), reference["grads"],
                               ctx.config["nets"]["video"]["prefix"])
    worst = max(errors, key=errors.get)
    numbers = {**held["numbers"], "tower_grad_error": errors[worst],
               "tower_grad_median_error": float(np.median(list(errors.values())))}
    held.update(numbers=numbers, tower_grad_leaf=worst)
    return [Check(name, numbers[name], limit) for name, limit in lim.items()]


def check(ctx: Context, st: Steps, window_out: dict) -> list[Check]:
    return compare(ctx, st.checked, reference_steps(ctx))
