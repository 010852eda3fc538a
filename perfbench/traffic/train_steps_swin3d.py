"""The 3D tube step with Video Swin-B as FullModel's tube encoder, at a fixed
batch, one step after another, as `train_steps_timesformer.py` runs it with
TimeSformer: the same feed, window, traced stretch and replay, the
program's own view-1 flips, and the same comparison
(`train_steps_timesformer.compare`: `train_steps.compare`'s numbers and
each tower leaf's first gradient as a vector).

What differs: the weights come from `perfbench/weights_swin3d.py` and the
reference is `reference/swin3d.py`, which runs the tower `reference_chunk`
clips at a time, each group recomputed in its backward pass.

Parameters (a cell's `params`) are `train_steps_timesformer.py`'s.
"""

from __future__ import annotations

import torch

from perfbench import inputs
from perfbench.harness import Context
from perfbench.reference import swin3d
from perfbench.reference.arith import Arith
from perfbench.traffic import train_steps, train_steps_timesformer
from perfbench.traffic.train_steps import _is_stat, _rewind, _sync
from perfbench.weights_swin3d import make_weights

KIND = "train"
PROGRAM_MODULES = train_steps.PROGRAM_MODULES
# the window, the traced stretch, the end and the comparison are TimeSformer's
window, traced, release = train_steps.window, train_steps.traced, train_steps.release
compare = train_steps_timesformer.compare


class Steps(train_steps_timesformer.Steps):
    """`train_steps_timesformer.Steps` with this configuration's weights."""

    def __init__(self, ctx: Context):
        from avtubes_torch.core.device import disable_tf32
        from avtubes_torch.train import train3d
        from avtubes_torch.train.state import create_train_state

        self.ctx = ctx
        p, c = ctx.params, ctx.config
        disable_tf32()                       # as the training CLIs do
        weights = make_weights(c, ctx.seed, ctx.device)
        ctx.clock.lap("weights")
        prog_cfg = train_steps_timesformer._program_config(ctx)
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


def setup(ctx: Context) -> Steps:
    st = Steps(ctx)
    for _ in range(ctx.params["warmup_steps"]):
        st.step()
    _sync(ctx.device)
    ctx.clock.lap("warmup")
    return st


def replay(ctx: Context, st: Steps) -> None:
    """`train_steps_timesformer.replay` with this configuration's weights."""
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
    out = swin3d.run_steps(weights, c, batches, Arith(precision), p["reference_chunk"])
    out["draws"] = [b["draws"] for b in batches]
    return out


def check(ctx: Context, st: Steps, window_out: dict) -> list:
    return compare(ctx, st.checked, reference_steps(ctx))
