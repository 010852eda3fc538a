"""Train state and optimizer (PyTorch).

Counterpart of `avtubes/train/state.py`.  The recipe is torch's own Adam
with `weight_decay` — L2 added to the *gradient* before the moments, not
AdamW — and a MultiStepLR over epochs; the JAX package spells that as
`optax.chain(add_decayed_weights, adam(schedule))` with a piecewise-constant
step schedule.  Here it is `torch.optim.Adam(weight_decay=...)` (its
`eps=1e-8` sits outside the square root, as optax's does) and a `LambdaLR`
that steps once per optimizer step.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterable

import torch
from torch import nn

from avtubes_torch.core.config import ExperimentConfig, OptimConfig


def make_lr_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> factor on `cfg.learning_rate`: `lr_gamma` for every milestone
    (in epochs) whose first step has been reached; the update numbered
    `step` (from 0) uses `schedule(step)`."""
    boundaries = sorted({int(m * steps_per_epoch) for m in cfg.lr_milestones})

    def factor(step: int) -> float:
        return cfg.lr_gamma ** sum(step >= b for b in boundaries)

    return factor


def make_optimizer(params: Iterable[nn.Parameter], cfg: OptimConfig,
                   steps_per_epoch: int = 1
                   ) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    optimizer = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, make_lr_schedule(cfg, steps_per_epoch))
    return optimizer, scheduler


@dataclasses.dataclass
class TrainState:
    """A model with its optimizer, its schedule and the count of updates.
    Updated in place: a training step mutates the parameters and the
    optimizer's moments.  The BatchNorm running statistics live in the model
    (its buffers), so a checkpoint of the model carries them; the trainer
    passes the loader's steps per epoch, in which the schedule's milestones
    (in epochs) are counted."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def apply_gradients(self) -> None:
        """One update from the gradients that `backward()` left on the
        parameters."""
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1


def create_train_state(model: nn.Module, optim_cfg: OptimConfig,
                       steps_per_epoch: int = 1) -> TrainState:
    optimizer, scheduler = make_optimizer(model.parameters(), optim_cfg, steps_per_epoch)
    return TrainState(model, optimizer, scheduler)


def restore_for_tag(cfg: ExperimentConfig, tag: str, device: torch.device,
                    missing: str | None = None) -> tuple[TrainState, int]:
    """The state of the trainer that writes `<tag>_ep<N>` (a tag starting
    with `tube`: FullModel, any other: AVENet; seeded, on `device`), restored
    from `--pretrained_path` or the newest such checkpoint of
    `--summaries_dir`: (state, epoch).  Prints `loaded <path> (epoch N)`,
    or `WARNING: no checkpoint found — <missing>` where there is none."""
    # these modules import this one
    from avtubes_torch.core.checkpoint import latest_checkpoint, restore_checkpoint
    from avtubes_torch.train import hardway, train3d

    build = train3d.build_model if tag.startswith("tube") else hardway.build_model
    state = create_train_state(build(cfg, torch.Generator().manual_seed(0)).to(device),
                               cfg.optim)
    ckpt = cfg.train.pretrained_path or latest_checkpoint(cfg.train.summaries_dir, tag)
    if not ckpt:
        if missing:
            print(f"WARNING: no checkpoint found — {missing}")
        return state, 0
    state, epoch = restore_checkpoint(ckpt, state)
    print(f"loaded {ckpt} (epoch {epoch})")
    return state, epoch
