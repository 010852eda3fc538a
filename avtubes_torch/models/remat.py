"""Activation checkpointing of a backbone (`--remat`).

Counterpart of the JAX package's `nn.remat` around each backbone
(`avtubes/models/avenet.py`, `fullmodel.py`): a backbone call in training
keeps only its input and recomputes its activations in the backward pass,
one segment a call.  Same function, same parameters and `state_dict`; it
trades a second forward of the backbone for the memory of its activations.

The trap is BatchNorm.  `torch.utils.checkpoint` re-runs the segment's
forward in training mode during the backward, so every BatchNorm in it
would advance its running statistics (and `num_batches_tracked`) a second
time, and in the two-view step in the reverse order (the augmented view's
segment is recomputed first).  `flax.linen.remat` discards what the
recomputation mutates.  Here the recomputation runs with each BatchNorm's
momentum at 0 and its `num_batches_tracked` detached: the layer takes the
same code path as in the forward (so the recomputed activations are the
forward's, bit for bit), and `(1 - 0) * running + 0 * batch` leaves the
running statistics as the forward left them.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module) -> Iterator[None]:
    """Every BatchNorm in `module` normalizes with its batch's statistics as
    in training, but leaves its running statistics and its batch count as
    they are; restored on exit."""
    saved = [(bn, bn.momentum, bn.num_batches_tracked) for bn in module.modules()
             if isinstance(bn, _BatchNorm) and bn.track_running_stats]
    try:
        for bn, _, _ in saved:
            bn.momentum = 0.0
            bn.num_batches_tracked = None
        yield
    finally:
        for bn, momentum, count in saved:
            bn.momentum = momentum
            bn.num_batches_tracked = count


def call_backbone(backbone: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """`backbone(x)`, as one checkpoint segment where `remat` and the call
    builds a graph (the backbone in training mode, grad enabled); in eval
    mode or under `no_grad` a plain call, since nothing is kept for a
    backward there."""
    if not (remat and backbone.training and torch.is_grad_enabled()):
        return backbone(x)
    # no backbone draws random numbers, so the recomputation need not
    # replay the generators' states
    return checkpoint(backbone, x, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          running_stats_frozen(backbone)))
