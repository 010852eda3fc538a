"""Parallelism: negative-pool scoping of the hard-way head across ranks.

Counterpart of `avtubes/parallel/__init__.py`.  Each rank holds its slice
of the (b·t) frame batch.  The global pool (the default) contrasts every
frame against the audio features of the GLOBAL batch: each rank gathers
the features of every rank, in rank order, with a differentiable
all-gather (`core/distributed.py::all_gather_rows`, whose backward sends
every rank's gradient of a key to the rank that owns it) and masks its own
pairs at offset rank · B_local.  The per-device pool
(`--negative_pool device`, the original `nn.DataParallel`'s semantics) is
the head on the rank's slice alone, logits (B/n, B/n + 2).

Without a process group every head is `hardway_head` on the local batch;
in a one-rank group the heads give its values.
"""

from __future__ import annotations

import torch.distributed as dist

from avtubes_torch.core.distributed import all_gather_rows, rank
from avtubes_torch.models.hardway import (
    HardwayConfig,
    HardwayOutput,
    global_pool_mask,
    hardway_head,
)

__all__ = [
    "global_pool_mask",
    "hardway_head_device_pool",
    "hardway_head_global_pool",
    "hardway_head_gathered_pool",
    "pool_head",
]


def hardway_head_device_pool(img_feats, aud_feats, cfg: HardwayConfig) -> HardwayOutput:
    """Hard-way head with per-rank negative pools: the rank's (B/n, H, W, C)
    and (B/n, C) features against its own sub-batch only, logits
    (B/n, B/n + 2)."""
    return hardway_head(img_feats, aud_feats, cfg)


def hardway_head_gathered_pool(img_feats, aud_feats, cfg: HardwayConfig) -> HardwayOutput:
    """Global negative pool with an explicit all-gather: the rank's rows
    against the audio features of every rank (K = global B), its own-pair
    columns at offset rank · B_local (`global_pool_mask`)."""
    keys = all_gather_rows(aud_feats)
    return hardway_head(img_feats, aud_feats, cfg, aud_all=keys,
                        pool_offset=rank() * aud_feats.shape[0])


def hardway_head_global_pool(img_feats, aud_feats, cfg: HardwayConfig) -> HardwayOutput:
    """Global negative pool (the default): the gathered pool whenever a
    process group is up (in a one-rank group its values are the plain
    head's, and the all-gather still runs), the plain head without one."""
    if dist.is_initialized():
        return hardway_head_gathered_pool(img_feats, aud_feats, cfg)
    return hardway_head(img_feats, aud_feats, cfg)


#: the head of each `--negative_pool`
_HEADS = {"global": hardway_head_global_pool, "device": hardway_head_device_pool}


def pool_head(negative_pool: str):
    """The head function of a `--negative_pool` value ('global' or 'device')."""
    if negative_pool not in _HEADS:
        raise ValueError(f"negative_pool must be one of {tuple(_HEADS)}, got {negative_pool!r}")
    return _HEADS[negative_pool]
