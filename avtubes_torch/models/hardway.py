"""The "hard-way" cross-modal similarity head (PyTorch).

Counterpart of `avtubes/models/hardway.py`.  Given image features
(B, H, W, C) and audio features (B, C), both L2-normalized here:

    A    = <img[b], aud[b]>        per pixel          -> (B, H, W) heatmap
    A0   = <img[b], aud[k]>        all pairs          -> (B, HW, K)
    Pos  = sigmoid((A - eps) / tau)
    Neg  = 1 - sigmoid((A - eps2) / tau)   (tri-map) or 1 - Pos
    PosA = sigmoid((A0 - eps) / tau)
    sim1 = pooled(Pos * A)   / pooled(Pos)             -> (B, 1)
    sim  = pooled(PosA * A0) / pooled(PosA) * mask     -> (B, K),
           mask = 1 - 100*I (pushes own-pair column out of the negatives)
    sim2 = pooled(Neg * A)   / pooled(Neg)             -> (B, 1)
    logits = concat(sim1, sim, sim2) / temperature     -> (B, K + 2)

  plus the Pos-weighted feature map used by the consistency losses:
    weighted = mean_c(img * Pos/||Pos||_2(spatial))    -> (B, H, W)

The pairwise tensor A0 is one batched `torch.matmul` (it lies outside any
hand-written kernel in the JAX package too).  The head runs in float32
whatever the backbone's dtype: sigmoid((A-0.65)/0.03) is numerically touchy
in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class HardwayConfig:
    epsilon: float = 0.65      # positive threshold
    epsilon2: float = 0.4      # negative threshold (tri-map)
    tau: float = 0.03          # tri-map sharpness
    temperature: float = 0.07  # logit temperature
    trimap: bool = True        # Neg from epsilon2 (vs 1 - Pos)
    use_neg: bool = True       # append sim2 column
    mask_penalty: float = 100.0
    pool_block: int = 0        # >0: restrict the negative pool to contiguous
    #                            blocks of this size (per-replica pool
    #                            semantics under a contiguously sharded
    #                            global batch; 0 = global pool)


class HardwayOutput(NamedTuple):
    heatmap: torch.Tensor       # (B, H, W) raw cosine similarity map A
    logits: torch.Tensor        # (B, K+2) contrastive logits (target class 0)
    weighted_map: torch.Tensor  # (B, H, W) Pos-weighted mean feature map
    pos: torch.Tensor           # (B, H, W) soft positive mask
    neg: torch.Tensor           # (B, H, W) soft negative mask


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def global_pool_mask(b: int, k: int, offset: int | torch.Tensor,
                     penalty: float = 100.0, dtype: torch.dtype = torch.float32,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """(B, K) negative-pool mask for an explicitly gathered key set.

    Row i's own-pair column sits at `offset + i` within the K keys (offset =
    shard_index * B under an all-gathered pool); that column gets the same
    `1 - penalty` exclusion the own-pool head applies to the diagonal.
    """
    rows = torch.arange(b, device=device) + offset
    own = torch.arange(k, device=device)[None, :] == rows[:, None]
    one = torch.ones((), dtype=dtype, device=device)
    return torch.where(own, one - penalty, one)


def hardway_head(
    img_feats: torch.Tensor,
    aud_feats: torch.Tensor,
    cfg: HardwayConfig = HardwayConfig(),
    aud_all: torch.Tensor | None = None,
    pool_offset: int | torch.Tensor = 0,
) -> HardwayOutput:
    """Compute the hard-way similarity heatmap + contrastive logits.

    img_feats:   (B, H, W, C) image/video-frame features (not yet normalized)
    aud_feats:   (B, C) audio features (not yet normalized)
    aud_all:     (K, C) negative pool; defaults to aud_feats. When the batch
                 is sharded over devices, pass the all-gathered pool here
                 for a global negative set.
    pool_offset: index of this shard's first own-pair column within aud_all
                 (shard_index * B); only meaningful with aud_all.
    """
    b, h, w, c = img_feats.shape
    img = l2_normalize(img_feats.to(torch.float32), dim=-1)
    aud = l2_normalize(aud_feats.to(torch.float32), dim=-1)
    keys = aud if aud_all is None else l2_normalize(aud_all.to(torch.float32), dim=-1)
    k = keys.shape[0]

    img_flat = img.reshape(b, h * w, c)
    # the one big product: every pixel of every image against every audio
    a0 = torch.matmul(img_flat, keys.t())                  # (B, HW, K)
    a = torch.einsum("bqc,bc->bq", img_flat, aud)          # (B, HW) own pair

    pos = torch.sigmoid((a - cfg.epsilon) / cfg.tau)
    if cfg.trimap:
        neg = 1.0 - torch.sigmoid((a - cfg.epsilon2) / cfg.tau)
    else:
        neg = 1.0 - pos
    pos_all = torch.sigmoid((a0 - cfg.epsilon) / cfg.tau)

    sim1 = (pos * a).sum(-1, keepdim=True) / pos.sum(-1, keepdim=True)   # (B, 1)
    sim = (pos_all * a0).sum(1) / pos_all.sum(1)                         # (B, K)
    if k == b:
        # own-pair diagonal: the multiplicative (1 - 100) trick — safe
        # because own-pair sims train positive
        sim = sim * (1.0 - cfg.mask_penalty * torch.eye(b, dtype=sim.dtype,
                                                        device=sim.device))
        if cfg.pool_block and cfg.pool_block < b:
            # per-block negative pool: columns outside the sample's block do
            # not exist on a per-replica pool, so they are pinned to a large
            # negative sim (softmax weight ~0).  NOT the multiplicative
            # diagonal trick: cross-pair sims train negative, and
            # (neg)*(1-100) would flip them into dominant positives.
            blk = torch.arange(b, device=sim.device) // cfg.pool_block
            same_block = blk[:, None] == blk[None, :]
            sim = torch.where(same_block, sim,
                              torch.full_like(sim, -cfg.mask_penalty))
    else:
        # explicitly gathered pool: row i's own column sits at pool_offset + i
        sim = sim * global_pool_mask(b, k, pool_offset, cfg.mask_penalty,
                                     sim.dtype, sim.device)
    sim2 = (neg * a).sum(-1, keepdim=True) / neg.sum(-1, keepdim=True)   # (B, 1)

    cols = (sim1, sim, sim2) if cfg.use_neg else (sim1, sim)
    logits = torch.cat(cols, dim=1) / cfg.temperature

    # Pos-weighted feature map (consistency-loss input)
    pos_map = pos.reshape(b, h, w)
    pos_norm = torch.linalg.vector_norm(pos, dim=-1).clamp_min(1e-12)
    norm_pos = pos_map / pos_norm[:, None, None]
    weighted = (img * norm_pos[..., None]).mean(dim=-1)                  # (B, H, W)

    return HardwayOutput(
        heatmap=a.reshape(b, h, w),
        logits=logits,
        weighted_map=weighted,
        pos=pos_map,
        neg=neg.reshape(b, h, w),
    )
