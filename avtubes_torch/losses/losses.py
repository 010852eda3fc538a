"""Loss functions of the hard-way objective (PyTorch).

Counterpart of `avtubes/losses/losses.py`, function for function:
  * hardway_loss      — cross-entropy against class 0, log-softmax in float32
  * propagation_loss  — temporal smoothness of (B, T, H, W) maps
  * np_ratio_loss     — stability of the positive area over time
  * flip_loss         — horizontal-flip equivariance, L1
  * consistency_l2    — MSE between the clean and augmented weighted maps
"""

from __future__ import annotations

import torch


def hardway_loss(logits: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with target class 0 for every row.

    Class 0 is the Pos-pooled own-pair similarity column; the model must push
    it above every cross-pair (and the Neg-pooled own-image) similarity.
    """
    logz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logz[:, 0].mean()


def propagation_loss(heatmaps: torch.Tensor) -> torch.Tensor:
    """Mean absolute temporal gradient of (B, T, H, W) maps."""
    d = torch.diff(heatmaps, dim=1).abs()
    return d.mean(dim=(2, 3)).mean(dim=1).mean()


def np_ratio_loss(heatmaps: torch.Tensor) -> torch.Tensor:
    """Mean absolute temporal change of total heatmap mass, (B, T, H, W)."""
    sums = heatmaps.sum(dim=(2, 3))
    return torch.diff(sums, dim=1).abs().mean(dim=1).mean()


def flip_loss(heatmap: torch.Tensor, flipped_heatmap: torch.Tensor) -> torch.Tensor:
    """L1 between the flipped-input prediction and the horizontally flipped map.

    `heatmap` is the prediction on the original input, `flipped_heatmap` the
    prediction on the horizontally flipped input; the flip of the former is
    the pseudo-label for the latter.  Maps are (..., H, W).
    """
    pseudo = torch.flip(heatmap, dims=(-1,))
    return (flipped_heatmap - pseudo).abs().mean()


def consistency_l2(weighted_a: torch.Tensor, weighted_b: torch.Tensor) -> torch.Tensor:
    """MSE between Pos-weighted feature maps of two augmented views."""
    return ((weighted_a - weighted_b) ** 2).mean()
