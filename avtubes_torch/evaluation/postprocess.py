"""Heatmap -> binary localization mask postprocess (PyTorch).

Counterpart of `avtubes/evaluation/postprocess.py`: 14x14 heatmap ->
bilinear resize to 224x224 -> min-max normalize -> binarize at the median
pixel (the value at sorted index H*W/2), keeping pixels strictly above it.

`F.interpolate(mode="bilinear", align_corners=False)` on an upsample is
half-pixel-centred bilinear interpolation with edge clamping — the same
function as cv2's INTER_LINEAR and `jax.image.resize(method="linear")`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMG = 224


def normalize_minmax(x):
    """Min-max normalize to [0,1]; a constant input is returned unchanged.
    Takes a numpy array or a tensor."""
    xmin, xmax = x.min(), x.max()
    if isinstance(x, np.ndarray):
        if xmax - xmin == 0:
            return x
        return (x - xmin) / (xmax - xmin)
    span = xmax - xmin
    return torch.where(span == 0, x, (x - xmin) / torch.where(span == 0, 1.0, span))


def _resize_bilinear(heatmaps: torch.Tensor, size: int) -> torch.Tensor:
    """(B, h, w) float32 -> (B, size, size), half-pixel centres."""
    return F.interpolate(heatmaps[:, None], size=(size, size), mode="bilinear",
                         align_corners=False)[:, 0]


def heatmap_to_mask(heatmap: np.ndarray, size: int = IMG) -> np.ndarray:
    """Host (numpy) reference postprocess for one heatmap, written the long
    way round, as the original evaluation scripts do: negate, min-max normalize,
    pred = 1 - that, full sort for the median.

    Returns a {0,1} float map of shape (size, size).  A CONSTANT heatmap
    returns all zeros: it carries no localization evidence, and this keeps
    the host and the batched path equal per sample.
    """
    h = _resize_bilinear(
        torch.from_numpy(np.asarray(heatmap, np.float32))[None], size)[0].numpy()
    if h.max() - h.min() == 0:
        return np.zeros((size, size), np.float32)
    h = normalize_minmax(-h)
    pred = 1.0 - h
    flat = np.sort(pred.flatten())
    threshold = flat[int(size * size * 0.5)]
    out = pred.copy()
    out[out > threshold] = 1.0
    out[out < 1.0] = 0.0
    return out


def heatmap_to_mask_batch(heatmaps: torch.Tensor, size: int = IMG,
                          impl: str = "kernel") -> torch.Tensor:
    """Batched postprocess: (B, h, w) heatmaps -> (B, size, size) {0,1} masks.

    Matches `heatmap_to_mask` per sample; the median is the value at sorted
    index size*size/2 per map, and the mask keeps pixels strictly above it
    plus pixels exactly at the normalized max (the host path's
    `out[out < 1.0] = 0` spares them even when the median is 1.0).  The k-th
    value comes from the exact bit-space bisection of
    `avtubes_torch.ops.median_select` — the CUDA kernel for a tensor on the
    card, its plain version on the CPU (`impl` as in `median_mask`).
    """
    from avtubes_torch.ops.median_select import median_mask

    b = heatmaps.shape[0]
    up = _resize_bilinear(heatmaps.to(torch.float32), size)
    flat = up.reshape(b, -1)
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    denom = torch.where(hi - lo == 0, 1.0, hi - lo)
    pred = ((flat - lo) / denom).reshape(b, size, size)
    mask = median_mask(pred, k=size * size // 2, impl=impl)
    # pixels EQUAL to 1.0 stay even when the median itself is 1.0 (a >50%
    # plateau at the max) — the strictly-greater mask alone would drop them.
    # Constant maps are unaffected: their pred is identically 0.
    return torch.where(pred == 1.0, 1.0, mask)
