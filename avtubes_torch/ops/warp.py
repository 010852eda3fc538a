"""Bilinear warping: `flow_warp` and a `grid_sample` in the JAX package's layout.

Counterpart of `avtubes/ops/warp.py`: bilinear sampling written out as four
gathers and a weighted sum, differentiable with respect to the image and to
the coordinates.  It is not `torch.nn.functional.grid_sample`, on purpose:

  * the JAX package clips each corner's *index* and keeps the weights of the
    un-clipped coordinate; torch's ``border`` mode clips the *coordinate*.
    The values agree, but the gradient with respect to the flow does not: at
    a coordinate of exactly 0 torch's is zero and this one is
    ``img[1] - img[0]``, and a flow of exactly zero at the first column is
    what an untrained flow head produces;
  * `flow_warp` would have to go through normalized coordinates
    (``2 x / (W - 1) - 1`` and back), which in float32 moves a coordinate by
    ~1e-5 px at W = 224 — enough to put an integer coordinate in the
    neighbouring cell, whose slope is another.

Layout: channels last, (B, H, W, C), as in the JAX package.
"""

from __future__ import annotations

import torch


def _gather_bilinear(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                     padding_mode: str) -> torch.Tensor:
    """img (B, H, W, C); sy, sx (B, Ho, Wo) absolute pixel coordinates ->
    (B, Ho, Wo, C)."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"padding_mode must be 'border' or 'zeros', got {padding_mode!r}")
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0).unsqueeze(-1)
    wx = (sx - x0).unsqueeze(-1)
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    def sample(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        index = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1, 1)
        vals = torch.gather(flat, 1, index.expand(-1, -1, c)).reshape(*yi.shape, c)
        if padding_mode == "zeros":
            inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            vals = vals * inside.unsqueeze(-1).to(vals.dtype)
        return vals

    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)
    return ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
            + wy * (1 - wx) * v10 + wy * wx * v11)


def flow_warp(img: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "border") -> torch.Tensor:
    """Warp img (B, H, W, C) by flow (B, H, W, 2) of (dx, dy) pixel offsets:
    out[b, i, j] = img[b, i + flow[..., 1], j + flow[..., 0]] (bilinear)."""
    _, h, w, _ = img.shape
    yy = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    xx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    return _gather_bilinear(img, yy + flow[..., 1], xx + flow[..., 0], padding_mode)


def grid_sample(img: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """`torch.nn.functional.grid_sample` (bilinear) in channels-last layout.

    img: (B, H, W, C); grid: (B, Ho, Wo, 2) normalized coordinates in [-1, 1],
    grid[..., 0] = x, grid[..., 1] = y.
    """
    _, h, w, _ = img.shape

    def unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
        if align_corners:
            return (coord + 1.0) / 2.0 * (size - 1)
        return ((coord + 1.0) * size - 1.0) / 2.0

    return _gather_bilinear(img, unnormalize(grid[..., 1], h),
                            unnormalize(grid[..., 0], w), padding_mode)
