"""Video Swin-B with 3-D shifted-window attention: a tube encoder for
FullModel (PyTorch).

Liu et al., "Video Swin Transformer" (CVPR 2022, arXiv:2106.13230); the
equations of the official `mmaction/models/backbones/swin_transformer.py`
(`SwinTransformer3D`, `BasicLayer`, `SwinTransformerBlock3D`,
`WindowAttention3D`, `PatchMerging`, `compute_mask`, `get_window_size`) at
Swin-B's published widths: embedding 128, depths (2, 2, 18, 2), heads (4,
8, 16, 32) of 32, window (8, 7, 7) shifted by (4, 3, 3) in every odd block,
MLP ratio 4 with exact GELU, a `qkv` bias, LayerNorm eps 1e-5, a patch
norm, 2x2 patch merging.

With tokens x (B, D, H, W, C), channels last between blocks:

  embedding  each frame's 4x4/4 patches through one linear map (the
             (1, 4, 4) convolution 3 -> C as a product over 48-long patch
             vectors), then `patch_embed.norm`;
  block      x = x + proj(W-MSA(norm1(x))), x = x + fc2(GELU(fc1(norm2(x))));
             in an odd block the windows are those of x rolled by -shift,
             and tokens that come from different regions of the rolled grid
             do not attend to each other (-100 added, `window_mask`);
  W-MSA      per window of N = 8 * 7 * 7 = 392 tokens and per head,
             softmax(q k^T / sqrt(32) + B) v, B the head's relative-position
             bias: a learned table of (2*8-1)(2*7-1)(2*7-1) = 2,535 rows
             gathered by each token pair's offset (`relative_position_index`);
  merging    after stages 1 and 2 each 2x2 neighbourhood's 4C channels,
             LayerNorm(4C) and a bias-free 4C -> 2C map; after stage 3
             LayerNorm(C) and a bias-free C -> 2C map on each token;
  output     `norm`, then with `proj_dim` a bias-free Linear `proj` and a
             ReLU, (B, T, H/16, W/16, proj_dim).

Departures from the official model, each for FullModel's one 14x14 map a
frame: the tubelet is (1, 4, 4), not (2, 4, 4), so that 16 frames make the
recipe's 16 x 56 x 56 token grid, its windows and its 3-D shift, with one
output a frame; the last merge keeps the 14x14 grid (stride 1, as the tube
model keeps ResNet layer4 at stride 1), where stage 4 then has 2 x 2 x 2
windows and shifts; `proj` and its ReLU give the head its 512 non-negative
features, as `models/timesformer.py` explains.  No dropout, no stochastic
depth, no classification head.  Where a stage's grid is no larger than the
window along an axis the window is clipped to it and that axis is not
shifted (`get_window_size`); a grid the windows do not divide raises (the
official code pads it).  The parameters start as N(0, 0.02) for every
Linear, the patch embedding and the bias tables, with zero biases and
LayerNorm (1, 0).

The linear maps act on each token alone, so x stays in its grid's order
and only q, k and v are laid out by window: the official roll and window
partition, applied once to the grid's token numbers (`window_layout`,
cached a tower per grid, rolling and width), make one gather of `qkv`'s
32-wide rows into (3, B, windows * heads, N, 32), and one gather of the
attention's output back, each with the inverse gather for its gradient; no
tensor is rolled.  The bias (relative position, plus the mask in a shifted
block) is one (1, windows * heads, N, N) tensor broadcast over the batch;
on a card the attention runs on PyTorch's memory-efficient SDPA, which
stores no attention matrix.  Compute dtype as in `models/timesformer.py`:
float32 parameters cast per call.  Spans (`utils/debug.py::span`): each
block's `vid.window_attn` (norm1, shift and partition, attention, reverse,
residual) and `vid.mlp`, and each merge's `vid.merge`.  `COUNTS` counts the
layouts built and found in a tower's cache and the window-attention calls
by path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from avtubes_torch.models.resnet2d import compute_dtype_of
from avtubes_torch.models.timesformer import Mlp, _linear, _norm
from avtubes_torch.utils.debug import span

#: the published widths of Video Swin-B
EMBED_DIM, DEPTHS, HEADS, WINDOW, MLP_RATIO, PATCH, LN_EPS = (
    128, (2, 2, 18, 2), (4, 8, 16, 32), (8, 7, 7), 4, 4, 1e-5)
#: the spatial stride of the merge after stages 1-3 (the last one keeps 14x14)
MERGE_STRIDES = (2, 2, 1)
INIT_STD = 0.02
#: what `compute_mask` adds between tokens of different regions
MASK_FILL = -100.0

#: this process's window layouts (token orders, and the mask of a shifted
#: grid) built and found in a tower's cache, and its window-attention calls
#: by path: 'fused' (SDPA's memory-efficient kernel on a card) or 'plain'
#: (SDPA's own choice off one); plain ints, which the tests and the card
#: read and may reset
COUNTS = {"layout_builds": 0, "layout_hits": 0, "fused": 0, "plain": 0}


def window_and_shift(grid, window, shift) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """`get_window_size`: the window clipped to the grid, and no shift along
    an axis where the grid is no larger than the window."""
    return (tuple(min(g, w) for g, w in zip(grid, window)),
            tuple(0 if g <= w else s for g, w, s in zip(grid, window, shift)))


def relative_position_index(window) -> torch.Tensor:
    """(N, N) int64: each token pair's row of the bias table, as the
    official `WindowAttention3D` builds it."""
    wd, wh, ww = window
    coords = torch.stack(torch.meshgrid(torch.arange(wd), torch.arange(wh), torch.arange(ww),
                                        indexing="ij")).flatten(1)             # (3, N)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)             # (N, N, 3)
    rel = rel + torch.tensor([wd - 1, wh - 1, ww - 1])
    return (rel * torch.tensor([(2 * wh - 1) * (2 * ww - 1), 2 * ww - 1, 1])).sum(-1)


def _partition(t: torch.Tensor, window) -> torch.Tensor:
    """`window_partition` of a (D, H, W) grid: (windows, N)."""
    (gd, gh, gw), (wd, wh, ww) = t.shape, window
    return (t.view(gd // wd, wd, gh // wh, wh, gw // ww, ww).permute(0, 2, 4, 1, 3, 5)
            .reshape(-1, wd * wh * ww))


def window_mask(grid, window, shift, device) -> torch.Tensor:
    """`compute_mask`: (windows, N, N) float32, 0 between tokens of one
    region of the rolled grid and -100 across regions."""
    regions = torch.zeros(grid, device=device)
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(window, shift)]
    n = 0
    for d in cuts[0]:
        for h in cuts[1]:
            for w in cuts[2]:
                regions[d, h, w] = n
                n += 1
    windows = _partition(regions, window)
    differ = windows[:, None, :] != windows[:, :, None]
    return torch.zeros(differ.shape, device=device).masked_fill_(differ, MASK_FILL)


class WindowLayout(NamedTuple):
    """Where each window's tokens lie in a grid of one stage, for one
    rolling (`window_layout`): row orders of permutations and their
    inverses, and the mask of a shifted grid."""

    windows: int
    tokens: int                 # N, a window's tokens
    qkv_order: torch.Tensor     # rows (grid token, q|k|v, head) in (q|k|v, window, head, N) order
    qkv_inverse: torch.Tensor
    out_order: torch.Tensor     # the rows (N, window, head) in (grid token, head) order
    out_inverse: torch.Tensor
    mask: torch.Tensor | None   # (windows, N, N) float32, or None unshifted


def _inverse(order: torch.Tensor) -> torch.Tensor:
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    return inverse


def window_layout(grid, window, shift, heads: int, device) -> WindowLayout:
    """The official `torch.roll` by -shift and `window_partition`, applied
    to the grid's token numbers: the partition of each head's q, k and v
    into windows as one gather of 32-wide rows, and the reverse (with the
    roll back) as another."""
    tok = torch.arange(math.prod(grid), device=device).view(grid)
    if any(shift):
        tok = torch.roll(tok, [-s for s in shift], dims=(0, 1, 2))
    tok = _partition(tok, window)                                       # tok[window, i]
    windows, n = tok.shape
    head = torch.arange(heads, device=device)
    part = torch.arange(3, device=device)
    qkv_order = ((tok[None, :, None, :] * 3 + part[:, None, None, None]) * heads
                 + head[None, None, :, None]).flatten()
    # attention's output is token-major: row (i, window, head)
    src = ((torch.arange(n, device=device)[None, :, None] * windows
            + torch.arange(windows, device=device)[:, None, None]) * heads + head)
    out_order = torch.empty(tok.numel() * heads, dtype=torch.int64, device=device)
    out_order[(tok[:, :, None] * heads + head).flatten()] = src.flatten()
    return WindowLayout(windows, n, qkv_order, _inverse(qkv_order), out_order,
                        _inverse(out_order),
                        window_mask(grid, window, shift, device) if any(shift) else None)


class _PermuteRows(torch.autograd.Function):
    """x.index_select(1, order) for a permutation `order` of x's rows; the
    gradient is the gather by the inverse permutation (no scatter-add)."""

    @staticmethod
    def forward(ctx, x, order, inverse):
        ctx.save_for_backward(inverse)
        return x.index_select(1, order)

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return grad.index_select(1, inverse), None, None


def attend_windows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh) + bias) v over (S, H, N, dh) tensors, the
    bias (1, H, N, N) broadcast over S.  On a card the memory-efficient
    kernel, which takes an additive bias and its gradient and stores no
    attention matrix; off one, SDPA's own choice."""
    if not q.is_cuda:
        COUNTS["plain"] += 1
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    COUNTS["fused"] += 1
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


class WindowAttention3D(nn.Module):
    """Multi-head self-attention within 3-D windows, with a learned
    relative-position bias a head."""

    def __init__(self, dim: int, heads: int, window: tuple[int, int, int]):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(math.prod(2 * w - 1 for w in window), heads))
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def position_bias(self, n: int) -> torch.Tensor:
        """(heads, n, n) float32: the table's rows for the first n tokens'
        pairs (the official `relative_position_index[:N, :N]`)."""
        idx = self.relative_position_index[:n, :n]
        return F.embedding(idx, self.relative_position_bias_table).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, layout: WindowLayout) -> torch.Tensor:
        """x (B, D, H, W, C), normalised, in the grid's own order; q, k and
        v of each window and head gathered by `layout`, the output
        gathered back."""
        b, d, h, w, c = x.shape
        heads, n, rows = self.heads, layout.tokens, layout.windows * self.heads
        qkv = _linear(x, self.qkv).view(b, -1, c // heads)             # rows (token, q|k|v, head)
        q, k, v = (_PermuteRows.apply(qkv, layout.qkv_order, layout.qkv_inverse)
                   .view(b, 3, rows, n, c // heads).unbind(1))
        rel = self.position_bias(n)
        bias = (rel.expand(layout.windows, heads, n, n) if layout.mask is None
                else rel + layout.mask[:, None])
        o = attend_windows(q, k, v, bias.to(x.dtype).reshape(1, rows, n, n))
        o = o.transpose(1, 2).reshape(b, n * rows, c // heads)           # rows (N, window, head)
        o = _PermuteRows.apply(o, layout.out_order, layout.out_inverse)
        return _linear(o.view(b, d, h, w, c), self.proj)


class Block(nn.Module):
    """One Swin block; shifted when `shifted` (every odd block of a stage)."""

    def __init__(self, dim: int, heads: int, window: tuple[int, int, int], mlp_ratio: int,
                 shifted: bool):
        super().__init__()
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention3D(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, layout: WindowLayout) -> torch.Tensor:
        """x (B, D, H, W, C); `layout` the stage's windows, rolled in a
        shifted block."""
        with span("vid.window_attn"):
            x = x + self.attn(_norm(x, self.norm1), layout)
        with span("vid.mlp"):
            return x + self.mlp(_norm(x, self.norm2))


class PatchMerging(nn.Module):
    """Stride 2: each 2x2 neighbourhood's channels (in the official order
    x0, x1, x2, x3 = (0, 0), (1, 0), (0, 1), (1, 1) of (h, w)), LayerNorm(4C)
    and a bias-free 4C -> 2C map; stride 1: LayerNorm(C) and C -> 2C."""

    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.stride = stride
        self.norm = nn.LayerNorm(stride * stride * dim, eps=LN_EPS)
        self.reduction = nn.Linear(stride * stride * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            b, d, h, w, c = x.shape
            x = (x.view(b, d, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 5, 3, 6)
                 .reshape(b, d, h // 2, w // 2, 4 * c))
        return _linear(_norm(x, self.norm), self.reduction)


class Stage(nn.Module):
    """The official `BasicLayer`: blocks, alternately unshifted and
    shifted, then the merge (or none)."""

    def __init__(self, dim: int, depth: int, heads: int, window: tuple[int, int, int],
                 mlp_ratio: int, merge_stride: int | None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, heads, window, mlp_ratio, i % 2 == 1)
                                    for i in range(depth))
        self.downsample = None if merge_stride is None else PatchMerging(dim, merge_stride)


class PatchEmbed3D(nn.Module):
    """The (1, p, p) convolution 3 -> C, kept as the official `proj`, and
    the patch norm."""

    def __init__(self, patch: int, channels: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv3d(channels, dim, (1, patch, patch), stride=(1, patch, patch))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) clips -> (B, T, H/p, W/p, D): each patch's
        (c, kh, kw) vector through the convolution's weight, one product
        over all patches."""
        b, t, h, w, c = x.shape
        p = self.patch
        patches = (x.reshape(b * t, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
                   .reshape(-1, c * p * p))
        weight = self.proj.weight.to(x.dtype).view(self.proj.out_channels, c * p * p)
        out = F.linear(patches, weight, self.proj.bias.to(x.dtype))
        return _norm(out.view(b, t, h // p, w // p, -1), self.norm)


class Swin3D(nn.Module):
    """Headless Video Swin-B: (B, T, H, W, 3) -> (B, T, H/16, W/16, 1024),
    or `proj_dim` wide, in `compute_dtype`, for clips of exactly `frames`
    frames at `image_size`.  `generator` seeds the init; None uses torch's
    global generator."""

    def __init__(self, image_size: int = 224, frames: int = 16, dim: int = EMBED_DIM,
                 depths: tuple[int, ...] = DEPTHS, heads: tuple[int, ...] = HEADS,
                 window: tuple[int, int, int] = WINDOW, mlp_ratio: int = MLP_RATIO,
                 patch: int = PATCH, merge_strides: tuple[int, ...] = MERGE_STRIDES,
                 proj_dim: int | None = None, generator: torch.Generator | None = None,
                 compute_dtype: str | torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.image_size, self.frames, self.window = image_size, frames, tuple(window)
        self.shift = tuple(w // 2 for w in window)
        #: the one frame count this tower takes (`FullModel.clip_frames`)
        self.clip_frames = frames
        self._check_grids(image_size, frames, patch, merge_strides, len(depths))
        self.patch_embed = PatchEmbed3D(patch, 3, dim)
        self.layers = nn.ModuleList(
            Stage(dim * 2 ** i, depth, heads[i], self.window, mlp_ratio,
                  merge_strides[i] if i < len(merge_strides) else None)
            for i, depth in enumerate(depths))
        self.norm = nn.LayerNorm(dim * 2 ** (len(depths) - 1), eps=LN_EPS)
        self.proj = None if proj_dim is None else nn.Linear(self.norm.normalized_shape[0],
                                                            proj_dim, bias=False)
        self._layouts: dict = {}
        self.reset_parameters(generator)

    def _check_grids(self, image_size, frames, patch, merge_strides, stages) -> None:
        """Each stage's token grid against its windows and its merge."""
        if image_size % patch:
            raise ValueError(f"image_size {image_size} is not a multiple of the patch {patch}")
        grid = (frames, image_size // patch, image_size // patch)
        for i in range(stages):
            window, _ = window_and_shift(grid, self.window, self.shift)
            if any(g % w for g, w in zip(grid, window)):
                raise ValueError(f"stage {i + 1}'s token grid {grid} (clips of {frames} frames "
                                 f"at {image_size}^2) is not divided by its window {window}")
            s = merge_strides[i] if i < len(merge_strides) else 1
            if grid[1] % s or grid[2] % s:
                raise ValueError(f"stage {i + 1}'s grid {grid} does not merge at stride {s}")
            grid = (grid[0], grid[1] // s, grid[2] // s)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                m.weight.normal_(0.0, INIT_STD, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention3D):
                m.relative_position_bias_table.normal_(0.0, INIT_STD, generator=generator)

    def _layout(self, grid, window, shift, heads, device) -> WindowLayout:
        key = (grid, window, shift, heads, device)
        if key in self._layouts:
            COUNTS["layout_hits"] += 1
        else:
            COUNTS["layout_builds"] += 1
            self._layouts[key] = window_layout(grid, window, shift, heads, device)
        return self._layouts[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        want = (self.frames, self.image_size, self.image_size, 3)
        if x.ndim != 5 or tuple(x.shape[1:]) != want:
            raise ValueError(f"Swin3D takes clips (B, {', '.join(map(str, want))}), the "
                             f"frames and size its windows were laid out for; got "
                             f"{tuple(x.shape)}")
        x = self.patch_embed(x.to(self.compute_dtype))
        for stage in self.layers:
            grid = tuple(x.shape[1:4])
            window, shift = window_and_shift(grid, self.window, self.shift)
            heads = stage.blocks[0].attn.heads
            plain = self._layout(grid, window, (0, 0, 0), heads, x.device)
            shifted = self._layout(grid, window, shift, heads, x.device) if any(shift) else plain
            for block in stage.blocks:
                x = block(x, shifted if block.shifted else plain)
            if stage.downsample is not None:
                with span("vid.merge"):
                    x = stage.downsample(x)
        x = _norm(x, self.norm)
        if self.proj is not None:
            x = torch.relu(_linear(x, self.proj))
        return x
