"""Compact FlowNet-C-style optical flow estimator (PyTorch).

Counterpart of `avtubes/models/flownet.py`: siamese conv encoders, a
normalized correlation cost volume at 1/8 resolution
(`avtubes_torch.ops.correlation`, the hand-written CUDA kernels on the
card), a soft-argmax flow prior (expected displacement under a softmax over
the volume) and a small conv trunk that regresses a residual.

Output convention: `flow_warp(im1, net(im1, im2)) ~ im2` (backward warp).

Layout: the public interface is channels last like the JAX package,
(B, H, W, 3) frames in and a (B, H, W, 2) flow of (dx, dy) pixels out.  The
convolutions see (B, C, H, W) views of channels-last storage; the cost volume
takes and gives (B, h/8, w/8, ·), so the softmax over the displacement axis
and the concat with the features need no transpose.  float32 only.

Sub-modules carry the flax names (`encoder.conv{1,2,3}`, `dec{1..4}`,
`flow_head`, `corr_temp`), so `core/convert.py::flownet_from_flax` is a
rename plus the HWIO -> OIHW transpose.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from avtubes_torch.ops.correlation import correlation_cost_volume

_ENCODER = ((32, 5), (64, 3), (96, 3))   # (channels, kernel), all stride 2
_DECODER = (128, 96, 64, 32)
_SLOPE = 0.1


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of flax/XLA ``padding="SAME"`` along one axis:
    the output has ceil(size / stride) entries and an odd total goes after.
    At stride 2 on an even size that is (1, 2) for a 5-tap and (0, 1) for a
    3-tap kernel — not what a symmetric `padding=` gives."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _Encoder(nn.Module):
    """(B, 3, H, W) -> (B, 96, ceil(H/8), ceil(W/8)); three stride-2 convs
    with SAME padding and leaky ReLU."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, k) in enumerate(_ENCODER):
            setattr(self, f"conv{i + 1}", nn.Conv2d(cin, ch, k, stride=2, bias=True))
            cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (_, k) in enumerate(_ENCODER):
            top, bottom = same_padding(x.shape[2], k, 2)
            left, right = same_padding(x.shape[3], k, 2)
            x = F.pad(x, (left, right, top, bottom))
            x = F.leaky_relu(getattr(self, f"conv{i + 1}")(x), _SLOPE)
        return x


class FlowNetLite(nn.Module):
    """(im1, im2), (B, H, W, 3) each -> flow (B, H, W, 2) in pixels (dx, dy).

    `impl` selects the cost volume: 'kernel' (the CUDA kernels for tensors on
    the card, the plain version only for CPU tensors) or 'plain'.
    `generator` seeds the init; None uses torch's global generator.
    """

    def __init__(self, max_disp: int = 4, impl: str = "kernel",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_disp = max_disp
        self.impl = impl
        self.encoder = _Encoder()
        n = 2 * max_disp + 1
        cin = n * n + _ENCODER[-1][0]
        for i, ch in enumerate(_DECODER):
            setattr(self, f"dec{i + 1}", nn.Conv2d(cin, ch, 3, padding=1, bias=True))
            cin = ch
        self.flow_head = nn.Conv2d(cin, 2, 3, padding=1, bias=True)
        self.corr_temp = nn.Parameter(torch.full((1,), 10.0))
        # channel k = iy * n + ix over (dy, dx) in [-r, r]^2, dy outer
        disp = torch.arange(-max_disp, max_disp + 1, dtype=torch.float32)
        self.register_buffer("dys", disp.repeat_interleave(n), persistent=False)
        self.register_buffer("dxs", disp.repeat(n), persistent=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """He fan-out normal kernels, zero biases, a zero flow head (the net
        starts as its soft-argmax prior) and a softmax temperature of 10."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                m.bias.zero_()
        self.flow_head.weight.zero_()
        self.corr_temp.fill_(10.0)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        if im1.ndim != 4 or im1.shape[-1] != 3 or im1.shape != im2.shape:
            raise ValueError(f"expected two (B, H, W, 3) frames, got "
                             f"{tuple(im1.shape)} and {tuple(im2.shape)}")
        h, w = im1.shape[1], im1.shape[2]
        f1 = self.encoder(im1.float().permute(0, 3, 1, 2))
        f2 = self.encoder(im2.float().permute(0, 3, 1, 2))
        c = f1.shape[1]
        # spatially centre, then L2-normalize: random conv features carry a
        # large DC component that flattens the softmax below
        f1 = f1 - f1.mean(dim=(2, 3), keepdim=True)
        f2 = f2 - f2.mean(dim=(2, 3), keepdim=True)
        # eps INSIDE the root: the gradient of a norm at exactly-zero
        # features is 0/0
        f1n = f1 * torch.rsqrt((f1 * f1).sum(dim=1, keepdim=True) + 1e-12)
        f2n = f2 * torch.rsqrt((f2 * f2).sum(dim=1, keepdim=True) + 1e-12)
        corr = correlation_cost_volume(
            f1n.permute(0, 2, 3, 1), f2n.permute(0, 2, 3, 1),
            self.max_disp, 1, impl=self.impl) * c                   # (B, h8, w8, D)

        # soft-argmax prior: a peak at displacement d means content moved
        # im1 -> im2 by +d, so the backward-warp flow is -d
        prob = torch.softmax(corr * self.corr_temp, dim=-1)
        prior = -torch.stack([(prob * self.dxs).sum(-1), (prob * self.dys).sum(-1)],
                             dim=1)                                 # (B, 2, h8, w8) cells

        x = torch.cat([F.leaky_relu(corr, _SLOPE), f1.permute(0, 2, 3, 1)], dim=-1)
        x = x.permute(0, 3, 1, 2)                                   # NHWC storage
        for i in range(len(_DECODER)):
            x = F.leaky_relu(getattr(self, f"dec{i + 1}")(x), _SLOPE)
        flow8 = prior + self.flow_head(x)                           # cells at 1/8 res

        h8, w8 = flow8.shape[2], flow8.shape[3]
        # half-pixel-centred bilinear, as jax.image.resize(method="linear") up
        flow = F.interpolate(flow8, size=(h, w), mode="bilinear", align_corners=False)
        # cells -> pixels per axis: channel 0 is dx (width ratio), 1 is dy
        return torch.stack([flow[:, 0] * (w / w8), flow[:, 1] * (h / h8)], dim=-1)
