"""T-preserving 3D ResNet video tube encoder (PyTorch).

Counterpart of `avtubes/models/resnet3d.py` (`BasicBlock3D`, `ResNet3D`), the
original r3d-18 as the 3D model instantiates it (depth 18, no max-pool):

  * stem: 7x7x7 conv, stride (1,2,2), padding 3, and no max-pool;
  * stages [64, 128, 256, 512] of two BasicBlocks each; every stage but the
    first opens with stride (1,2,2), so a (T, 224, 224) clip keeps all T
    steps and gives (T, 14, 14, 512): 224 -> stem/2 -> 112 -> layer2/2 -> 56
    -> layer3/2 -> 28 -> layer4/2 -> 14;
  * conv kernels use He fan-out initialization; BatchNorm keeps torch's
    constant-1 scale (no N(1, 0.02) noise: that re-init belongs to the 2D
    AVENet only), bias 0;
  * returns the feature tube directly: no classifier head.

Sub-modules carry the original PyTorch names (`conv1`, `bn1`,
`layer{L}.{B}.conv{1,2}`, `...bn{1,2}`, `...downsample.{0,1}`), so a
reference checkpoint crosses by a filter (`core/reference_checkpoint.py`)
and a flax tree by a rename (`core/convert.py::fullmodel_from_flax`).

Convolutions are plain `nn.Conv3d` (cuDNN on the card): the JAX package's
time-stacked lowerings (`TSConv3D`, `ops/conv3d.py`) only dodged XLA's
Conv3D code generation and are not ported.

Layout: the interface is NDHWC like the JAX package, (B, T, H, W, 3) in and
(B, T, H/16, W/16, 512) out.  Inside, activations and conv weights are NCDHW
with `memory_format=channels_last_3d` (NDHWC strides), so the permutes at
both ends are views.  Compute dtype as in `models/resnet2d.py`: the input
is cast to it, each convolution casts its float32 weight per call, and
BatchNorm on that input keeps float32 weight, bias and statistics: it is
`models/norm.py::BatchNorm3d`, `nn.BatchNorm3d` whose training statistics
are the global batch's whenever a process group is up, and which takes the
ReLU and the residual add after it (`bn(x, relu=True)`, `bn2(y, identity,
relu=True)`).  A bf16 tube trained on one card without a group runs each of
the 20 as the hand-written kernels of `ops/batchnorm.py` (statistics,
normalize + add + ReLU, and two backward kernels); float32, eval mode, the
CPU and the group path run `nn.BatchNorm3d`, `+`, `torch.relu` as before.

The stem's 3 input channels: in bf16 on the H100, cuDNN 9.22 (its heuristic,
the autotuner off) runs a 7x7x7 3-D convolution over 3, 8 or 16 channels as a
float32 SIMT implicit GEMM, and one over 32 as a slow sm80 kernel. So on CUDA
in a 16-bit dtype a 3-D convolution whose input channels are not a multiple
of 8 runs as a 2-D one (`conv3d_time_folded`): each output frame's temporal
taps are stacked in the channels, with zero-weighted taps added until the
channels are a multiple of 8 (7 + 1 frames x 3 = 24), which cuDNN takes on
the tensor cores. The extra taps add exact zeros, the parameter stays (64, 3,
7, 7, 7) float32, and autograd carries its gradient back through the fold.
Elsewhere the convolution is the plain one.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from avtubes_torch.models.norm import BatchNorm3d
from avtubes_torch.models.resnet2d import compute_dtype_of


def folded_channels(device: torch.device | str, dtype: torch.dtype, channels: int,
                    taps: int) -> int:
    """The input channels of the 2-D convolution that runs a 3-D one with
    `channels` inputs and `taps` temporal taps: `channels` times the fewest
    taps, `taps` or more, that make a multiple of 8 (16 bytes a pixel for
    cuDNN's tensor-core kernels). 0, the 3-D convolution as it is, off CUDA,
    outside bf16 and fp16, and where `channels` is a multiple of 8 already."""
    if (torch.device(device).type != "cuda" or dtype not in (torch.bfloat16, torch.float16)
            or channels % 8 == 0):
        return 0
    step = 8 // math.gcd(channels, 8)
    return channels * -(-taps // step) * step


def conv3d_time_folded(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                       padding: Sequence[int], channels: int) -> torch.Tensor:
    """`F.conv3d(x, w, None, stride, padding)` (groups and dilation 1) as a
    2-D convolution over each output frame's input frames stacked in its
    `channels`: the `kt` frames the kernel spans and after them as many as
    `channels` has room for, whose taps weigh zero. `x` is NCDHW in
    `channels_last_3d`; so is the result."""
    b, c, _, h, wd = x.shape
    o, _, kt, kh, kw = w.shape
    taps = channels // c
    frames = F.pad(x.permute(0, 2, 3, 4, 1),
                   (0, 0, 0, 0, 0, 0, padding[0], padding[0] + taps - kt))
    windows = frames.unfold(1, taps, stride[0]).transpose(-1, -2)   # (B, T', H, W, taps, C)
    t = windows.shape[1]
    stack = windows.reshape(b * t, h, wd, channels)                  # materialised
    w2 = F.pad(w, (0, 0, 0, 0, 0, taps - kt)).transpose(1, 2).reshape(o, channels, kh, kw)
    y = F.conv2d(stack.permute(0, 3, 1, 2), w2.contiguous(memory_format=torch.channels_last),
                 None, stride[1:], padding[1:])                      # (B*T', O, H', W') NHWC
    return y.permute(0, 2, 3, 1).unflatten(0, (b, t)).permute(0, 4, 1, 2, 3)


class Conv3d(nn.Conv3d):
    """`nn.Conv3d` that runs in its input's dtype: the (float32) weight is
    cast per call, so the parameter and its gradient stay float32. Where
    `folded_channels` says so, it runs as `conv3d_time_folded`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        folded = folded_channels(x.device, x.dtype, self.in_channels, self.kernel_size[0])
        if folded:
            return conv3d_time_folded(x, w, self.stride, self.padding, folded)
        return self._conv_forward(x, w, None)


def _conv(cin: int, cout: int, k: int, stride: tuple[int, int, int] = (1, 1, 1),
          pad: int = 0) -> Conv3d:
    return Conv3d(cin, cout, k, stride=stride, padding=pad, bias=False)


def _bn(features: int) -> BatchNorm3d:
    return BatchNorm3d(features, eps=1e-5, momentum=0.1)


class BasicBlock3D(nn.Module):
    """Two 3x3x3 convs with identity/projection shortcut."""

    def __init__(self, in_filters: int, filters: int,
                 stride: tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        self.conv1 = _conv(in_filters, filters, 3, stride, 1)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3, (1, 1, 1), 1)
        self.bn2 = _bn(filters)
        self.downsample = None
        if any(s != 1 for s in stride) or in_filters != filters:
            self.downsample = nn.Sequential(_conv(in_filters, filters, 1, stride),
                                            _bn(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.bn1(self.conv1(x), relu=True)
        return self.bn2(self.conv2(y), identity, relu=True)


class ResNet3D(nn.Module):
    """Headless r3d-18 tube encoder: (B, T, H, W, 3) -> (B, T, H/16, W/16, 512),
    in `compute_dtype`.  `generator` seeds the init; None uses torch's
    global generator."""

    #: the layout of activations and conv weights inside
    memory_format = torch.channels_last_3d

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_filters: Sequence[int] = (64, 128, 256, 512),
                 generator: torch.Generator | None = None,
                 compute_dtype: str | torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.conv1 = _conv(3, 64, 7, (1, 2, 2), 3)
        self.bn1 = _bn(64)
        cin = 64
        for i, (blocks, filters) in enumerate(zip(stage_sizes, stage_filters)):
            layer = []
            for j in range(blocks):
                stride = (1, 2, 2) if (i > 0 and j == 0) else (1, 1, 1)
                layer.append(BasicBlock3D(cin, filters, stride))
                cin = filters
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.num_layers = len(stage_sizes)
        self.reset_parameters(generator)
        self.to(memory_format=self.memory_format)   # the conv weights' layout

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                # He fan-out normal == kaiming_normal_(mode='fan_out', relu)
                fan_out = m.out_channels * math.prod(m.kernel_size)
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            elif isinstance(m, nn.BatchNorm3d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.reset_running_stats()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 5 or x.shape[-1] != 3:
            raise ValueError(f"expected NDHWC RGB clip, got {tuple(x.shape)}")
        x = x.to(self.compute_dtype).permute(0, 4, 1, 2, 3)   # NDHWC -> NCDHW view
        x = x.contiguous(memory_format=self.memory_format)
        x = self.bn1(self.conv1(x), relu=True)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.permute(0, 2, 3, 4, 1)                       # NCDHW -> NDHWC view
