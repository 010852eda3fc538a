"""Dual-modal 2D ResNet encoder (PyTorch).

Counterpart of `avtubes/models/resnet2d.py` (and of `models/norm.py`, whose
`TorchBatchNorm` only imitates `nn.BatchNorm2d(eps=1e-5, momentum=0.1)` —
here it is the real one):

  * three stems selected by `modal`: 1-channel audio spectrogram, 3-channel
    RGB, 6-channel stacked flow — all 7x7/stride-2/pad-3 convs;
  * `MaxPool2d(3, 2, 1)`, then stages [64, 128, 256, 512] of two BasicBlocks
    each (ResNet-18) with strides [1, 2, 2, 1] — **layer4 keeps stride 1**,
    which is what makes a 224x224 image produce the 14x14x512 feature map
    the similarity heatmap is defined on;
  * conv kernels use He fan-out initialization, BatchNorm weight starts at
    ~N(1, 0.02) (the AVENet re-init) or at 1 (`bn_scale_noise=False`, the
    3D model's audio net), bias 0 — all drawn from an explicit
    `torch.Generator`;
  * returns the spatial feature map directly — no classifier head.

Sub-modules are named after the original PyTorch model's `state_dict`
(`conv1`/`conv1_a`/`conv1_flow`, `bn1`, `layer{L}.{B}.conv{1,2}`,
`...bn{1,2}`, `...downsample.{0,1}`), so the weight bridge in
`core/convert.py` is a mechanical rename.

Layout: the public interface is NHWC like the JAX package, (B, H, W, C) in
and (B, H/16, W/16, 512) out.  Inside, activations and conv weights are NCHW
with `memory_format=channels_last` (`ResNet2D.memory_format`), which has NHWC
strides: the permutes at both ends are views, not copies, and cuDNN gets its
preferred layout.  On an H100 it is as fast as plain NCHW in float32 and
faster in TF32 and bfloat16 (`PERF.md` §7), so it is the only layout.

Compute dtype (`compute_dtype`, the JAX package's `dtype`): the input is
cast to it and every convolution, BatchNorm normalisation, ReLU, max-pool
and residual add runs in it, while the parameters, their gradients and the
BatchNorm running statistics stay float32.  A convolution casts its float32
weight to the input's dtype per call (flax's `dtype=`); `nn.BatchNorm2d` on
a bfloat16 input with float32 weights computes its batch statistics in
float32 and advances the running variance with the unbiased n/(n-1) value,
as `avtubes/models/norm.py` does.  No autocast region is involved, so
nothing outside the backbone changes dtype.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

STEM_CHANNELS = {"vision": 3, "audio": 1, "flow": 6}
#: the compute dtypes of the backbones, by their flag names
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: stem attribute (= state_dict) name per modality
STEM_NAMES = {"vision": "conv1", "audio": "conv1_a", "flow": "conv1_flow"}


def compute_dtype_of(name: str | torch.dtype) -> torch.dtype:
    """'float32' / 'bfloat16' (or the torch dtype itself) -> the torch dtype;
    any other value raises."""
    if isinstance(name, torch.dtype):
        if name in COMPUTE_DTYPES.values():
            return name
    elif name in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[name]
    raise ValueError(f"compute dtype must be one of {tuple(COMPUTE_DTYPES)}, got {name!r}")


def dtype_name(dtype: torch.dtype) -> str:
    """torch.bfloat16 -> 'bfloat16'."""
    return str(dtype).removeprefix("torch.")


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` that runs in its input's dtype: the (float32) weight is
    cast per call, so the parameter and its gradient stay float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)


def _bn(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """Two 3x3 convs with identity/projection shortcut (ResNet v1 basic block)."""

    def __init__(self, in_filters: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_filters, filters, 3, stride, 1)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3, 1, 1)
        self.bn2 = _bn(filters)
        self.downsample = None
        if stride != 1 or in_filters != filters:
            self.downsample = nn.Sequential(_conv(in_filters, filters, 1, stride),
                                            _bn(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + identity)


class ResNet2D(nn.Module):
    """Headless dual-modal ResNet feature extractor.

    Input (B, H, W, C_modal) -> output (B, H/16, W/16, 512), both NHWC — the
    /16 (not /32) is the stride-1 layer4 — in `compute_dtype`.  `generator`
    seeds the init; None uses torch's global generator.
    """

    #: the layout of activations and conv weights inside
    memory_format = torch.channels_last

    def __init__(self, modal: str = "vision",
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_filters: Sequence[int] = (64, 128, 256, 512),
                 stage_strides: Sequence[int] = (1, 2, 2, 1),
                 bn_scale_noise: bool = True,
                 generator: torch.Generator | None = None,
                 compute_dtype: str | torch.dtype = torch.float32):
        super().__init__()
        if modal not in STEM_CHANNELS:
            raise ValueError(f"modal must be one of {tuple(STEM_CHANNELS)}, got {modal!r}")
        self.modal = modal
        self.compute_dtype = compute_dtype_of(compute_dtype)
        setattr(self, STEM_NAMES[modal], _conv(STEM_CHANNELS[modal], 64, 7, 2, 3))
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for i, (blocks, filters, stride) in enumerate(
                zip(stage_sizes, stage_filters, stage_strides)):
            layer = []
            for j in range(blocks):
                layer.append(BasicBlock(cin, filters, stride if j == 0 else 1))
                cin = filters
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.num_layers = len(stage_sizes)
        self.reset_parameters(bn_scale_noise, generator)
        self.to(memory_format=self.memory_format)   # the conv weights' layout

    @torch.no_grad()
    def reset_parameters(self, bn_scale_noise: bool = True,
                         generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                # He fan-out normal == kaiming_normal_(mode='fan_out', relu)
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                if bn_scale_noise:
                    m.weight.normal_(1.0, 0.02, generator=generator)
                else:
                    m.weight.fill_(1.0)
                m.bias.zero_()
                m.reset_running_stats()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        expected_c = STEM_CHANNELS[self.modal]
        if x.ndim != 4 or x.shape[-1] != expected_c:
            raise ValueError(
                f"modal={self.modal!r} expects {expected_c} input channels "
                f"(NHWC), got {tuple(x.shape)}")
        stem = getattr(self, STEM_NAMES[self.modal])
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = x.contiguous(memory_format=self.memory_format)
        x = self.maxpool(torch.relu(self.bn1(stem(x))))
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.permute(0, 2, 3, 1)                       # NCHW -> NHWC view

