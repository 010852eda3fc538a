"""The experimental model zoo (PyTorch).

Counterpart of `avtubes/models/zoo.py`: compact versions of the model
families the original code base ships but no trainer drives.

  * `NetVLAD`, `AudioResNetVLAD`: the audio ResNet-18 with NetVLAD (or
    global max) pooling;
  * `SyncNetAudio`, `SyncNetVisual`: VGG-M SyncNet-style embedding towers
    (`_VGGMTower`);
  * `AudioConvNet`, `ImageConvNet`: 8-conv VGG-ish encoders;
  * `TransformerAttention`: QKV attention between an audio vector and a
    video feature map.

None is on a main path.  Shapes are NHWC at the interface, as in the JAX
package; inside, convolutions see NCHW.  Sub-modules and parameters carry
the flax names (`conv{i}`, `bn{i}`, `fc`, `assign`, `centroids`, `key`,
`query`, `value`, `backbone`, `vlad`), so `core/convert.py::zoo_from_flax`
is a rename plus the kernel transposes.  What follows the JAX modules
literally:

  * flax `nn.Conv` and `nn.Dense` carry a bias, so these convolutions do
    (the ResNets' do not);
  * `padding="SAME"`: (before, after) from `models/flownet.py::same_padding`,
    so the 7x7 stride-2 stem pads (2, 3) on an even side, (3, 3) on an odd
    one; `nn.max_pool` is VALID (no padding, the remainder dropped);
  * `TorchBatchNorm(momentum=0.9)` is `nn.BatchNorm2d(momentum=0.1,
    eps=1e-5)`, whose running variance takes n/(n-1);
  * flax infers input channels; the port takes `in_channels` (1 for the
    audio towers, 3 for the visual ones);
  * `compute_dtype` is the JAX modules' `dtype`: convolutions, BatchNorm
    normalisation, ReLU and pools run in it, the parameters and running
    statistics stay float32.  A `Dense` without a `dtype` promotes to
    float32 (the towers' `fc`, `NetVLAD`, `TransformerAttention`), and so
    do these.

Initialization draws from an explicit `generator`: He fan-out normal for
the convolutions the JAX package gives `conv_init`, flax's LeCun truncated
normal for its default-initialized kernels, N(0, 1) centroids, zero biases,
unit BatchNorm scales.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from avtubes_torch.models.flownet import same_padding
from avtubes_torch.models.resnet2d import Conv2d, ResNet2D, compute_dtype_of

#: flax's truncated normal keeps [-2, 2] standard deviations; dividing by this
#: restores the asked-for variance (`jax.nn.initializers.variance_scaling`)
_TRUNCATED_STD = 0.87962566103423978


def _he_fan_out_(w: torch.Tensor, generator: torch.Generator | None) -> None:
    fan_out = w.shape[0] * math.prod(w.shape[2:])
    w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def _lecun_truncated_(w: torch.Tensor, generator: torch.Generator | None) -> None:
    std = math.sqrt(1.0 / math.prod(w.shape[1:])) / _TRUNCATED_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, 1e-12) over the last axis."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _same_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` on NCHW `x` with flax's SAME padding."""
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    top, bottom = same_padding(x.shape[2], kh, sh)
    left, right = same_padding(x.shape[3], kw, sw)
    return conv(F.pad(x, (left, right, top, bottom)))


def _bn(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


def _dense(cin: int, cout: int, generator: torch.Generator | None) -> nn.Linear:
    layer = nn.Linear(cin, cout)
    with torch.no_grad():
        _lecun_truncated_(layer.weight, generator)
        layer.bias.zero_()
    return layer


class _ConvBNStack(nn.Module):
    """`conv{i}` (SAME, bias, He fan-out) -> `bn{i}` -> ReLU, with VALID
    `pool`x`pool` stride-2 max pools after the layers in `pool_after`;
    `trunk` takes NHWC and gives NCHW, in `compute_dtype`."""

    def __init__(self, in_channels: int, channels: Sequence[int], kernels: Sequence[int],
                 strides: Sequence[int], pool_after: Sequence[int], pool: int,
                 generator: torch.Generator | None, compute_dtype: str | torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.pool_after, self.pool = tuple(pool_after), pool
        self.depth = len(channels)
        cin = in_channels
        for i, (ch, k, s) in enumerate(zip(channels, kernels, strides)):
            conv = Conv2d(cin, ch, k, stride=s, bias=True)
            with torch.no_grad():
                _he_fan_out_(conv.weight, generator)
                conv.bias.zero_()
            setattr(self, f"conv{i + 1}", conv)
            setattr(self, f"bn{i + 1}", _bn(ch))
            cin = ch

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous()
        for i in range(self.depth):
            x = _same_conv(getattr(self, f"conv{i + 1}"), x)
            x = torch.relu(getattr(self, f"bn{i + 1}")(x))
            if i in self.pool_after:
                x = F.max_pool2d(x, self.pool, 2)
        return x


class NetVLAD(nn.Module):
    """NetVLAD pooling, (B, H, W, D) -> (B, K*D) float32, L2-normalized: soft
    assignment of each descriptor to K clusters (`assign`, a 1x1 conv with a
    bias), the residuals to the `centroids` summed per cluster, each
    cluster's sum normalized, then the whole.  Runs in float32 whatever its
    input's dtype, as the JAX module's promoting `nn.Conv` does."""

    def __init__(self, num_clusters: int = 64, dim: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_clusters, self.dim = num_clusters, dim
        self.assign = nn.Conv2d(dim, num_clusters, 1, bias=True)
        self.centroids = nn.Parameter(torch.empty(num_clusters, dim))
        with torch.no_grad():
            _lecun_truncated_(self.assign.weight, generator)
            self.assign.bias.zero_()
            self.centroids.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, d = x.shape
        x = x.to(torch.float32)
        flat = x.reshape(b, h * w, d)
        logits = self.assign(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assign = torch.softmax(logits.reshape(b, h * w, self.num_clusters), dim=-1)
        agg = torch.einsum("bnk,bnd->bkd", assign, flat)
        counts = assign.sum(dim=1)[..., None]                     # (B, K, 1)
        vlad = _l2_normalize(agg - counts * self.centroids[None])  # intra-norm
        return _l2_normalize(vlad.reshape(b, -1))


class AudioResNetVLAD(nn.Module):
    """The audio ResNet-18 (`backbone`, layer4 at stride 1) with NetVLAD
    (`pool='vlad'`: (B, K*512) float32) or global max pooling (`pool='max'`:
    (B, 512) in `compute_dtype`).  (B, F, T, 1) in."""

    def __init__(self, pool: str = "vlad", num_clusters: int = 64,
                 generator: torch.Generator | None = None,
                 compute_dtype: str | torch.dtype = torch.float32):
        super().__init__()
        if pool not in ("vlad", "max"):
            raise ValueError(f"pool must be 'vlad' or 'max', got {pool!r}")
        self.pool = pool
        self.backbone = ResNet2D(modal="audio", generator=generator,
                                 compute_dtype=compute_dtype)
        if pool == "vlad":
            self.vlad = NetVLAD(num_clusters, 512, generator=generator)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(spec)
        if self.pool == "vlad":
            return self.vlad(feats)
        return feats.amax(dim=(1, 2))


class _VGGMTower(_ConvBNStack):
    """The VGG-M trunk: five SAME convolutions (7x7 stride 2, 5x5, then 3x3)
    with BatchNorm and ReLU, VALID 3x3/2 max pools after the 1st, 2nd and
    5th, a global max pool, `fc` in float32 and an L2 normalization:
    (B, H, W, in_channels) -> (B, embed) float32."""

    def __init__(self, in_channels: int, channels: Sequence[int] = (96, 256, 512, 512, 512),
                 embed: int = 1024, in_pool: bool = True,
                 generator: torch.Generator | None = None,
                 compute_dtype: str | torch.dtype = torch.float32):
        n = len(channels)
        super().__init__(in_channels, channels, kernels=[7, 5] + [3] * (n - 2),
                         strides=[2] + [1] * (n - 1), pool_after=(0, 1, 4) if in_pool else (),
                         pool=3, generator=generator, compute_dtype=compute_dtype)
        self.fc = _dense(channels[-1], embed, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.trunk(x).amax(dim=(2, 3))                        # (B, C)
        return _l2_normalize(self.fc(x.to(torch.float32)))


class SyncNetAudio(_VGGMTower):
    """SyncNet audio tower: (B, F, T, 1) spectrogram -> (B, embed)."""

    def __init__(self, in_channels: int = 1, **kwargs):
        super().__init__(in_channels, **kwargs)


class SyncNetVisual(_VGGMTower):
    """SyncNet visual tower: (B, H, W, 3) frame -> (B, embed)."""

    def __init__(self, in_channels: int = 3, **kwargs):
        super().__init__(in_channels, **kwargs)


class AudioConvNet(_ConvBNStack):
    """8-conv VGG-ish encoder: 3x3 SAME convolutions of 64, 64, 128, 128,
    256, 256, 512, 512 channels with BatchNorm and ReLU, a VALID 2x2/2 max
    pool after every second: (B, H, W, in_channels) -> (B, H/16, W/16, 512)
    in `compute_dtype` (sides floored at each pool)."""

    CHANNELS = (64, 64, 128, 128, 256, 256, 512, 512)

    def __init__(self, in_channels: int = 1, generator: torch.Generator | None = None,
                 compute_dtype: str | torch.dtype = torch.float32):
        super().__init__(in_channels, self.CHANNELS, kernels=[3] * 8, strides=[1] * 8,
                         pool_after=(1, 3, 5, 7), pool=2, generator=generator,
                         compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(x).permute(0, 2, 3, 1)


class ImageConvNet(AudioConvNet):
    """The same topology over RGB frames."""

    def __init__(self, in_channels: int = 3, **kwargs):
        super().__init__(in_channels, **kwargs)


class TransformerAttention(nn.Module):
    """QKV attention of an audio vector (B, audio_dim) over video features
    (B, T, H, W, video_dim) -> (B, T, H, W), float32.  As in the JAX module,
    literally: the softmax runs over the last axis (W) alone, and the output
    is `einsum('bthwc,bthw->bthw', value, softmax)`."""

    def __init__(self, latent: int = 512, audio_dim: int = 512, video_dim: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.key = _dense(video_dim, latent, generator)
        self.query = _dense(audio_dim, latent, generator)
        self.value = _dense(video_dim, latent, generator)

    def forward(self, audio_features: torch.Tensor,
                video_features: torch.Tensor) -> torch.Tensor:
        audio_features = audio_features.to(torch.float32)
        video_features = video_features.to(torch.float32)
        weights = torch.einsum("bthwc,bc->bthw", self.key(video_features),
                               self.query(audio_features))
        soft = torch.softmax(weights, dim=-1)
        return torch.einsum("bthwc,bthw->bthw", self.value(video_features), soft)
