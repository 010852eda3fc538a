"""ResNet-18 (2-D), R3D-18 (3-D) and the hard-way head, plain, over a flat
dict of float32 tensors named as the original PyTorch models name them.

A network is described by its configuration (`perfbench/configs/*.json`):
stage sizes, filters and strides, the stem's channels and kernel.  `spec`
lists every parameter and buffer with its shape and initialisation, which
is all the benchmark needs to make the weights (`perfbench/weights.py`).

2-D (AVENet's towers): stem conv k x k / 2, pad k // 2 -> BatchNorm -> ReLU
-> max-pool 3 / 2, pad 1 -> stages of BasicBlocks; a stride-1 layer4 keeps
a 224^2 image at a 14 x 14 x 512 map.  3-D (the R3D-18 tube encoder): stem
conv k^3, stride (1, 2, 2), pad k // 2 -> BatchNorm -> ReLU, no pool; every
stage after the first opens at stride (1, 2, 2), so T is kept.

BatchNorm in training takes the batch's statistics (biased variance) and
advances the running ones with momentum 0.1 and the unbiased variance; in
eval it uses the running ones.  Interfaces are channels-last: (B, H, W, C)
and (B, T, H, W, C) in and out.
"""

from __future__ import annotations

import math
from collections.abc import Iterator

import torch
import torch.nn.functional as F

from perfbench.reference.arith import Arith

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _blocks(net: dict) -> Iterator[tuple[str, int, int, tuple[int, ...]]]:
    """(name, in channels, out channels, stride) of each BasicBlock."""
    cin = net["stem_filters"]
    three_d = net["kind"] == "resnet3d"
    for i, (n, filters) in enumerate(zip(net["stage_sizes"], net["stage_filters"])):
        for j in range(n):
            if three_d:
                s = (1, 2, 2) if (i > 0 and j == 0) else (1, 1, 1)
            else:
                s = (net["stage_strides"][i] if j == 0 else 1,) * 2
            yield f"layer{i + 1}.{j}", cin, filters, s
            cin = filters


def spec(net: dict, prefix: str) -> list[tuple[str, tuple[int, ...], tuple]]:
    """[(name, shape, init)], init one of ('normal', mean, std), ('const', v)
    or ('count',) for `num_batches_tracked`."""
    nd = 3 if net["kind"] == "resnet3d" else 2
    out = []

    def conv(name, cin, cout, k):
        shape = (cout, cin, *([k] * nd))
        out.append((f"{prefix}.{name}.weight", shape,
                    ("normal", 0.0, math.sqrt(2.0 / (cout * k ** nd)))))

    def bn(name, c):
        w = ("normal", 1.0, 0.02) if net["bn_scale_noise"] else ("const", 1.0)
        out.extend([(f"{prefix}.{name}.weight", (c,), w),
                    (f"{prefix}.{name}.bias", (c,), ("const", 0.0)),
                    (f"{prefix}.{name}.running_mean", (c,), ("const", 0.0)),
                    (f"{prefix}.{name}.running_var", (c,), ("const", 1.0)),
                    (f"{prefix}.{name}.num_batches_tracked", (), ("count",))])

    conv(net["stem_name"], net["in_channels"], net["stem_filters"], net["stem_kernel"])
    bn("bn1", net["stem_filters"])
    for name, cin, cout, s in _blocks(net):
        conv(f"{name}.conv1", cin, cout, 3)
        bn(f"{name}.bn1", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        bn(f"{name}.bn2", cout)
        if any(v != 1 for v in s) or cin != cout:
            conv(f"{name}.downsample.0", cin, cout, 1)
            bn(f"{name}.downsample.1", cout)
    return out


def batch_norm(x: torch.Tensor, p: dict, name: str, train: bool) -> torch.Tensor:
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], training=train,
                        momentum=BN_MOMENTUM, eps=BN_EPS)


def resnet(x: torch.Tensor, p: dict, net: dict, prefix: str, train: bool,
           arith: Arith) -> torch.Tensor:
    """Channels-last input -> channels-last feature map in `arith.dtype`."""
    three_d = net["kind"] == "resnet3d"
    x = x.to(arith.dtype)
    x = x.permute(0, 4, 1, 2, 3) if three_d else x.permute(0, 3, 1, 2)
    k = net["stem_kernel"]
    stem_stride = (1, 2, 2) if three_d else 2
    x = arith.conv(x, p[f"{prefix}.{net['stem_name']}.weight"], stem_stride, k // 2)
    x = arith.store(torch.relu(arith.store(batch_norm(x, p, f"{prefix}.bn1", train))))
    if not three_d:
        x = arith.store(F.max_pool2d(x, 3, 2, 1))
    for name, cin, cout, s in _blocks(net):
        b = f"{prefix}.{name}"
        if any(v != 1 for v in s) or cin != cout:
            identity = arith.store(batch_norm(
                arith.conv(x, p[f"{b}.downsample.0.weight"], s, 0), p, f"{b}.downsample.1",
                train))
        else:
            identity = x
        y = arith.store(batch_norm(arith.conv(x, p[f"{b}.conv1.weight"], s, 1), p,
                                   f"{b}.bn1", train))
        y = arith.store(torch.relu(y))
        y = arith.store(batch_norm(arith.conv(y, p[f"{b}.conv2.weight"], 1, 1), p,
                                   f"{b}.bn2", train))
        x = arith.store(torch.relu(arith.store(y + identity)))
    return x.permute(0, 2, 3, 4, 1) if three_d else x.permute(0, 2, 3, 1)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(1e-12)


def hardway_head(img: torch.Tensor, aud: torch.Tensor, head: dict, arith: Arith) -> dict:
    """Image features (B, H, W, C) and audio features (B, C), the batch its
    own negative pool -> heatmap (B, H, W), logits (B, B + 2), the
    Pos-weighted map (B, H, W).  Float32."""
    b, h, w, c = img.shape
    img = l2_normalize(img.to(torch.float32))
    aud = l2_normalize(aud.to(torch.float32))
    flat = img.reshape(b, h * w, c)
    a0 = arith.matmul(flat, aud.t())                               # (B, HW, B)
    a = arith.matmul(flat, aud[:, :, None])[..., 0]                # (B, HW)
    eps, eps2, tau = head["epsilon"], head["epsilon2"], head["tau"]
    pos = torch.sigmoid((a - eps) / tau)
    neg = 1.0 - torch.sigmoid((a - eps2) / tau) if head["trimap"] else 1.0 - pos
    pos_all = torch.sigmoid((a0 - eps) / tau)
    sim1 = (pos * a).sum(-1, keepdim=True) / pos.sum(-1, keepdim=True)
    sim = (pos_all * a0).sum(1) / pos_all.sum(1)
    sim = sim * (1.0 - head["mask_penalty"] * torch.eye(b, device=sim.device))
    sim2 = (neg * a).sum(-1, keepdim=True) / neg.sum(-1, keepdim=True)
    cols = (sim1, sim, sim2) if head["use_neg"] else (sim1, sim)
    logits = torch.cat(cols, dim=1) / head["temperature"]
    norm_pos = pos / torch.linalg.vector_norm(pos, dim=-1, keepdim=True).clamp_min(1e-12)
    weighted = (flat * norm_pos[..., None]).mean(dim=-1)
    return {"heatmap": a.reshape(b, h, w), "logits": logits,
            "weighted_map": weighted.reshape(b, h, w)}
