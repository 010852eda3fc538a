"""Model FLOPs of the configurations, counted from the reference's layer
shapes: every convolution and matrix product of the towers and the head,
at 2 FLOPs a multiply-add, walked on the meta device (nothing computed).
The spectrogram, normalisation, activations, pooling and the losses are
not counted.  A training step counts its forward three times (forward,
and twice that for the backward), recomputation never.
"""

from __future__ import annotations

import torch

from perfbench.reference import nets
from perfbench.reference.arith import Arith
from perfbench.reference.spectrogram import geometry


def tower_flops(net: dict, batch_shape: tuple[int, ...]) -> int:
    """FLOPs of one tower's forward on an input of `batch_shape`
    (channels-last)."""
    arith = Arith(count=True)
    p = {name: torch.empty(shape, device="meta")
         for name, shape, _ in nets.spec(net, net["prefix"])}
    nets.resnet(torch.empty(batch_shape, device="meta"), p, net, net["prefix"], True, arith)
    return arith.flops


def head_flops(b: int, h: int, w: int, c: int) -> int:
    arith = Arith(count=True)
    nets.hardway_head(torch.empty((b, h, w, c), device="meta"),
                      torch.empty((b, c), device="meta"),
                      {"epsilon": 0.65, "epsilon2": 0.4, "tau": 0.03, "trimap": True,
                       "mask_penalty": 100.0, "use_neg": True, "temperature": 0.07},
                      arith)
    return arith.flops


def spectrogram_shape(cfg: dict) -> tuple[int, int]:
    a = cfg["audio"]
    g = geometry(a["samplerate"], a["seconds"], a["nperseg"], a["noverlap"])
    return g["num_freqs"], g["num_frames"]


def feature_map(net: dict, size: int) -> int:
    """Side of a tower's square feature map for a size x size input."""
    side = -(-size // 2)                      # the stem's stride 2
    if net["kind"] == "resnet2d":
        side = -(-side // 2)                  # the max-pool
        for s in net["stage_strides"]:
            side = -(-side // s)
    else:
        side = side // 2 ** (len(net["stage_filters"]) - 1)
    return side


def train_step_flops(cfg: dict, kind: str, batch: int, frames: int) -> int:
    """FLOPs of one training step of `kind` ('flagship' or 'tube3d') at
    `batch` clips of `frames` frames."""
    s = cfg["image_size"]
    f, t = spectrogram_shape(cfg)
    audio = tower_flops(cfg["nets"]["audio"], (batch, f, t, 1))
    n = batch * frames
    if kind == "flagship":
        img = cfg["nets"]["image"]
        side = feature_map(img, s)
        fwd = audio + 2 * (tower_flops(img, (n, s, s, 3))
                           + head_flops(n, side, side, img["stage_filters"][-1]))
    else:
        vid = cfg["nets"]["video"]
        side = feature_map(vid, s)
        fwd = (audio + tower_flops(vid, (batch, frames, s, s, 3))
               + head_flops(n, side, side, vid["stage_filters"][-1]))
    return 3 * fwd

