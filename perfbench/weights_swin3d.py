"""Initial weights of a configuration whose tube encoder is Video Swin-B,
made on the device from the seed as `weights_timesformer.py` makes
TimeSformer's: one normal draw for every normally initialised leaf (the
tower's N(0, 0.02) leaves, its bias tables among them, and the audio
ResNet-18's He fan-out convolutions), cut and scaled, constants for the
rest.  Every leaf is float32; the same seed gives the same weights, which
both the program and the reference are handed."""

from __future__ import annotations

import torch

from perfbench.harness import subseed
from perfbench.reference.swin3d import all_spec


def make_weights(cfg: dict, seed: int, device: torch.device) -> dict:
    entries = all_spec(cfg)
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    normal = [(name, shape, init) for name, shape, init in entries if init[0] == "normal"]
    draw = torch.randn(sum(torch.Size(shape).numel() for _, shape, _ in normal), generator=g,
                       device=device)
    out, off = {}, 0
    for name, shape, init in normal:
        n = torch.Size(shape).numel()
        out[name] = draw[off:off + n].view(shape) * init[2] + init[1]
        off += n
    for name, shape, init in entries:
        if init[0] == "const":
            out[name] = torch.full(shape, init[1], device=device)
        elif init[0] == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return out
