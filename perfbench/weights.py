"""Initial weights of a configuration, made on the device from the seed.

One normal draw for every normally initialised parameter, cut into leaves
and scaled: He fan-out for the convolutions, N(1, 0.02) for AVENet's
BatchNorm scales, constants for the rest (running means 0, variances 1,
as a freshly built model has them).  Every leaf is
float32, as the program keeps its parameters; the same seed gives the same
weights, which both the program and the reference are handed.
"""

from __future__ import annotations

import torch

from perfbench.harness import subseed
from perfbench.reference import nets


def make_weights(cfg: dict, seed: int, device: torch.device) -> dict:
    entries = [e for net in cfg["nets"].values() for e in nets.spec(net, net["prefix"])]
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    normal = [(name, shape, init) for name, shape, init in entries if init[0] == "normal"]
    total = sum(torch.Size(shape).numel() for _, shape, _ in normal)
    draw = torch.randn(total, generator=g, device=device)
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
