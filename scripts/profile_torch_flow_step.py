#!/usr/bin/env python3
"""Where one FlowNetLite pretraining step of the PyTorch/CUDA port spends the
card's time.

    python3 scripts/profile_torch_flow_step.py [--batch 20] [--image_size 224]
                                               [--steps 10] [--out DIR]

Makes one batch of translating patterns and a seeded `FlowNetLite` train
state (`avtubes_torch`), runs `--steps` calls of `flow_pretrain_step` under
`torch.profiler` (CPU + CUDA activities) and prints one JSON line: wall time
per step on the host's clock, the device's busy time per step (sum of kernel
and memcpy device time), the idle share that follows from the two, the
device time per step of the hand-written correlation kernels and of the
fifteen most expensive kernels, and CUDA-event times of the step's parts
(forward, loss, backward, optimizer).  With `--out` it also writes the Chrome
trace there.  Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from avtubes_torch.core.device import device_report
from avtubes_torch.train.flow_pretrain import (
    create_flow_state,
    flow_pretrain_step,
    multiscale_photometric,
    smoothness_loss,
    translating_pairs,
)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None, help="directory for the Chrome trace")
    a = p.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = create_flow_state(torch.Generator().manual_seed(0))   # on the card, or an error
    dev = next(state.model.parameters()).device
    im1, im2, _ = translating_pairs(np.random.RandomState(0), a.batch, a.image_size)
    im1, im2 = torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)
    for _ in range(3):
        flow_pretrain_step(state, im1, im2)
    torch.cuda.synchronize()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(a.steps):
            flow_pretrain_step(state, im1, im2)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / a.steps
    # device-side rows only (kernels and memcpys): the host-side operator
    # rows repeat the device time of the kernels they launched, and so does
    # the device-side span of the optimizer's own annotation
    rows = [(e.key, e.self_device_time_total / 1e3 / a.steps, e.count / a.steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        print("profiler recorded no device time; time with CUDA events instead",
              file=sys.stderr)
        return 1
    if busy_ms > wall_ms:
        # one stream: the card cannot be busy for longer than the wall time
        raise RuntimeError(f"device busy {busy_ms:.3f} ms exceeds wall "
                           f"{wall_ms:.3f} ms per step: the row filter double-counts")
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(a.out, "flow_step_trace.json"))

    # the step's parts, each alone under CUDA events (after the profiler: its
    # hooks slow the host)
    model = state.model

    def loss_of(flow):
        return (multiscale_photometric(im1, im2, flow)
                + 0.05 * smoothness_loss(flow, image=im1, edge_alpha=10.0))

    def forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        loss_of(model(im1, im2)).backward()

    with torch.no_grad():
        forward_ms = cuda_ms(lambda: model(im1, im2))
        flow = model(im1, im2)
        loss_forward_ms = cuda_ms(lambda: loss_of(flow))
    forward_backward_ms = cuda_ms(forward_backward)
    forward_backward()
    optimizer_ms = cuda_ms(state.optimizer.step)
    step_ms = cuda_ms(lambda: flow_pretrain_step(state, im1, im2))

    print(json.dumps({
        "card": device_report(), "batch": a.batch, "image_size": a.image_size,
        "steps": a.steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_step": sum(r[2] for r in rows),
        "correlation_kernels_ms_per_step": [
            {"name": k[:80], "ms": ms, "calls": calls} for k, ms, calls in rows
            if "corr_" in k],
        "top_kernels_ms_per_step": [
            {"name": k[:80], "ms": ms, "calls": calls} for k, ms, calls in rows[:15]],
        "cuda_event_ms": {"step": step_ms, "flownet_forward": forward_ms,
                          "loss_forward": loss_forward_ms,
                          "forward_loss_backward": forward_backward_ms,
                          "optimizer_step": optimizer_ms},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
