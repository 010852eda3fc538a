#!/usr/bin/env python3
"""Where one served batch of the PyTorch/CUDA port spends the card's time.

    python3 scripts/profile_torch_serving.py [--batch 8] [--steps 10]
        [--compute_dtype float32] [--cudnn_benchmark] [--out DIR]

Builds a seeded full-width localizer (`avtubes_torch`, backbones in
`--compute_dtype`; `--cudnn_benchmark` sets `torch.backends.cudnn.benchmark`
before the runner's warmup, as `cli/serve.py` does), runs `--steps`
batches through `ArtifactRunner.run` under `torch.profiler` (CPU + CUDA
activities) and prints one JSON line: wall time per batch on the host's
clock, the device's busy time per batch (sum of kernel and memcpy device
time), the idle share that follows from the two, and the device time per
batch of the ten most expensive kernels.  With `--out` it also writes the
Chrome trace there.  Needs one CUDA card; exits non-zero without one.
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
from avtubes_torch.core.export import export_localizer
from avtubes_torch.core.serving import ArtifactRunner
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.models.avenet import AVENet


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--cudnn_benchmark", action="store_true")
    p.add_argument("--out", default=None, help="directory for the Chrome trace")
    a = p.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = a.cudnn_benchmark
    cfg = SpectrogramConfig()
    model = AVENet(generator=torch.Generator().manual_seed(0), compute_dtype=a.compute_dtype)
    runner = ArtifactRunner(export_localizer(model, cfg), max_batch=a.batch)
    runner.warmup()
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (a.batch, 224, 224, 3), dtype=np.uint8)
    waves = np.clip(rng.randn(a.batch, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    for _ in range(3):
        runner.run(frames, waves)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(a.steps):
            runner.run(frames, waves)
        wall_ms = (time.monotonic() - t0) * 1e3 / a.steps
    # device-side rows only (kernels and memcpys): the host-side operator
    # rows repeat the device time of the kernels they launched
    rows = [(e.key, e.self_device_time_total / 1e3 / a.steps, e.count / a.steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        print("profiler recorded no device time; time with CUDA events instead",
              file=sys.stderr)
        return 1
    if busy_ms > wall_ms:
        # one stream: the card cannot be busy for longer than the wall time,
        # so the rows above count something twice
        raise RuntimeError(f"device busy {busy_ms:.3f} ms exceeds wall "
                           f"{wall_ms:.3f} ms per batch: the row filter double-counts")
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(a.out, "serving_trace.json"))
    print(json.dumps({
        "card": device_report(), "batch": a.batch, "steps": a.steps,
        "compute_dtype": a.compute_dtype, "cudnn_benchmark": a.cudnn_benchmark,
        "wall_ms_per_batch": wall_ms, "device_busy_ms_per_batch": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_batch": sum(r[2] for r in rows),
        "top_kernels_ms_per_batch": [
            {"name": k[:120], "ms": ms, "calls": calls} for k, ms, calls in rows[:12]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
