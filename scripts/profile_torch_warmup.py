#!/usr/bin/env python3
"""How long the first served batch takes after one warm-up pass and after two.

    python3 scripts/profile_torch_warmup.py [--batchers 5]

Exports phase serve's seeded bf16 localizer (`chip_smoke.py`), loads it on
the card with cuDNN's autotuner on (as `cli/serve.py` serves), and serves
phase serve's 24 requests from 8 threads through `--batchers` new
micro-batchers for each variant: `once`, the runner's buckets warmed in one
pass, and `twice`, in two (`ArtifactRunner.warmup` does two). Each batcher
warms in its own dispatcher thread, as serving does. Prints, per batcher,
every served batch's milliseconds by CUDA events and the first batch's ratio
to the median of the rest, then one JSON line with all of them. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

import chip_smoke as cs
from avtubes_torch.core.device import device_report
from avtubes_torch.core.export import export_localizer
from avtubes_torch.core.serving import ArtifactRunner
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.models.avenet import AVENet


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batchers", type=int, default=5)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_warmup: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SpectrogramConfig()
    gen = torch.Generator().manual_seed(cs.SEED)
    seeded = cs.perturb_running_stats(AVENet(generator=gen, compute_dtype="float32"), gen)
    model = AVENet(compute_dtype="bfloat16")
    model.load_state_dict(seeded.state_dict(), strict=True)
    torch.backends.cudnn.benchmark = True
    runner = ArtifactRunner(export_localizer(model, cfg, image_size=cs.IMAGE_SIZE),
                            max_batch=cs.MAX_BATCH)
    frames, waves = cs.make_requests(cfg)
    two_passes = runner.warmup

    def one_pass() -> None:
        for b in runner.buckets:
            runner.run(np.zeros((b, runner.image_size, runner.image_size, 3), np.uint8),
                       np.zeros((b, *runner.audio_shape), runner.audio_dtype))

    out = {"card": device_report(), "variants": {}}
    for variant, warm in (("once", one_pass), ("twice", two_passes)):
        runner.warmup = warm
        rows = []
        for _ in range(a.batchers):
            ms = cs.serve_requests(runner, frames, waves)[2]["batch_ms_by_events"]
            rows.append({"batch_ms": ms, "first_over_median": ms[0] / float(np.median(ms[1:]))})
            print(json.dumps({"variant": variant, **rows[-1]}), flush=True)
        out["variants"][variant] = rows
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
