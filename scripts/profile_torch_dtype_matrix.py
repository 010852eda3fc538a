#!/usr/bin/env python3
"""What the compute dtype, the memory layout and cuDNN's autotuner buy the
PyTorch/CUDA port on one card: a served batch and a flagship training step
in every combination.

    python3 scripts/profile_torch_dtype_matrix.py
        [--dtypes float32,tf32,bfloat16] [--channels_last on,off]
        [--cudnn_benchmark off|on] [--steps 5]
        [--parent_transforms PATH] [--out FILE]

Configurations are the product of the two lists: `float32` is IEEE float32
(TF32 off for matmuls and cuDNN), `tf32` is the float32 model with TF32 on
for both, `bfloat16` is `AVENet(compute_dtype="bfloat16")` with TF32 off (the
head's product stays float32); `--channels_last` runs the model's own
layout (NHWC-strided activations and weights) or turns it to plain NCHW;
`--cudnn_benchmark` sets `torch.backends.cudnn.benchmark` for the whole
run: PyTorch's cuDNN plan cache is keyed without that flag, so a plan picked
by the heuristics is reused after the flag is turned on, and the two
settings are measured in two processes.  The flags are read here and set on
torch here; nothing in `avtubes_torch` reads them.  Per configuration, from a
seeded full-width AVENet (two ResNet-18 with layer4 at stride 1):

  * `serve_batch8_ms`: one `LocalizerPipeline` call on 8 frames of 224x224 and
    8 waveforms of 10 s at 22.05 kHz (K1, both backbones, head, K2), and
    `serve_forward_batch8_ms`, the AVENet forward alone, by CUDA events over
    back-to-back calls: what a caller pays, the host's launch rate included
    (a batch is ~330 launches; ten of them queued behind a sleeping kernel
    still read the host's rate on an H100, so the device's own time is
    `scripts/profile_torch_serving.py`'s busy time);
  * `train_step_ms`: `hardway_fused_train_step` at the recipe batch (20 clips
    x 16 frames x two views at 224x224, 257x431 spectrograms) over `--steps`
    steps of one resident batch, by CUDA events;
  * under `torch.profiler` (`scripts/profile_torch_train_step.py`), two steps'
    device-busy time, idle share, launches and cuDNN's NHWC<->NCHW layout
    conversions (count, device time, kernels); the profiler's own host work
    lengthens the wall it reads, so `device_idle_share_by_events` sets the
    busy time against `train_step_ms` instead;
  * `max_memory_allocated_gib` over the timed steps.

With `--parent_transforms PATH` (the augmentation module of an earlier
commit, e.g. `git show <commit>:avtubes_torch/data/transforms.py`), the
first configuration of each dtype is also profiled with that module's
`augment_train_batch` in the step, in turns (earlier, this, this, earlier),
to read what the draws' one pinned copy did to the idle share.

Prints one JSON line per configuration and a last line with all of them;
`--out` also writes that last line to a file.  Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from avtubes_torch.core.config import OptimConfig
from avtubes_torch.core.device import device_report, resolve_device
from avtubes_torch.core.export import LocalizerPipeline
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
from avtubes_torch.data.transforms import normalize_imagenet
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.train import steps as train_steps
from avtubes_torch.train.state import create_train_state
from profile_torch_train_step import profile_train_step, recipe_batch

IMAGE_SIZE = 224
SERVE_BATCH = 8
TRAIN_BATCH, TRAIN_FRAMES = 20, 16


def events_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of `fn` over `iters` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def set_tf32(dtype: str) -> str:
    """Set TF32 for a configuration; returns the model's dtype."""
    tf32 = dtype == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return "float32" if tf32 else dtype


def build_model(compute_dtype: str, channels_last: bool) -> AVENet:
    """The seeded AVENet; `channels_last=False` turns its layout (activations
    and conv weights, `ResNet2D.memory_format`) to plain NCHW."""
    model = AVENet(generator=torch.Generator().manual_seed(0), compute_dtype=compute_dtype)
    if not channels_last:
        for net in (model.imgnet, model.audnet):
            net.memory_format = torch.contiguous_format
        model.to(memory_format=torch.contiguous_format)
    return model


def serve_ms(dev, compute_dtype: str, channels_last: bool, cfg: SpectrogramConfig) -> dict:
    model = build_model(compute_dtype, channels_last)
    pipeline = LocalizerPipeline(model, cfg, IMAGE_SIZE).to(dev)
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randint(0, 256, (SERVE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3),
                                          dtype=np.uint8)).to(dev)
    waves = torch.from_numpy(np.clip(rng.randn(SERVE_BATCH, cfg.num_samples) * 0.2, -1, 1)
                             .astype(np.float32)).to(dev)
    with torch.inference_mode():
        nf = normalize_imagenet(frames)
        spec = log_spectrogram(waves, cfg)[..., None]
        out = {"serve_batch8_ms": events_ms(lambda: pipeline(frames, waves), 20),
               "serve_forward_batch8_ms": events_ms(lambda: pipeline.model(nf, spec), 20)}
    return out


def train(dev, compute_dtype: str, channels_last: bool, cfg: SpectrogramConfig,
          steps: int, augment=None) -> dict:
    """Time and profile the flagship step; `augment` replaces the step's
    augmentation function while it runs."""
    model = build_model(compute_dtype, channels_last).to(dev)
    state = create_train_state(model, OptimConfig())
    clips, waves, draws = recipe_batch(dev, TRAIN_BATCH, TRAIN_FRAMES, IMAGE_SIZE, cfg)
    own = train_steps.augment_train_batch
    train_steps.augment_train_batch = augment or own
    try:
        def step():
            return train_steps.hardway_fused_train_step(state, clips, waves, draws, cfg,
                                                        image_size=IMAGE_SIZE)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        out = {"train_step_ms": events_ms(step, steps, warmup=1),
               "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        prof = profile_train_step(step, steps=2)
    finally:
        train_steps.augment_train_batch = own
    loss = float(step()["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} in {compute_dtype}")
    keep = ("wall_ms_per_step", "device_busy_ms_per_step", "device_idle_share",
            "device_launches_per_step", "layout_conversions_per_step",
            "layout_conversions_ms_per_step", "layout_conversion_kernels",
            "k1_kernel_ms_per_step")
    out.update({k: prof[k] for k in keep})
    out["device_idle_share_by_events"] = 1.0 - prof["device_busy_ms_per_step"] / out[
        "train_step_ms"]
    out["top_kernels_ms_per_step"] = prof["top_kernels_ms_per_step"][:6]
    out["loss"] = loss
    return out


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtypes", default="float32,tf32,bfloat16")
    p.add_argument("--channels_last", default="on,off")
    p.add_argument("--cudnn_benchmark", default="off", choices=("off", "on"))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--parent_transforms", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    dtypes = a.dtypes.split(",")
    if not set(dtypes) <= {"float32", "tf32", "bfloat16"}:
        raise SystemExit(f"--dtypes takes float32, tf32, bfloat16; got {a.dtypes}")
    onoff = {"on": True, "off": False}
    layouts = [onoff[v] for v in a.channels_last.split(",")]
    benchmark = onoff[a.cudnn_benchmark]
    torch.backends.cudnn.benchmark = benchmark

    dev = resolve_device("cuda")
    report = device_report()
    cfg = SpectrogramConfig()
    rows = []
    for dtype, channels_last in itertools.product(dtypes, layouts):
        compute_dtype = set_tf32(dtype)
        row = {"card": report, "dtype": dtype, "channels_last": channels_last,
               "cudnn_benchmark": benchmark,
               **serve_ms(dev, compute_dtype, channels_last, cfg),
               **train(dev, compute_dtype, channels_last, cfg, a.steps)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()

    augment_turns = []
    if a.parent_transforms:
        parent = load_module(a.parent_transforms, "parent_transforms")
        for dtype in dtypes:
            compute_dtype = set_tf32(dtype)
            turns = []
            for which in ("parent", "this", "this", "parent"):
                res = train(dev, compute_dtype, True, cfg, a.steps,
                            parent.augment_train_batch if which == "parent" else None)
                turns.append({"augmentation": which, **{k: res[k] for k in (
                    "train_step_ms", "wall_ms_per_step", "device_busy_ms_per_step",
                    "device_idle_share", "device_idle_share_by_events",
                    "device_launches_per_step")}})
                torch.cuda.empty_cache()
            row = {"card": report, "dtype": dtype, "channels_last": True,
                   "cudnn_benchmark": benchmark, "turns": turns}
            print(json.dumps(row), flush=True)
            augment_turns.append(row)

    summary = json.dumps({"card": report, "torch": torch.__version__, "cuda": torch.version.cuda,
                          "matrix": rows, "augmentation_before_after": augment_turns})
    print(summary, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            fh.write(summary + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
