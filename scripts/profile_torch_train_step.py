#!/usr/bin/env python3
"""Where one training step of the PyTorch/CUDA port spends the card's time.

    python3 scripts/profile_torch_train_step.py [--model hardway|tube3d|flowcons]
                                                [--batch 20] [--frames 16]
                                                [--image_size 224] [--steps 2]
                                                [--compute_dtype bfloat16]
                                                [--layout channels_last|contiguous]
                                                [--out DIR]

Makes one synthetic recipe batch on the card (uint8 clips of `--frames`
frames, int16 waveforms of 10 s at 22.05 kHz), its random draws and a
seeded train state (`avtubes_torch`, backbones in `--compute_dtype`, TF32
off) of the model's trainer: `hardway`, the flagship 16-frame two-view
step of AVENet (`hardway_fused_train_step`), `tube3d`, the 3D tube step
of FullModel (`train3d_fused_step`, view 1 only), or `flowcons`, the
flow-guided consistency step of AVENet (`train/flow.py::
flow_fused_train_step`, view 1 only, a frozen seeded FlowNetLite in float32
on the B·(T−1) frame pairs, `--flow_loss_weight` 0.1 by default;
`--no_flow` drops the flow net).  It runs `--steps` steps
under `torch.profiler` (CPU + CUDA activities) and prints one JSON line:
wall time per step on the host's clock, the device's busy time per step
(sum of kernel and memcpy device time), the idle share that follows from
the two, device launches per step, the device time of the hand-written K1
kernel and of K3's forward and backward kernels, of cuDNN's layout conversions (NCHW<->NHWC, and their 3-D kinds)
and of BatchNorm's kernels, the fifteen most expensive kernels, CUDA-event
times of the step's parts (spectrogram, augmentation, forward + loss,
backward, optimizer) and the peak device memory of a step.  `--layout
contiguous` turns the backbones' activations and conv weights from
channels-last (the port's only layout) to plain NCHW / NCDHW, to measure
what the layout costs.  With `--out` it also writes the Chrome trace there.  Needs one CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch

from avtubes_torch.core.config import OptimConfig
from avtubes_torch.core.device import device_report, resolve_device
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
from avtubes_torch.data.transforms import (
    augment_train_batch,
    augment_view1,
    sample_augment_draws,
)
from avtubes_torch.losses.losses import consistency_l2, hardway_loss, propagation_loss
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.models.fullmodel import FullModel
from avtubes_torch.train.state import create_train_state
from avtubes_torch.train.steps import (
    _fold_time,
    hardway_fused_train_step,
    train3d_fused_step,
)


def cuda_ms(fn, iters: int = 3, warmup: int = 1) -> float:
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


def recipe_batch(dev: torch.device, batch: int, frames: int, image_size: int,
                 spec_cfg: SpectrogramConfig, seed: int = 0):
    """(clips uint8 (B,T,S,S,3), int16 waveforms (B, num_samples), draws),
    made on the card from `seed`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    clips = torch.randint(0, 256, (batch, frames, image_size, image_size, 3),
                          generator=g, device=dev, dtype=torch.uint8)
    waves = (torch.randn(batch, spec_cfg.num_samples, generator=g, device=dev) * 0.1
             ).clamp(-1, 1).mul(32768.0).round().clamp(-32768, 32767).to(torch.int16)
    draws = sample_augment_draws(batch, torch.Generator().manual_seed(seed), "random",
                                 image_size)
    return clips, waves, draws


#: name parts of cuDNN's layout-conversion kernels (2-D and 3-D)
LAYOUT_CONVERSIONS = ("nchwToNhwc", "nhwcToNchw", "ncdhwToNdhwc", "ndhwcToNcdhw")
#: name parts of BatchNorm's kernels (PyTorch's native ones and cuDNN's)
BATCHNORM = ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")


def profile_train_step(step, steps: int = 2, out: str | None = None,
                       warm: bool = True) -> dict:
    """Profile `steps` calls of `step()` (one training step on a resident
    batch), after a warm one unless the caller has just run it; returns the
    busy/idle/launch breakdown (see the module docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / steps
    # device-side rows only (kernels and memcpys): the host-side operator rows
    # repeat the device time of the kernels they launched, and so does the
    # device-side span of the optimizer's own annotation
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        raise RuntimeError("profiler recorded no device time; time with CUDA events instead")
    if busy_ms > wall_ms:
        raise RuntimeError(f"device busy {busy_ms:.3f} ms exceeds wall {wall_ms:.3f} ms "
                           "per step: the row filter double-counts")
    if out:
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "train_step_trace.json"))
    return {
        "steps_profiled": steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_step": sum(r[2] for r in rows),
        "k1_kernel_ms_per_step": sum(ms for k, ms, _ in rows if "log_spectrogram" in k),
        "k1_launches_per_step": sum(c for k, _, c in rows if "log_spectrogram" in k),
        "k3_forward_kernel_ms_per_step": sum(ms for k, ms, _ in rows if "corr_fwd" in k),
        "k3_forward_launches_per_step": sum(c for k, _, c in rows if "corr_fwd" in k),
        "k3_backward_kernel_ms_per_step": sum(ms for k, ms, _ in rows if "corr_bwd" in k),
        "layout_conversions_per_step": sum(
            c for k, _, c in rows if any(n in k for n in LAYOUT_CONVERSIONS)),
        "layout_conversions_ms_per_step": sum(
            ms for k, ms, _ in rows if any(n in k for n in LAYOUT_CONVERSIONS)),
        "layout_conversion_kernels": [
            {"name": k[:120], "ms": ms, "calls": calls} for k, ms, calls in rows
            if any(n in k for n in LAYOUT_CONVERSIONS)],
        "batchnorm_ms_per_step": sum(
            ms for k, ms, _ in rows if any(n in k.lower() for n in BATCHNORM)),
        "top_kernels_ms_per_step": [
            {"name": k[:80], "ms": ms, "calls": calls} for k, ms, calls in rows[:15]],
    }


def step_parts_ms(state, clips, waves, draws, spec_cfg: SpectrogramConfig,
                  image_size: int) -> dict:
    """CUDA-event times of the step's parts, each alone."""
    model = state.model
    b, t = clips.shape[:2]
    with torch.no_grad():
        spec = log_spectrogram(waves, spec_cfg)[..., None]
        v1, v2 = augment_train_batch(clips, draws, image_size)
    parts = {"log_spectrogram_K1": cuda_ms(lambda: log_spectrogram(waves, spec_cfg)),
             "augment_two_views": cuda_ms(lambda: augment_train_batch(clips, draws, image_size))}

    def forward_loss():
        out, out2 = model.two_view_forward(_fold_time(v1), _fold_time(v2), spec, t)
        l2 = consistency_l2(out.weighted_map, out2.weighted_map) * 99.9
        prop = (propagation_loss(out.weighted_map.reshape(b, t, *out.weighted_map.shape[1:]))
                + propagation_loss(out2.weighted_map.reshape(b, t,
                                                             *out2.weighted_map.shape[1:])))
        return (hardway_loss(out.logits) + hardway_loss(out2.logits)) * 0.05 + l2 + prop

    model.train()
    parts["two_view_forward_and_loss"] = cuda_ms(forward_loss)
    return _backward_and_adam(state, forward_loss, parts)


def tube3d_step_parts_ms(state, clips, waves, flip1, spec_cfg: SpectrogramConfig) -> dict:
    """CUDA-event times of the 3D tube step's parts, each alone."""
    model = state.model
    with torch.no_grad():
        spec = log_spectrogram(waves, spec_cfg)[..., None]
        video = augment_view1(clips, flip1)
    parts = {"log_spectrogram_K1": cuda_ms(lambda: log_spectrogram(waves, spec_cfg)),
             "augment_view1": cuda_ms(lambda: augment_view1(clips, flip1))}

    def forward_loss():
        return hardway_loss(model.forward_shared_audio(spec, video).logits)

    model.train()
    parts["forward_and_loss"] = cuda_ms(forward_loss)
    return _backward_and_adam(state, forward_loss, parts)


def flowcons_step_parts_ms(state, flow_net, clips, waves, flip1, spec_cfg: SpectrogramConfig,
                           flow_loss_weight: float = 0.1, compute_flow: bool = True) -> dict:
    """CUDA-event times of the consistency step's parts, each alone."""
    from avtubes_torch.train.flow import frame_pair_flow, warp_consistency

    model = state.model
    b, t = clips.shape[:2]
    with torch.no_grad():
        spec = log_spectrogram(waves, spec_cfg)[..., None]
        video = augment_view1(clips, flip1)
        flow = frame_pair_flow(flow_net, video) if compute_flow else None
    parts = {"log_spectrogram_K1": cuda_ms(lambda: log_spectrogram(waves, spec_cfg)),
             "augment_view1": cuda_ms(lambda: augment_view1(clips, flip1))}
    if compute_flow:
        parts["frozen_flow_net_K3"] = cuda_ms(lambda: frame_pair_flow(flow_net, video))

    def forward_loss():
        out = model.forward_shared_audio(_fold_time(video), spec)
        loss = hardway_loss(out.logits)
        if compute_flow:
            pos = out.pos.reshape(b, t, *out.pos.shape[1:])
            loss = loss + flow_loss_weight * warp_consistency(pos, flow, video.shape[2])
        return loss

    model.train()
    parts["forward_and_loss"] = cuda_ms(forward_loss)
    return _backward_and_adam(state, forward_loss, parts)


def _backward_and_adam(state, forward_loss, parts: dict) -> dict:
    """`parts` with the times of forward + loss + backward and of the Adam
    update."""
    def forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        forward_loss().backward()

    parts["forward_loss_backward"] = cuda_ms(forward_backward)
    forward_backward()
    parts["adam_update"] = cuda_ms(state.optimizer.step)
    return parts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="hardway", choices=("hardway", "tube3d", "flowcons"))
    p.add_argument("--flow_loss_weight", type=float, default=0.1)
    p.add_argument("--no_flow", action="store_true")
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--compute_dtype", default="bfloat16", choices=("float32", "bfloat16"))
    p.add_argument("--layout", default="channels_last", choices=("channels_last", "contiguous"))
    p.add_argument("--out", default=None, help="directory for the Chrome trace")
    a = p.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")                       # the card, or an error
    spec_cfg = SpectrogramConfig()
    net = FullModel if a.model == "tube3d" else AVENet
    model = net(generator=torch.Generator().manual_seed(0), compute_dtype=a.compute_dtype)
    if a.layout == "contiguous":
        for backbone in model.children():
            backbone.memory_format = torch.contiguous_format
        model.to(memory_format=torch.contiguous_format)
    model = model.to(dev)
    state = create_train_state(model, OptimConfig())
    clips, waves, draws = recipe_batch(dev, a.batch, a.frames, a.image_size, spec_cfg)
    if a.model == "hardway":
        def step():
            return hardway_fused_train_step(state, clips, waves, draws, spec_cfg,
                                            image_size=a.image_size)

        def parts():
            return step_parts_ms(state, clips, waves, draws, spec_cfg, a.image_size)
    elif a.model == "tube3d":
        def step():
            return train3d_fused_step(state, clips, waves, draws.flip1, spec_cfg)

        def parts():
            return tube3d_step_parts_ms(state, clips, waves, draws.flip1, spec_cfg)
    else:
        from avtubes_torch.models.flownet import FlowNetLite
        from avtubes_torch.train.flow import flow_fused_train_step

        flow_net = FlowNetLite(generator=torch.Generator().manual_seed(7)).to(dev)
        flow_net.eval().requires_grad_(False)
        weight, compute_flow = (0.0, False) if a.no_flow else (a.flow_loss_weight, True)

        def step():
            return flow_fused_train_step(state, flow_net, clips, waves, draws.flip1, spec_cfg,
                                         weight, compute_flow=compute_flow)

        def parts():
            return flowcons_step_parts_ms(state, flow_net, clips, waves, draws.flip1, spec_cfg,
                                          weight, compute_flow)
    torch.cuda.reset_peak_memory_stats(dev)
    report = profile_train_step(step, a.steps, a.out)
    report["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    report["cuda_event_ms"] = parts()
    if a.model == "flowcons":
        report["flow"] = "off" if a.no_flow else f"weight {a.flow_loss_weight}"
    print(json.dumps({"card": device_report(), "model": a.model, "batch": a.batch,
                      "frames": a.frames, "image_size": a.image_size,
                      "compute_dtype": a.compute_dtype, "layout": a.layout, **report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
