"""CLI: profile training or inference steps of the port.

Counterpart of `avtubes/cli/profile.py`: N steps under `torch.profiler`
(`utils/debug.py::trace`), each step synchronized and timed on the host's
clock, the trace written where TensorBoard's profile plugin reads it.

    python -m avtubes_torch.cli.profile --mode train --steps 5 \\
        --batch_size 20 [--logdir DIR] [--device cuda]
    python -m avtubes_torch.cli.profile --mode infer --steps 5 \\
        --batch_size 128 [--quant int8]
    python -m avtubes_torch.cli.profile --mode train3d --steps 3

Modes, all with bfloat16 backbones and seeded weights:
  train    the flagship two-view hard-way step (`hardway_fused_train_step`)
           on `--batch_size` clips (default 20) of `--frame_density` frames;
  train3d  the 3D tube step of FullModel (`train3d_fused_step`, view 1);
  infer    the served pipeline on `--batch_size` frames (default 128):
           K1 -> AVENet -> K2 (`core/export.py::LocalizerPipeline`), with
           `--quant int8` its int8 convolutions; cuDNN's autotuner on, as
           `cli/serve.py` runs it.  The JAX package's infer mode uses the
           space-to-depth stems, which are not ported (ROADMAP.md, "Not to
           port"): this one runs the plain 7x7 stems.

One untimed step comes first (kernel builds, cuDNN's choices, the
allocator's cache).  Prints each step's milliseconds and the median with
clips/s, then for the training modes the step's parts as the spans of
`utils/debug.py::span` recorded them (`train.step` and its `train.input`,
`train.forward`, `train.backward`, `train.optimizer`): each part's median
host ms, device ms (its CUDA events) and, on the card, idle ms (the card's
idle gaps in the written trace whose middle falls inside the part: the
host was in it when the card ran dry).  `--device` defaults to the card and
raises without one (`--device cpu` asks for the CPU).  TF32 is off, as in
every CLI of the port.
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None) -> list[float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="train", choices=["train", "infer", "train3d"])
    p.add_argument("--steps", default=5, type=int)
    p.add_argument("--batch_size", default=0, type=int,
                   help="0 = mode default (train 20, infer 128)")
    p.add_argument("--image_size", default=224, type=int)
    p.add_argument("--frame_density", default=16, type=int)
    p.add_argument("--samplerate", default=22050, type=int)
    p.add_argument("--audio_seconds", default=10, type=int)
    p.add_argument("--logdir", default=None, type=str,
                   help="trace directory (default: <temporary directory>/avtubes_torch_trace)")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="infer mode only: int8 QuantConv2d backbones")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises without a card")
    a = p.parse_args(argv)

    from avtubes_torch.core.device import disable_tf32, resolve_device
    from avtubes_torch.data.spectrogram import SpectrogramConfig
    from avtubes_torch.utils.debug import (
        StepTimer,
        clear_spans,
        finished_spans,
        span_table,
        trace,
    )

    dev = resolve_device(a.device)
    disable_tf32()
    spec_cfg = SpectrogramConfig(samplerate=a.samplerate, seconds=a.audio_seconds)
    gen = torch.Generator().manual_seed(0)
    data_gen = torch.Generator(device=dev).manual_seed(0)

    def waves(b: int) -> torch.Tensor:
        return (torch.randn(b, spec_cfg.num_samples, generator=data_gen, device=dev)
                * 0.1).clamp(-1, 1)

    def uint8(*shape) -> torch.Tensor:
        return torch.randint(0, 256, shape, generator=data_gen, device=dev, dtype=torch.uint8)

    if a.mode in ("train", "train3d"):
        from avtubes_torch.core.config import OptimConfig
        from avtubes_torch.train.state import create_train_state

        b = a.batch_size or 20
        clips = uint8(b, a.frame_density, a.image_size, a.image_size, 3)
        w = waves(b)
        if a.mode == "train":
            from avtubes_torch.data.transforms import sample_augment_draws
            from avtubes_torch.models.avenet import AVENet
            from avtubes_torch.train.steps import hardway_fused_train_step

            state = create_train_state(
                AVENet(generator=gen, compute_dtype="bfloat16").to(dev), OptimConfig())

            def run(i: int) -> torch.Tensor:
                draws = sample_augment_draws(b, torch.Generator().manual_seed(i), "random",
                                             a.image_size)
                return hardway_fused_train_step(state, clips, w, draws, spec_cfg, 0.1,
                                                a.image_size)["loss"]
        else:
            from avtubes_torch.models.fullmodel import FullModel
            from avtubes_torch.train.steps import train3d_fused_step

            state = create_train_state(
                FullModel(generator=gen, compute_dtype="bfloat16").to(dev), OptimConfig())

            def run(i: int) -> torch.Tensor:
                flip1 = torch.rand(b, generator=torch.Generator().manual_seed(i)) < 0.5
                return train3d_fused_step(state, clips, w, flip1, spec_cfg)["loss"]
    else:
        from avtubes_torch.core.export import LocalizerPipeline
        from avtubes_torch.models.avenet import AVENet

        b = a.batch_size or 128
        torch.backends.cudnn.benchmark = True
        model = AVENet(generator=gen, compute_dtype="bfloat16", quant_int8=a.quant == "int8")
        pipeline = LocalizerPipeline(model, spec_cfg, a.image_size).to(dev)
        frames = uint8(b, a.image_size, a.image_size, 3)
        w = waves(b)

        def run(i: int) -> torch.Tensor:
            return pipeline(frames, w)[0]

    StepTimer().tick(run(0))                # untimed: builds, cuDNN's choices, the allocator
    clear_spans()
    with trace(a.logdir, dev) as logdir:
        timer = StepTimer()
        for i in range(a.steps):
            timer.tick(run(i + 1))
    times = timer.history
    for i, dt in enumerate(times):
        print(f"step {i}: {dt * 1e3:.1f} ms")
    med = sorted(times)[len(times) // 2]
    print(f"median: {med * 1e3:.1f} ms/step ({b / med:.1f} clips/s; each step "
          f"synchronized, on {dev}{', int8' if a.quant else ''})")
    spans = finished_spans()
    if spans:
        written = max((os.path.join(logdir, f) for f in os.listdir(logdir)
                       if f.endswith(".pt.trace.json")), key=os.path.getmtime)
        print(span_table(spans, written if dev.type == "cuda" else None))
    print(f"trace written to {logdir} (view: tensorboard --logdir {logdir})")
    return times


if __name__ == "__main__":
    main()
