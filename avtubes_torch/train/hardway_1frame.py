"""Single-frame hard-way trainer (PyTorch).

Counterpart of `avtubes/train/hardway_1frame.py`: the plain hard-way CE of
AVENet on the middle frame of each clip (the original 1-frame recipe).
`frame_density` is forced to 1, so the source yields one frame a clip and
the step takes `batch["clip"][:, 0]`.  An epoch is {train, hard-way test,
checkpoint `hardway1frm_ep<N>`}:

  host threads decode frames + WAVs (or make synthetic ones) ->
  device prefetch ->
  one eager step per batch on the card: log-spectrogram (K1), ImageNet
  normalization, a random horizontal flip a frame (drawn on the host), both
  backbones in `--compute_dtype`, hard-way head in float32, CE, Adam.

The hard-way test launches K1 and K2 once a batch; `--record_qualitative N`
writes the overlays of its first N samples.  `--use_pretrained` resumes from
the newest `hardway1frm_ep<N>` (or warm-starts from an original `.pth.tar`).
What is not ported raises through `train/hardway.py::check_supported`, as
in the flagship trainer.
"""

from __future__ import annotations

import dataclasses

import torch

from avtubes_torch.core.checkpoint import PreemptionGuard, save_checkpoint
from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import resolve_device
from avtubes_torch.core.reference_checkpoint import load_reference_checkpoint
from avtubes_torch.data.pipeline import BatchLoader
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.train.evaluate import make_gt_lookup_auto
from avtubes_torch.train.hardway import (
    _synthetic_gt_lookup,
    build_model,
    build_sources,
    check_supported,
    end_of_epoch_preempted,
    hardway_test,
    train_epoch,
    warm_start_or_resume,
)
from avtubes_torch.train.state import create_train_state
from avtubes_torch.train.steps import hardway_1frame_fused_step
from avtubes_torch.utils.logging import MetricLogger

TAG = "hardway1frm"


def run(cfg: ExperimentConfig, steps_cap: int = 0, tag: str = TAG,
        do_eval: bool = True) -> dict:
    """Train, evaluate and checkpoint on `cfg.train.device` (the card unless
    the CPU is asked for).  Returns the last step's metrics with the last
    evaluation's."""
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, frame_density=1))
    d, o = cfg.data, cfg.optim
    check_supported(cfg)
    device = resolve_device(cfg.train.device)
    spec_cfg = SpectrogramConfig(samplerate=d.samplerate, seconds=d.audio_seconds)
    train_src, test_src, _ = build_sources(cfg)
    loader = BatchLoader(train_src, o.batch_size, num_workers=d.n_threads,
                         shuffle=True, seed=cfg.train.seed)
    steps_per_epoch = max(1, len(loader) if steps_cap == 0 else min(len(loader), steps_cap))
    model = build_model(cfg, torch.Generator().manual_seed(cfg.train.seed)).to(device)
    state = create_train_state(model, o, steps_per_epoch)
    state, start_epoch = warm_start_or_resume(cfg, tag, state, load_reference_checkpoint)

    logger = MetricLogger(cfg.train.summaries_dir, run_name=tag)
    guard = PreemptionGuard()
    last: dict = {}
    watch = cfg.train.watch_every > 0
    gt_lookup = _synthetic_gt_lookup() if d.synthetic else make_gt_lookup_auto(d)
    for epoch in range(start_epoch, o.epochs):
        # the epoch's flips, drawn on the host
        gen = torch.Generator().manual_seed((cfg.train.seed + 3) * 1_000_003 + epoch)

        def step(batch: dict) -> dict:
            frames = batch["clip"][:, 0]
            flips = torch.rand(frames.shape[0], generator=gen) < 0.5
            return hardway_1frame_fused_step(state, frames, batch["waveform"], flips,
                                             spec_cfg, watch)

        metrics = train_epoch(state, loader, epoch, device, cfg, steps_cap, logger, guard,
                              step)
        if metrics:  # an epoch can yield zero batches
            last = metrics
        if end_of_epoch_preempted(state, loader, epoch, cfg, tag, logger, guard):
            break
        if do_eval:
            last.update(hardway_test(state, test_src, d, spec_cfg, gt_lookup, epoch, logger,
                                     cfg.train.record_qualitative))
        if (epoch + 1) % cfg.train.checkpoint_every_epochs == 0:
            save_checkpoint(cfg.train.summaries_dir, tag, epoch, state)
    logger.close()
    guard.restore()
    return last
