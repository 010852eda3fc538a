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

Across processes (`core/distributed.py`) `--batch_size` is the GLOBAL batch
of the JAX package's data mesh, each rank holding its contiguous rows; the
primary alone logs and writes checkpoints, and a preemption signal is
agreed at the epoch's end, as in the flagship trainer.
"""

from __future__ import annotations

import dataclasses

import torch

from avtubes_torch.core.checkpoint import PreemptionGuard
from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.distributed import (
    check_group_matches_environment,
    is_primary,
    local_device,
    preempted_anywhere,
    rows_of,
    world_size,
)
from avtubes_torch.core.reference_checkpoint import load_reference_checkpoint
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.train.evaluate import make_gt_lookup_auto
from avtubes_torch.train.hardway import (
    _synthetic_gt_lookup,
    build_model,
    build_sources,
    check_supported,
    end_of_epoch_preempted,
    hardway_test,
    rows_loader,
    save_on_primary,
    train_epoch,
    warm_start_or_resume,
)
from avtubes_torch.train.state import create_train_state
from avtubes_torch.train.steps import hardway_1frame_fused_step
from avtubes_torch.train.train3d import draw_view1_flips
from avtubes_torch.utils.logging import MetricLogger

TAG = "hardway1frm"


def run(cfg: ExperimentConfig, steps_cap: int = 0, tag: str = TAG,
        do_eval: bool = True) -> dict:
    """Train, evaluate and checkpoint on `cfg.train.device` (the card unless
    the CPU is asked for; across ranks the rank's own card).  Returns the
    last step's metrics with the last evaluation's (the primary's).

    Across ranks `--batch_size` is the global batch, as in the JAX
    package's data mesh: each rank steps on its rows of it, with the flips
    of the global batch drawn from one generator on every rank, and every
    rank scores its rows of each test batch (`evaluate_hardway`,
    `sharded`)."""
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, frame_density=1))
    d, o = cfg.data, cfg.optim
    check_supported(cfg)
    check_group_matches_environment()
    device = local_device(cfg.train.device)
    spec_cfg = SpectrogramConfig(samplerate=d.samplerate, seconds=d.audio_seconds)
    train_src, test_src, _ = build_sources(cfg, shard_ids=False)
    loader = rows_loader(cfg, train_src)
    mine = rows_of(o.batch_size)
    multiproc = world_size() > 1
    steps_per_epoch = max(1, len(loader) if steps_cap == 0 else min(len(loader), steps_cap))
    # the same seed on every rank: the parameters start replicated
    model = build_model(cfg, torch.Generator().manual_seed(cfg.train.seed)).to(device)
    state = create_train_state(model, o, steps_per_epoch)
    state, start_epoch = warm_start_or_resume(cfg, tag, state, load_reference_checkpoint)

    logger = MetricLogger(cfg.train.summaries_dir, run_name=tag, enabled=is_primary())
    guard = PreemptionGuard()
    last: dict = {}
    watch = cfg.train.watch_every > 0
    gt_lookup = _synthetic_gt_lookup() if d.synthetic else make_gt_lookup_auto(d)
    for epoch in range(start_epoch, o.epochs):
        # the epoch's flips, drawn on the host: the global batch's, from the
        # same generator on every rank, each rank taking its rows
        gen = torch.Generator().manual_seed((cfg.train.seed + 3) * 1_000_003 + epoch)

        def step(batch: dict) -> dict:
            frames = batch["clip"][:, 0]
            flips = draw_view1_flips(gen, o.batch_size)[mine]
            return hardway_1frame_fused_step(state, frames, batch["waveform"], flips,
                                             spec_cfg, watch)

        metrics = train_epoch(state, loader, epoch, device, cfg, steps_cap, logger, guard,
                              step)
        if metrics:  # an epoch can yield zero batches
            last = metrics
        guard.preempted = preempted_anywhere(guard.preempted, device)
        if end_of_epoch_preempted(state, loader, epoch, cfg, tag, logger, guard,
                                  epoch_complete=multiproc):
            break
        if do_eval:
            last.update(hardway_test(state, test_src, d, spec_cfg, gt_lookup, epoch, logger,
                                     cfg.train.record_qualitative, sharded=True))
        if (epoch + 1) % cfg.train.checkpoint_every_epochs == 0:
            save_on_primary(cfg.train.summaries_dir, tag, epoch, state)
    logger.close()
    guard.restore()
    return last
