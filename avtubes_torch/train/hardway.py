"""The flagship 16-frame hard-way trainer (PyTorch).

Counterpart of `avtubes/train/hardway.py`.  An epoch is {train, hard-way
test, per-frame test, checkpoint}:

  host threads decode JPEG clips + WAVs (or make synthetic ones) ->
  device prefetch (pinned memory, side stream) ->
  one eager step per batch on the card: log-spectrogram (K1), two-view
  augmentation, both backbones in `--compute_dtype` (bfloat16 by default,
  as in the JAX package), hard-way head in float32, 4-term loss, Adam
  update.

The per-frame whole-video test runs, as in the JAX package, when
`--gt_path` is given and `<data_path>/videos/` exists: every video
`videos/<id>.mp4` of the test split is decoded (`PerFrameEvalSource`) and
scored frame by frame; when every video is skipped its three metrics are
NaN.  `--record_qualitative N` writes the overlay images of the first N
samples of each test under `<summaries_dir>/images/`.

`train_epoch`, `hardway_test` and `warm_start_or_resume` are the loop's
parts that the 1-frame and 3D tube trainers (`train/hardway_1frame.py`,
`train/train3d.py`) share with this one.

Single process, one device.  What the JAX package has and this port does
not yet, and which raises rather than run something else: `--remat`,
`--group_steps > 1` and more than one process.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch

from avtubes_torch.core.checkpoint import (
    PreemptionGuard,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import resolve_device
from avtubes_torch.core.reference_checkpoint import load_reference_checkpoint
from avtubes_torch.data.index import load_split
from avtubes_torch.data.pipeline import (
    BatchLoader,
    ClipTrainSource,
    HardwayTestSource,
    PerFrameEvalSource,
    SyntheticSource,
    device_prefetch,
    make_hardway_loader,
)
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.data.transforms import sample_augment_draws
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.models.resnet2d import COMPUTE_DTYPES
from avtubes_torch.train.evaluate import (
    evaluate_hardway,
    evaluate_perframe,
    make_gt_lookup_auto,
)
from avtubes_torch.train.state import TrainState, create_train_state
from avtubes_torch.train.steps import hardway_fused_train_step
from avtubes_torch.utils.logging import MetricLogger

HARDWAY_TAG = "hardway16"


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise for a configuration whose code is not ported, naming the
    ROADMAP item it waits for."""
    if cfg.train.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"--compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, "
                         f"got {cfg.train.compute_dtype!r}")
    if cfg.train.remat:
        raise NotImplementedError(
            "--remat is not ported to avtubes_torch (ROADMAP.md Queue 1 item 12: "
            "torch.utils.checkpoint re-runs BatchNorm in training mode)")
    if cfg.train.group_steps > 1:
        raise NotImplementedError(
            "--group_steps > 1 groups steps to amortize a TPU dispatch; it is in "
            "ROADMAP.md's 'Not to port'")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or (
            torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "more than one process is not ported to avtubes_torch (ROADMAP.md "
            "Queue 1 item 7, multi-GPU)")


def build_model(cfg: ExperimentConfig, generator: torch.Generator | None = None) -> AVENet:
    """AVENet of the configuration, its backbones in `--compute_dtype` (the
    parameters float32 either way; see `check_supported`)."""
    check_supported(cfg)
    return AVENet(hardway=cfg.hardway, generator=generator,
                  compute_dtype=cfg.train.compute_dtype)


def build_sources(cfg: ExperimentConfig):
    """(train source, test source, number of training ids)."""
    d = cfg.data
    if d.synthetic:
        train_src = SyntheticSource(d, n=max(4 * cfg.optim.batch_size, 8))
        test_src = SyntheticSource(d, n=8, clip=False, seed=1)
        return train_src, test_src, len(train_src)
    train_ids = load_split(d.metadata_dir, d.testset, "train", d.subset)
    test_ids = load_split(d.metadata_dir, d.testset, "test_hardway")
    train_src = ClipTrainSource(d.data_path, train_ids, d)
    test_src = HardwayTestSource(d.og_data_path or d.data_path, test_ids, d)
    return train_src, test_src, len(train_ids)


def run(cfg: ExperimentConfig, steps_cap: int = 0, tag: str = HARDWAY_TAG,
        do_eval: bool = True) -> dict:
    """Train, evaluate and checkpoint on `cfg.train.device` (the card unless
    the CPU is asked for).  Returns the last step's metrics with the last
    evaluation's and the loader's skip count."""
    d, o = cfg.data, cfg.optim
    check_supported(cfg)
    device = resolve_device(cfg.train.device)
    if cfg.train.negative_pool == "device":
        # the per-device pool of the JAX package's formula on one device:
        # every frame of the batch
        cfg = dataclasses.replace(cfg, hardway=dataclasses.replace(
            cfg.hardway, pool_block=o.batch_size * max(d.frame_density, 1)))
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
    last_metrics: dict = {}
    watch = cfg.train.watch_every > 0
    if do_eval:
        # epoch-invariant: the GT lookups are built once
        gt_lookup = _synthetic_gt_lookup() if d.synthetic else make_gt_lookup_auto(d)
        pf_gt_lookup = (make_gt_lookup_auto(d, per_frame=True)
                        if not d.synthetic and d.gt_path else None)
    for epoch in range(start_epoch, o.epochs):
        # the epoch's augmentation draws, made on the host
        gen = torch.Generator().manual_seed((cfg.train.seed + 1) * 1_000_003 + epoch)

        def step(batch: dict) -> dict:
            clip = batch["clip"]
            draws = sample_augment_draws(clip.shape[0], gen, cfg.train.jitter_order,
                                         d.image_size, clip_size=clip.shape[2])
            return hardway_fused_train_step(state, clip, batch["waveform"], draws, spec_cfg,
                                            o.loss_weight, d.image_size, watch)

        metrics = train_epoch(state, loader, epoch, device, cfg, steps_cap, logger, guard,
                              step)
        if metrics:  # an epoch can yield zero batches (all skipped)
            last_metrics = metrics
        if end_of_epoch_preempted(state, loader, epoch, cfg, tag, logger, guard):
            break

        if do_eval:
            eval_metrics = hardway_test(state, test_src, d, spec_cfg, gt_lookup, epoch,
                                        logger, cfg.train.record_qualitative)
            last_metrics.update(eval_metrics)

            # the per-frame whole-video test, where its videos and GT are given
            video_root = Path(d.data_path)
            if pf_gt_lookup is not None and (video_root / "videos").exists():
                pf_src = PerFrameEvalSource(video_root,
                                            load_split(d.metadata_dir, d.testset, "test"), d)
                pf = evaluate_perframe(state.model, pf_src, d, spec_cfg, pf_gt_lookup,
                                       logger=logger, record=cfg.train.record_qualitative,
                                       epoch=epoch)
                last_metrics.update(pf)
                logger.log(step=state.step, epoch=epoch, **pf)

        if (epoch + 1) % cfg.train.checkpoint_every_epochs == 0:
            save_checkpoint(cfg.train.summaries_dir, tag, epoch, state)

    logger.close()
    guard.restore()
    last_metrics["skipped_samples"] = loader.skipped
    return last_metrics


def warm_start_or_resume(cfg: ExperimentConfig, tag: str, state: TrainState,
                         load_reference: Callable) -> tuple[TrainState, int]:
    """With `--use_pretrained`: a `.pth` / `.pth.tar` checkpoint of the
    original implementation is loaded by `load_reference(path, model)`
    (weights only); any other, or the newest `<tag>_ep<N>` of summaries_dir,
    is resumed from.  Returns the state and the epoch to start at."""
    if not cfg.train.use_pretrained:
        return state, 0
    ckpt = cfg.train.pretrained_path or latest_checkpoint(cfg.train.summaries_dir, tag)
    if ckpt and str(ckpt).endswith((".pth", ".pth.tar")):
        load_reference(ckpt, state.model)
        print(f"[train] warm-started from reference checkpoint {ckpt}")
        return state, 0
    if ckpt:
        state, epoch = restore_checkpoint(ckpt, state)
        print(f"[train] resumed from {ckpt} at epoch {epoch + 1}")
        return state, epoch + 1
    return state, 0


def train_epoch(state: TrainState, loader: BatchLoader, epoch: int, device: torch.device,
                cfg: ExperimentConfig, steps_cap: int, logger: MetricLogger,
                guard: PreemptionGuard, step: Callable[[dict], dict]) -> dict[str, float]:
    """One epoch of `step(batch)` (one update; returns its metrics as
    tensors) over the loader's batches, prefetched to `device`, at most
    `steps_cap` of them (0: all) and none after a preemption signal.  Logs
    every `log_every`-th step (every step under a cap) with the loader's
    wait, and the per-module norms every `watch_every`-th.  Returns the last
    step's metrics as floats; empty when the epoch yielded no batch."""
    step_in_epoch = 0
    metrics: dict = {}
    batches = device_prefetch(loader.epoch(epoch), device, depth=cfg.data.prefetch)
    try:
        while not (steps_cap and step_in_epoch >= steps_cap):
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            waited_ms = (time.perf_counter() - t0) * 1e3
            metrics = step(batch)
            step_in_epoch += 1
            norms = {k: v for k, v in metrics.items() if "_norm/" in k}
            metrics = {k: v for k, v in metrics.items() if "_norm/" not in k}
            if step_in_epoch % cfg.train.log_every == 0 or steps_cap:
                logger.log(step=state.step, epoch=epoch, loader_wait_ms=waited_ms,
                           **{k: float(v) for k, v in metrics.items()})
            if norms and step_in_epoch % cfg.train.watch_every == 0:
                logger.log(step=state.step, epoch=epoch,
                           **{k: float(v) for k, v in norms.items()})
            if guard.preempted:
                break
    finally:
        batches.close()
    return {k: float(v) for k, v in metrics.items()}


def end_of_epoch_preempted(state: TrainState, loader: BatchLoader, epoch: int,
                           cfg: ExperimentConfig, tag: str, logger: MetricLogger,
                           guard: PreemptionGuard) -> bool:
    """Log the epoch's skipped samples; after a preemption signal save the
    state and return True.  The partial epoch is saved under the PREVIOUS
    epoch's number, so a resume re-runs it from the top (epoch - 1 may be
    -1: it restarts at 0)."""
    if loader.epoch_skipped:
        logger.log(step=state.step, epoch=epoch, epoch_skipped=loader.epoch_skipped)
    if not guard.preempted:
        return False
    save_checkpoint(cfg.train.summaries_dir, tag, epoch - 1, state)
    print(f"[train] preempted during epoch {epoch}; checkpoint saved")
    return True


def hardway_test(state: TrainState, test_src, d, spec_cfg: SpectrogramConfig, gt_lookup,
                 epoch: int, logger: MetricLogger, record: int = 0) -> dict[str, float]:
    """The hard-way test of one epoch, logged: samples decoded by worker
    threads, in order, the last partial batch kept."""
    eval_bsz = min(d.eval_batch_size, len(test_src))
    if isinstance(test_src, HardwayTestSource):
        test_loader = make_hardway_loader(test_src.root, test_src.ids, d, eval_bsz,
                                          num_workers=d.n_threads)
    else:
        test_loader = BatchLoader(test_src, eval_bsz, num_workers=d.n_threads,
                                  shuffle=False, drop_last=False)
    metrics = evaluate_hardway(state.model, test_loader, d, spec_cfg, gt_lookup, epoch=epoch,
                               logger=logger, record=record)
    logger.log(step=state.step, epoch=epoch, **metrics)
    return metrics


def _synthetic_gt_lookup():
    """Centre-box GT for synthetic smoke runs (synthetic.py's XML box)."""
    gt = np.zeros((224, 224))
    lo, hi = int(224 * 64 / 256), int(224 * 192 / 256)
    gt[lo:hi, lo:hi] = 1.0
    return lambda vid, frame=None: gt
