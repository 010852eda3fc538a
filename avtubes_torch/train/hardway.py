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

`--remat` checkpoints each backbone call (`models/remat.py`): the same
step, with each backbone's forward run again in the backward pass.

More than one process (`core/distributed.py`; one card a rank, NCCL on the
card, gloo on the CPU), as in the JAX package: `--batch_size` is per rank
(the global batch is batch_size x world), each rank reads `ids[rank::world]`
and runs the agreed number of steps an epoch (`agreed_steps_per_epoch`,
`fixed_count_batches`), draws the augmentation of the GLOBAL batch from the
same generator and takes its own rows, and the step averages the gradients
over the ranks, with the BatchNorm statistics and the negative pool of the
global batch.  A preemption signal is agreed at the epoch boundary (an
all-reduce of the flag) and the completed epoch saved.  The primary alone
logs, evaluates and writes checkpoints; the others wait at a barrier.  The
1-frame, 3D tube, consistency and flow-pretrain trainers run across
processes too, from these parts, but with a GLOBAL `--batch_size` of which
each rank holds its rows (`core/distributed.py::rows_of`).

What the JAX package has and this port does not, and which raises rather
than run something else: `--group_steps > 1` (not to port).
"""

from __future__ import annotations

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
from avtubes_torch.core.distributed import (
    agreed_steps_per_epoch,
    barrier,
    check_group_matches_environment,
    data_shard,
    fixed_count_batches,
    is_primary,
    local_device,
    preempted_anywhere,
    rank,
    rows_of,
    world_size,
)
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
    if cfg.train.group_steps > 1:
        raise NotImplementedError(
            "--group_steps > 1 groups steps to amortize a TPU dispatch; it is in "
            "ROADMAP.md's 'Not to port'")


def build_model(cfg: ExperimentConfig, generator: torch.Generator | None = None) -> AVENet:
    """AVENet of the configuration, its backbones in `--compute_dtype` (the
    parameters float32 either way; see `check_supported`) and checkpointed
    in training with `--remat`."""
    check_supported(cfg)
    return AVENet(hardway=cfg.hardway, generator=generator,
                  compute_dtype=cfg.train.compute_dtype, remat=cfg.train.remat)


def build_sources(cfg: ExperimentConfig, shard_ids: bool = True):
    """(train source, test source, number of training ids of the whole
    split).  Across ranks, with `shard_ids` (the flagship's per-rank
    batches), each reads `ids[rank::world]`, and the count is the split's,
    from which every rank agrees on its steps an epoch; without it (the
    trainers of a global batch, read by the rows loader) every rank holds
    the whole split."""
    d = cfg.data
    if d.synthetic:
        train_src = SyntheticSource(d, n=max(4 * cfg.optim.batch_size, 8))
        test_src = SyntheticSource(d, n=8, clip=False, seed=1)
        return train_src, test_src, len(train_src)
    all_train_ids = load_split(d.metadata_dir, d.testset, "train", d.subset)
    shard = data_shard() if shard_ids else None
    train_ids = all_train_ids[shard[0]::shard[1]] if shard else all_train_ids
    test_ids = load_split(d.metadata_dir, d.testset, "test_hardway")
    train_src = ClipTrainSource(d.data_path, train_ids, d)
    test_src = HardwayTestSource(d.og_data_path or d.data_path, test_ids, d)
    return train_src, test_src, len(all_train_ids)


def rows_loader(cfg: ExperimentConfig, train_src) -> BatchLoader:
    """The training loader of a trainer whose `--batch_size` is the global
    batch: across ranks each rank reads its rows of every global batch
    (`BatchLoader`'s rows mode); alone, the plain loader."""
    o = cfg.optim
    rows_of(o.batch_size)   # a world that does not divide the batch exits here
    return BatchLoader(train_src, o.batch_size, num_workers=cfg.data.n_threads,
                       shuffle=True, seed=cfg.train.seed, rows=(rank(), world_size()))


def run(cfg: ExperimentConfig, steps_cap: int = 0, tag: str = HARDWAY_TAG,
        do_eval: bool = True) -> dict:
    """Train, evaluate and checkpoint on `cfg.train.device` (the card unless
    the CPU is asked for; across ranks the rank's own card).  Returns the
    last step's metrics with the last evaluation's (the primary's) and the
    loader's skip count."""
    d, o = cfg.data, cfg.optim
    check_supported(cfg)
    check_group_matches_environment()
    device = local_device(cfg.train.device)
    world, me = world_size(), rank()
    multiproc = world > 1
    # `--negative_pool device`: the JAX package's per-device pool is the
    # frames of one device (its `pool_block`); one card a rank, that is the
    # rank's whole local batch, which the local head contrasts
    # (`parallel/__init__.py`)
    spec_cfg = SpectrogramConfig(samplerate=d.samplerate, seconds=d.audio_seconds)
    train_src, test_src, n_train_total = build_sources(cfg)
    loader = BatchLoader(train_src, o.batch_size, num_workers=d.n_threads,
                         shuffle=True, seed=cfg.train.seed)
    if multiproc:
        # every rank runs the same number of collective steps, derived from
        # the split's size, not from the local loader
        steps_per_epoch = agreed_steps_per_epoch(n_train_total, o.batch_size)
        if steps_cap:
            steps_per_epoch = min(steps_per_epoch, steps_cap)
    else:
        steps_per_epoch = max(1, len(loader) if steps_cap == 0
                              else min(len(loader), steps_cap))
    # the same seed on every rank: the parameters start replicated
    model = build_model(cfg, torch.Generator().manual_seed(cfg.train.seed)).to(device)
    state = create_train_state(model, o, steps_per_epoch)

    state, start_epoch = warm_start_or_resume(cfg, tag, state, load_reference_checkpoint)

    logger = MetricLogger(cfg.train.summaries_dir, run_name=tag, enabled=is_primary())
    guard = PreemptionGuard()
    last_metrics: dict = {}
    watch = cfg.train.watch_every > 0
    if do_eval:
        # epoch-invariant: the GT lookups are built once
        gt_lookup = _synthetic_gt_lookup() if d.synthetic else make_gt_lookup_auto(d)
        pf_gt_lookup = (make_gt_lookup_auto(d, per_frame=True)
                        if not d.synthetic and d.gt_path else None)
    for epoch in range(start_epoch, o.epochs):
        # the epoch's augmentation draws, made on the host: the global
        # batch's, from the same generator on every rank, each rank taking
        # its own rows (a world-n step is a world-1 step on the concatenated
        # batch)
        gen = torch.Generator().manual_seed((cfg.train.seed + 1) * 1_000_003 + epoch)

        def step(batch: dict) -> dict:
            clip = batch["clip"]
            b = clip.shape[0]
            draws = sample_augment_draws(b * world, gen, cfg.train.jitter_order,
                                         d.image_size, clip_size=clip.shape[2])
            return hardway_fused_train_step(state, clip, batch["waveform"],
                                            draws.rows(me * b, (me + 1) * b), spec_cfg,
                                            o.loss_weight, d.image_size, watch,
                                            negative_pool=cfg.train.negative_pool)

        metrics = train_epoch(state, loader, epoch, device, cfg, steps_cap, logger, guard,
                              step, agreed_steps=steps_per_epoch if multiproc else 0)
        if metrics:  # an epoch can yield zero batches (all skipped)
            last_metrics = metrics
        # consensus: preempt everywhere if ANY rank caught a signal
        guard.preempted = preempted_anywhere(guard.preempted, device)
        if end_of_epoch_preempted(state, loader, epoch, cfg, tag, logger, guard,
                                  epoch_complete=multiproc):
            break

        if do_eval and is_primary():
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
        if do_eval:
            barrier(f"avtubes_eval_ep{epoch}")   # the others wait out the evaluation

        if (epoch + 1) % cfg.train.checkpoint_every_epochs == 0:
            save_on_primary(cfg.train.summaries_dir, tag, epoch, state)

    logger.close()
    guard.restore()
    last_metrics["skipped_samples"] = loader.skipped
    return last_metrics


def save_on_primary(summaries_dir, tag: str, epoch: int, state: TrainState) -> None:
    """The primary alone writes the checkpoint; then every rank meets at a
    barrier, so none resumes or goes on before the file is whole."""
    if is_primary():
        save_checkpoint(summaries_dir, tag, epoch, state)
    barrier(f"avtubes_checkpoint_{tag}_ep{epoch}")


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
                guard: PreemptionGuard, step: Callable[[dict], dict],
                agreed_steps: int = 0) -> dict[str, float]:
    """One epoch of `step(batch)` (one update; returns its metrics as
    tensors) over the loader's batches, prefetched to `device`, at most
    `steps_cap` of them (0: all) and none after a preemption signal.  Logs
    every `log_every`-th step (every step under a cap) with the loader's
    wait, and the per-module norms every `watch_every`-th.  Returns the last
    step's metrics as floats; empty when the epoch yielded no batch.

    Across ranks a preemption signal does not stop the epoch: a rank that
    left mid-epoch would strand its peers inside the next collective, so
    the signal is agreed at the epoch's end instead.  With the flagship's
    per-rank batches (`agreed_steps` > 0) the epoch is EXACTLY
    `agreed_steps` batches (`fixed_count_batches`); the rows loader of the
    other trainers yields the same count on every rank by itself, and is
    told the cap (as every loader is), so that its agreement rounds end at
    the same batch."""
    step_in_epoch = 0
    metrics: dict = {}
    source = (fixed_count_batches(loader, epoch, agreed_steps) if agreed_steps
              else loader.epoch(epoch, limit=steps_cap))
    batches = device_prefetch(source, device, depth=cfg.data.prefetch)
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
            if guard.preempted and world_size() == 1:
                break
    finally:
        batches.close()
    return {k: float(v) for k, v in metrics.items()}


def end_of_epoch_preempted(state: TrainState, loader: BatchLoader, epoch: int,
                           cfg: ExperimentConfig, tag: str, logger: MetricLogger,
                           guard: PreemptionGuard, epoch_complete: bool = False) -> bool:
    """Log the epoch's skipped samples; after a preemption signal save the
    state (the primary) and return True.  A partial epoch is saved under the
    PREVIOUS epoch's number, so a resume re-runs it from the top (epoch - 1
    may be -1: it restarts at 0); a complete one (`epoch_complete`: across
    ranks the signal is agreed at the epoch's end) under its own."""
    if loader.epoch_skipped:
        logger.log(step=state.step, epoch=epoch, epoch_skipped=loader.epoch_skipped)
    if not guard.preempted:
        return False
    save_on_primary(cfg.train.summaries_dir, tag, epoch if epoch_complete else epoch - 1,
                    state)
    print(f"[train] preempted during epoch {epoch}; checkpoint saved")
    return True


def hardway_test(state: TrainState, test_src, d, spec_cfg: SpectrogramConfig, gt_lookup,
                 epoch: int, logger: MetricLogger, record: int = 0,
                 sharded: bool = False) -> dict[str, float]:
    """The hard-way test of one epoch, logged: samples in order, the last
    partial batch kept, decoded by `make_hardway_loader`'s mode for the
    transport (AVTUBES_EVAL_LOADER overrides it).  `sharded`: every rank
    calls it and scores its rows of each batch (`evaluate_hardway`); the
    primary returns the metrics, the others an empty dict."""
    eval_bsz = min(d.eval_batch_size, len(test_src))
    if isinstance(test_src, HardwayTestSource):
        test_loader = make_hardway_loader(test_src.root, test_src.ids, d, eval_bsz,
                                          num_workers=d.n_threads)
    else:
        test_loader = BatchLoader(test_src, eval_bsz, num_workers=d.n_threads,
                                  shuffle=False, drop_last=False)
    metrics = evaluate_hardway(state.model, test_loader, d, spec_cfg, gt_lookup, epoch=epoch,
                               logger=logger, record=record, sharded=sharded)
    if metrics:
        logger.log(step=state.step, epoch=epoch, **metrics)
    return metrics


def _synthetic_gt_lookup():
    """Centre-box GT for synthetic smoke runs (synthetic.py's XML box)."""
    gt = np.zeros((224, 224))
    lo, hi = int(224 * 64 / 256), int(224 * 192 / 256)
    gt[lo:hi, lo:hi] = 1.0
    return lambda vid, frame=None: gt
