"""The flagship 16-frame hard-way trainer (PyTorch).

Counterpart of `avtubes/train/hardway.py`.  An epoch is {train, hard-way
test, checkpoint}:

  host threads decode JPEG clips + WAVs (or make synthetic ones) ->
  device prefetch (pinned memory, side stream) ->
  one eager step per batch on the card: log-spectrogram (K1), two-view
  augmentation, both backbones, hard-way head, 4-term loss, Adam update.

Single process, one device.  What the JAX package has and this port does not
yet, and which raises rather than run something else: bf16 compute
(`--compute_dtype bfloat16`, the flag's default, as in the JAX package),
`--remat`, `--group_steps > 1`, more than one process, and the per-frame
test that the JAX package's epoch adds where `--gt_path` and the test videos
`videos/<id>.mp4` are given (it decodes them with a video library).
"""

from __future__ import annotations

import dataclasses
import os
import time
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
from avtubes_torch.data.index import load_split
from avtubes_torch.data.pipeline import (
    BatchLoader,
    ClipTrainSource,
    HardwayTestSource,
    SyntheticSource,
    device_prefetch,
    make_hardway_loader,
)
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.data.transforms import sample_augment_draws
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.train.evaluate import evaluate_hardway, make_gt_lookup_auto
from avtubes_torch.train.state import create_train_state
from avtubes_torch.train.steps import hardway_fused_train_step
from avtubes_torch.utils.logging import MetricLogger

HARDWAY_TAG = "hardway16"


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise for a configuration whose code is not ported, naming the
    ROADMAP item it waits for."""
    if cfg.train.compute_dtype != "float32":
        raise NotImplementedError(
            f"--compute_dtype {cfg.train.compute_dtype}: only float32 is ported to "
            "avtubes_torch; the bf16 knob is ROADMAP.md Queue 1 item 6 (pass "
            "--compute_dtype float32)")
    if cfg.train.remat:
        raise NotImplementedError(
            "--remat is not ported to avtubes_torch (ROADMAP.md Queue 1 item 6: "
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
    """AVENet of the configuration (float32; see `check_supported`)."""
    check_supported(cfg)
    return AVENet(hardway=cfg.hardway, generator=generator)


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
    if do_eval and not d.synthetic and d.gt_path and _test_videos(d):
        # the JAX package's epoch then also runs the per-frame test on them
        raise NotImplementedError(
            "the per-frame test decodes videos/<id>.mp4 (PerFrameEvalSource), which "
            "needs a video decoder and is not ported to avtubes_torch (ROADMAP.md "
            "Queue 1 item 5, still open); drop --gt_path to train without it")
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

    start_epoch = 0
    if cfg.train.use_pretrained:
        ckpt = cfg.train.pretrained_path or latest_checkpoint(cfg.train.summaries_dir, tag)
        if ckpt and str(ckpt).endswith((".pth", ".pth.tar")):
            from avtubes_torch.core.reference_checkpoint import load_reference_checkpoint

            load_reference_checkpoint(ckpt, state.model)
            print(f"[train] warm-started from reference checkpoint {ckpt}")
        elif ckpt:
            state, start_epoch = restore_checkpoint(ckpt, state)
            start_epoch += 1
            print(f"[train] resumed from {ckpt} at epoch {start_epoch}")

    logger = MetricLogger(cfg.train.summaries_dir, run_name=tag)
    guard = PreemptionGuard()
    last_metrics: dict = {}
    watch = cfg.train.watch_every > 0
    if do_eval:
        gt_lookup = _synthetic_gt_lookup() if d.synthetic else make_gt_lookup_auto(d)
    for epoch in range(start_epoch, o.epochs):
        # the epoch's augmentation draws, made on the host
        gen = torch.Generator().manual_seed((cfg.train.seed + 1) * 1_000_003 + epoch)
        step_in_epoch = 0
        metrics: dict = {}
        batches = device_prefetch(loader.epoch(epoch), device, depth=d.prefetch)
        while not (steps_cap and step_in_epoch >= steps_cap):
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            waited_ms = (time.perf_counter() - t0) * 1e3
            clip = batch["clip"]
            draws = sample_augment_draws(clip.shape[0], gen, cfg.train.jitter_order,
                                         d.image_size, clip_size=clip.shape[2])
            metrics = hardway_fused_train_step(
                state, clip, batch["waveform"], draws, spec_cfg, o.loss_weight,
                d.image_size, watch)
            step_in_epoch += 1
            norms = {k: v for k, v in metrics.items() if "_norm/" in k}
            metrics = {k: v for k, v in metrics.items() if "_norm/" not in k}
            if step_in_epoch % cfg.train.log_every == 0 or steps_cap:
                logger.log(step=state.step, epoch=epoch, loader_wait_ms=waited_ms,
                           **{k: float(v) for k, v in metrics.items()})
            if watch and step_in_epoch % cfg.train.watch_every == 0:
                logger.log(step=state.step, epoch=epoch,
                           **{k: float(v) for k, v in norms.items()})
            if guard.preempted:
                break
        batches.close()
        if step_in_epoch:  # an epoch can yield zero batches (all skipped)
            last_metrics = {k: float(v) for k, v in metrics.items()}
        if loader.epoch_skipped:
            logger.log(step=state.step, epoch=epoch, epoch_skipped=loader.epoch_skipped)
        if guard.preempted:
            # saved under the PREVIOUS epoch: a resume re-runs the partial
            # epoch from the top (epoch - 1 may be -1: it restarts at 0)
            save_checkpoint(cfg.train.summaries_dir, tag, epoch - 1, state)
            print(f"[train] preempted during epoch {epoch}; checkpoint saved")
            break

        if do_eval:
            # per-sample decode by worker threads, in order, the last
            # partial batch kept
            eval_bsz = min(d.eval_batch_size, len(test_src))
            if isinstance(test_src, HardwayTestSource):
                test_loader = make_hardway_loader(test_src.root, test_src.ids, d, eval_bsz,
                                                  num_workers=d.n_threads)
            else:
                test_loader = BatchLoader(test_src, eval_bsz, num_workers=d.n_threads,
                                          shuffle=False, drop_last=False)
            eval_metrics = evaluate_hardway(state.model, test_loader, d, spec_cfg,
                                            gt_lookup, epoch=epoch,
                                            record=cfg.train.record_qualitative)
            last_metrics.update(eval_metrics)
            logger.log(step=state.step, epoch=epoch, **eval_metrics)

        if (epoch + 1) % cfg.train.checkpoint_every_epochs == 0:
            save_checkpoint(cfg.train.summaries_dir, tag, epoch, state)

    logger.close()
    guard.restore()
    last_metrics["skipped_samples"] = loader.skipped
    return last_metrics


def _test_videos(d) -> bool:
    """Whether the whole-video test set (`videos/<id>.mp4`) is there."""
    return any((Path(d.data_path) / "videos").glob("*.mp4"))


def _synthetic_gt_lookup():
    """Centre-box GT for synthetic smoke runs (synthetic.py's XML box)."""
    gt = np.zeros((224, 224))
    lo, hi = int(224 * 64 / 256), int(224 * 192 / 256)
    gt[lo:hi, lo:hi] = 1.0
    return lambda vid, frame=None: gt
