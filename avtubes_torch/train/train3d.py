"""3D tube trainer (PyTorch): FullModel over 16-frame clips.

Counterpart of `avtubes/train/train3d.py`.  An epoch is {train, per-frame
whole-video test, checkpoint `tube3d_ep<N>`}:

  host threads decode JPEG clips + WAVs (or make synthetic ones) ->
  device prefetch ->
  one eager step per batch on the card: log-spectrogram (K1), view 1 of the
  augmentation (a random horizontal flip a clip, drawn on the host),
  ResNet3D-18 + audio ResNet-18 in `--compute_dtype` (bfloat16 by default,
  as in the JAX package), hard-way head over the (b·t) frames in float32,
  CE (NP-ratio logged), Adam.

The per-frame test runs every sampled frame of a video as ONE clip (K1 and
K2 once a video): on synthetic data over 4 clips of at least 4 frames at
stride 1 (so it scores something), on real data where `--gt_path` is given
and `<data_path>/videos/` exists.  `--record_qualitative N` writes the
overlays of the first N videos.  `--use_pretrained` warm-starts from an
original `.pth` / `.pth.tar` (a FullModel, or a bare Kinetics r3d-18 for
the video net) or resumes from the newest `tube3d_ep<N>`.  What is not
ported raises: see `train/hardway.py::check_supported`, and
`--conv3d_impl` other than `direct`.

`--video_arch timesformer_b16` builds FullModel with TimeSformer-B/16 as its
tube encoder (`models/timesformer.py`), `--video_arch swin3d_b` with Video
Swin-B (`models/swin3d.py`), over clips of `--frame_density` frames at
`--image_size`; no original checkpoint of either exists, so a warm start
from one raises.  The per-frame test takes such a tower's fixed clip length
in windows (`train/evaluate.py`).

Across processes (`core/distributed.py`) `--batch_size` is the GLOBAL batch
of clips, each rank holding its contiguous rows: the 3-D and 2-D BatchNorm
take the global batch's statistics (`models/norm.py`) and the head the
audio keys of the global batch's b·t frames.  The primary alone runs the
per-frame test, logs and writes checkpoints; a preemption signal is agreed
at the epoch's end.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from avtubes_torch.core.checkpoint import PreemptionGuard
from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.distributed import (
    barrier,
    check_group_matches_environment,
    is_primary,
    local_device,
    preempted_anywhere,
    rows_of,
    world_size,
)
from avtubes_torch.core.reference_checkpoint import load_fullmodel_reference_checkpoint
from avtubes_torch.data.index import load_split
from avtubes_torch.data.pipeline import PerFrameEvalSource, SyntheticSource
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.models.fullmodel import VIDEO_ARCHS, FullModel
from avtubes_torch.train.evaluate import evaluate_perframe, make_gt_lookup_auto
from avtubes_torch.train.hardway import (
    _synthetic_gt_lookup,
    build_sources,
    check_supported,
    end_of_epoch_preempted,
    rows_loader,
    save_on_primary,
    train_epoch,
    warm_start_or_resume,
)
from avtubes_torch.train.state import create_train_state
from avtubes_torch.train.steps import train3d_fused_step
from avtubes_torch.utils.logging import MetricLogger

TAG = "tube3d"


def check_supported_3d(cfg: ExperimentConfig) -> None:
    """`check_supported`; `--conv3d_impl` other than `direct`, an unknown
    `--video_arch`, and a warm start of a transformer tower
    (`timesformer_b16`, `swin3d_b`) from an original checkpoint raise."""
    check_supported(cfg)
    if cfg.train.conv3d_impl != "direct":
        raise NotImplementedError(
            f"--conv3d_impl {cfg.train.conv3d_impl!r}: the time-stacked Conv3D lowerings "
            "are in ROADMAP.md's 'Not to port'; the port runs nn.Conv3d ('direct')")
    t = cfg.train
    if t.video_arch not in VIDEO_ARCHS:
        raise ValueError(f"--video_arch must be one of {VIDEO_ARCHS}, got {t.video_arch!r}")
    if (t.video_arch != "r3d18" and t.use_pretrained
            and t.pretrained_path.endswith((".pth", ".pth.tar"))):
        raise NotImplementedError(
            f"--use_pretrained --pretrained_path {t.pretrained_path!r} with --video_arch "
            f"{t.video_arch}: no original checkpoint of a FullModel with that tube encoder "
            "exists; only the port's own tube3d_ep<N> checkpoints resume it")


def draw_view1_flips(gen: torch.Generator, batch: int) -> torch.Tensor:
    """One step's view-1 flips of `batch` clips, (batch,) bool on the host:
    Bernoulli(0.5) from `gen`."""
    return torch.rand(batch, generator=gen) < 0.5


def build_model(cfg: ExperimentConfig, generator: torch.Generator | None = None) -> FullModel:
    """FullModel of the configuration, its backbones in `--compute_dtype`
    and checkpointed in training with `--remat`."""
    check_supported_3d(cfg)
    return FullModel(hardway=cfg.hardway, generator=generator,
                     compute_dtype=cfg.train.compute_dtype, remat=cfg.train.remat,
                     video_arch=cfg.train.video_arch, image_size=cfg.data.image_size,
                     frames=cfg.data.frame_density)


def perframe_test_setup(cfg: ExperimentConfig):
    """(source, data config, GT lookup) of the per-frame test, or Nones
    where there is none to run."""
    d = cfg.data
    if d.synthetic:
        # synthetic clips are frame_density long; a stride-16 eval over a
        # 2-frame clip scores nothing (NaN): stride 1 over >= 4 frames
        pf_cfg = dataclasses.replace(d, sampling_rate=1, frame_density=max(d.frame_density, 4))
        return SyntheticSource(pf_cfg, n=4, clip=True, seed=1), pf_cfg, _synthetic_gt_lookup()
    if d.gt_path and (Path(d.data_path) / "videos").exists():
        src = PerFrameEvalSource(Path(d.data_path), load_split(d.metadata_dir, d.testset, "test"),
                                 d)
        return src, d, make_gt_lookup_auto(d, per_frame=True)
    return None, d, None


def run(cfg: ExperimentConfig, steps_cap: int = 0, tag: str = TAG,
        do_eval: bool = True) -> dict:
    """Train, evaluate and checkpoint on `cfg.train.device` (the card unless
    the CPU is asked for; across ranks the rank's own card).  Returns the
    last step's metrics with the last evaluation's (the primary's).

    Across ranks `--batch_size` is the global batch of clips, as in the JAX
    package's data mesh: each rank steps on its rows of it, with the view-1
    flips of the global batch drawn from one generator on every rank.  The
    per-frame test runs on the primary alone (the JAX trainer gives it no
    mesh) while the others wait at a barrier."""
    d, o = cfg.data, cfg.optim
    check_supported_3d(cfg)
    check_group_matches_environment()
    device = local_device(cfg.train.device)
    # the same seed on every rank: the parameters start replicated
    model = build_model(cfg, torch.Generator().manual_seed(cfg.train.seed)).to(device)
    spec_cfg = SpectrogramConfig(samplerate=d.samplerate, seconds=d.audio_seconds)
    train_src, _, _ = build_sources(cfg, shard_ids=False)
    loader = rows_loader(cfg, train_src)
    mine = rows_of(o.batch_size)
    multiproc = world_size() > 1
    steps_per_epoch = max(1, len(loader) if steps_cap == 0 else min(len(loader), steps_cap))
    state = create_train_state(model, o, steps_per_epoch)
    state, start_epoch = warm_start_or_resume(cfg, tag, state,
                                              load_fullmodel_reference_checkpoint)

    logger = MetricLogger(cfg.train.summaries_dir, run_name=tag, enabled=is_primary())
    guard = PreemptionGuard()
    last: dict = {}
    watch = cfg.train.watch_every > 0
    # epoch-invariant: the per-frame test's source and GT are built once
    pf_src, pf_cfg, gt_lookup = perframe_test_setup(cfg) if do_eval else (None, d, None)
    for epoch in range(start_epoch, o.epochs):
        # the epoch's view-1 flips, drawn on the host: the global batch's,
        # from the same generator on every rank, each rank taking its rows
        gen = torch.Generator().manual_seed((cfg.train.seed + 2) * 1_000_003 + epoch)

        def step(batch: dict) -> dict:
            flip1 = draw_view1_flips(gen, o.batch_size)[mine]
            return train3d_fused_step(state, batch["clip"], batch["waveform"], flip1,
                                      spec_cfg, watch)

        metrics = train_epoch(state, loader, epoch, device, cfg, steps_cap, logger, guard,
                              step)
        if metrics:  # an epoch can yield zero batches (all skipped)
            last = metrics
        guard.preempted = preempted_anywhere(guard.preempted, device)
        if end_of_epoch_preempted(state, loader, epoch, cfg, tag, logger, guard,
                                  epoch_complete=multiproc):
            break
        if pf_src is not None:
            if is_primary():
                pf = evaluate_perframe(state.model, pf_src, pf_cfg, spec_cfg, gt_lookup,
                                       model_kind="3d", logger=logger,
                                       record=cfg.train.record_qualitative, epoch=epoch)
                last.update(pf)
                logger.log(step=state.step, epoch=epoch, **pf)
            barrier(f"avtubes_perframe_ep{epoch}")   # the others wait it out
        if (epoch + 1) % cfg.train.checkpoint_every_epochs == 0:
            save_on_primary(cfg.train.summaries_dir, tag, epoch, state)
    logger.close()
    guard.restore()
    return last
