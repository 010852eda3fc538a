"""Unsupervised optical-flow pretraining for FlowNetLite (PyTorch).

Counterpart of `avtubes/train/flow_pretrain.py`.  FlowNetLite is trained
unsupervised on frame pairs with the classic photometric + smoothness
objective:

    flow = net(im1, im2)                     # convention: warp(im1, flow) ~ im2
    photo  = charbonnier(flow_warp(im1, flow) - im2)
    smooth = |dx flow| + |dy flow|           # first-order
    loss   = photo + smooth_weight * smooth

The convention matters: `flow_warp(x, f)[p] = x[p + f(p)]` (backward warp),
so the net learns the field that pulls im1 forward onto im2.

Synthetic pairs come from a translating-pattern generator and from random
affine and two-object fields, where the true flow is known; real ones are
pairs of consecutive frames of the training clips (`_clip_pair_batches`),
B·(T−1) a batch of B clips.

The step differentiates through the correlation cost volume, so on the card
it runs the hand-written forward kernel once and the backward kernel twice
(`avtubes_torch/ops/correlation.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from avtubes_torch.core.checkpoint import (
    PreemptionGuard,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from avtubes_torch.core.config import ExperimentConfig, OptimConfig
from avtubes_torch.core.device import resolve_device
from avtubes_torch.models.flownet import FlowNetLite
from avtubes_torch.ops.warp import flow_warp
from avtubes_torch.train.state import TrainState, create_train_state
from avtubes_torch.utils.logging import MetricLogger

FLOW_TAG = "flownet"


def charbonnier(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    return torch.sqrt(x * x + eps * eps)


def smoothness_loss(flow: torch.Tensor, image: torch.Tensor | None = None,
                    edge_alpha: float = 0.0) -> torch.Tensor:
    """First-order flow smoothness: mean |spatial gradient| of (B,H,W,2).

    With `image` and edge_alpha > 0 the penalty is EDGE-AWARE (the standard
    unsupervised-flow form: weight exp(-alpha * |spatial image gradient|)):
    real flow fields are discontinuous exactly at object boundaries, which
    photometrically are image edges — a uniform penalty drags the flow of
    independently moving objects toward the static background, while the
    edge-aware form lets the field break there."""
    dy = (flow[:, 1:] - flow[:, :-1]).abs()
    dx = (flow[:, :, 1:] - flow[:, :, :-1]).abs()
    if image is not None and edge_alpha > 0.0:
        wy = torch.exp(-edge_alpha * (image[:, 1:] - image[:, :-1]).abs()
                       .mean(-1, keepdim=True))
        wx = torch.exp(-edge_alpha * (image[:, :, 1:] - image[:, :, :-1]).abs()
                       .mean(-1, keepdim=True))
        return (dx * wx).mean() + (dy * wy).mean()
    return dx.mean() + dy.mean()


def resize_linear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B,H,W,C) -> (B,height,width,C) as `jax.image.resize(..., "linear")`
    does it: half-pixel-centred bilinear, and when it shrinks an ANTIALIASED
    one (the triangle filter widened by the scale), not plain bilinear."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def multiscale_photometric(im1: torch.Tensor, im2: torch.Tensor, flow: torch.Tensor,
                           scales: tuple[int, ...] = (1, 2, 4, 8)) -> torch.Tensor:
    """Photometric charbonnier at a pyramid of scales.

    The bilinear warp's gradient w.r.t. flow only sees a +-1 px neighborhood,
    so a full-resolution-only loss cannot pull the flow toward displacements
    larger than ~1 px.  Evaluating the same loss at downsampled scales widens
    the basin: an 8 px shift is 1 px at 1/8 scale.
    """
    _, h, w, _ = im1.shape
    total = charbonnier(flow_warp(im1, flow) - im2).mean()
    for s in scales[1:]:
        im1s = resize_linear(im1, h // s, w // s)
        im2s = resize_linear(im2, h // s, w // s)
        flows = resize_linear(flow, h // s, w // s) / s
        total = total + charbonnier(flow_warp(im1s, flows) - im2s).mean()
    return total / len(scales)


def flow_pretrain_step(state: TrainState, im1: torch.Tensor, im2: torch.Tensor,
                       smooth_weight: float = 0.05, edge_alpha: float = 10.0
                       ) -> dict[str, torch.Tensor]:
    """One unsupervised step on a batch of frame pairs in [0,1], (B,H,W,3),
    on the device of the model.  Updates `state` in place and returns the
    metrics as zero-dimensional tensors (reading one waits for the device)."""
    state.optimizer.zero_grad(set_to_none=True)
    flow = state.model(im1, im2)
    photo = multiscale_photometric(im1, im2, flow)
    smooth = smoothness_loss(flow, image=im1, edge_alpha=edge_alpha)
    loss = photo + smooth_weight * smooth
    loss.backward()
    state.apply_gradients()
    return {"loss": loss.detach(), "photometric": photo.detach(),
            "smoothness": smooth.detach()}


def create_flow_state(generator: torch.Generator | None = None,
                      learning_rate: float = 1e-4, steps_per_epoch: int = 1,
                      device: str | torch.device | None = None,
                      impl: str = "kernel") -> TrainState:
    """A freshly initialised FlowNetLite on `device` (default: the card, or
    an error) with its optimizer.  The weights are drawn on the CPU from
    `generator`, so one seed gives one init on every device."""
    model = FlowNetLite(impl=impl, generator=generator).to(resolve_device(device))
    # constant lr, no decay: the hardway MultiStepLR milestones are
    # denominated in *hardway-recipe epochs* and have no meaning for this
    # short unsupervised pretraining
    cfg = dataclasses.replace(OptimConfig(), learning_rate=learning_rate,
                              weight_decay=0.0, lr_milestones=())
    return create_train_state(model, cfg, steps_per_epoch)


def smooth_pattern(rng: np.random.RandomState, size: int, cells: int = 8) -> np.ndarray:
    """Band-limited random RGB pattern in [0,1] — enough spatial gradient for
    the photometric loss to localize shifts, no aliasing under translation."""
    small = rng.rand(cells, cells, 3).astype(np.float32)
    reps = size // cells
    up = np.kron(small, np.ones((reps, reps, 1), np.float32))
    # separable box blur to kill the blocky edges
    k = max(reps // 2, 1)
    kernel = np.ones(k, np.float32) / k
    for axis in (0, 1):
        up = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), axis, up)
    return np.clip(up, 0.0, 1.0)


def translating_pairs(rng: np.random.RandomState, batch: int, size: int,
                      max_shift: int = 8) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(im1, im2, shift): im2 is im1 circularly shifted by a per-sample
    integer (dy, dx) in [-max_shift, max_shift].  Content moves by +shift, so
    the backward-warp convention implies net(im1, im2) ~ -shift."""
    im1 = np.stack([smooth_pattern(rng, size) for _ in range(batch)])
    shifts = rng.randint(-max_shift, max_shift + 1, size=(batch, 2))
    im2 = np.stack([np.roll(im1[i], (shifts[i][0], shifts[i][1]), axis=(0, 1))
                    for i in range(batch)])
    return im1, im2, shifts


def _affine_field(rng: np.random.RandomState, size: int,
                  max_angle_deg: float = 10.0, max_log_scale: float = 0.08,
                  max_shift: float = 4.0) -> np.ndarray:
    """Dense backward-warp flow (H,W,2) of a random similarity transform
    about the image center: rotation + isotropic scale + translation.

    With im2 = flow_warp(im1, g) (i.e. im2[p] = im1[p + g(p)]), the field a
    flow net trained under our convention must recover IS g — so these
    fields are usable both as training pairs and as EPE ground truth."""
    theta = np.deg2rad(rng.uniform(-max_angle_deg, max_angle_deg))
    s = np.exp(rng.uniform(-max_log_scale, max_log_scale))
    tx, ty = rng.uniform(-max_shift, max_shift, size=2)
    c, si = s * np.cos(theta), s * np.sin(theta)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = cy = (size - 1) / 2.0
    x0, y0 = xx - cx, yy - cy
    # g(p) = M (p - c) + c + t - p, with M = s R(theta)
    gx = (c * x0 - si * y0) + cx + tx - xx
    gy = (si * x0 + c * y0) + cy + ty - yy
    return np.stack([gx, gy], axis=-1).astype(np.float32)


def _two_object_field(rng: np.random.RandomState, size: int,
                      max_shift: float = 6.0) -> np.ndarray:
    """Piecewise-constant flow: two random rectangles moving independently
    over a static background (the multi-object case a constant-shift test
    cannot exercise).  Discontinuous at object borders by construction."""
    field = np.zeros((size, size, 2), np.float32)
    for _ in range(2):
        h = rng.randint(size // 4, size // 2)
        w = rng.randint(size // 4, size // 2)
        y = rng.randint(0, size - h)
        x = rng.randint(0, size - w)
        field[y:y + h, x:x + w] = rng.uniform(-max_shift, max_shift, size=2)
    return field


def warped_pairs(rng: np.random.RandomState, batch: int, size: int,
                 kind: str = "affine") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(im1, im2, gt_flow): im2 = flow_warp(im1, gt) for a random
    NON-CONSTANT field — 'affine' (rotation/scale/translation) or
    'two_object' (independently moving rectangles).  gt_flow is exactly the
    field the net must output under the backward-warp convention.  The warp
    runs on the host."""
    make = _affine_field if kind == "affine" else _two_object_field
    im1 = np.stack([smooth_pattern(rng, size) for _ in range(batch)])
    gt = np.stack([make(rng, size) for _ in range(batch)])
    im2 = flow_warp(torch.from_numpy(im1), torch.from_numpy(gt)).numpy()
    return im1, im2, gt


def epe(pred: np.ndarray, gt: np.ndarray, margin: int = 4) -> float:
    """Mean endpoint error over the interior (borders excluded: the warp
    samples out of bounds there, so no estimator can be graded on them)."""
    d = np.linalg.norm(np.asarray(pred, np.float64) - gt, axis=-1)
    return float(d[:, margin:-margin, margin:-margin].mean())


def run_pretrain(cfg: ExperimentConfig, steps_cap: int = 0,
                 tag: str = FLOW_TAG, smooth_weight: float = 0.05,
                 learning_rate: float = 1e-4, impl: str = "kernel") -> dict:
    """Unsupervised FlowNetLite pretraining loop with checkpointing, on
    `cfg.train.device`.

    Real data: consecutive-frame pairs from training clips.  Synthetic:
    translating patterns and random fields with known ground truth, logged
    as an EPE on a fixed held-out probe.
    """
    d, o = cfg.data, cfg.optim
    device = resolve_device(cfg.train.device)
    state = create_flow_state(torch.Generator().manual_seed(cfg.train.seed + 11),
                              learning_rate, device=device, impl=impl)

    start_epoch = 0
    if cfg.train.use_pretrained:
        ckpt = cfg.train.pretrained_path or latest_checkpoint(
            cfg.train.summaries_dir, tag)
        if ckpt:
            state, start_epoch = restore_checkpoint(ckpt, state)
            start_epoch += 1

    logger = MetricLogger(cfg.train.summaries_dir, run_name=tag)
    guard = PreemptionGuard()
    last: dict = {}
    # synthetic mode: a fixed held-out probe with known NON-CONSTANT ground
    # truth, so training reports a real EPE (not just the photometric loss)
    probe = {}
    if d.synthetic:
        probe = {k: warped_pairs(np.random.RandomState(1234 + i), 4, d.image_size, kind=k)
                 for i, k in enumerate(("affine", "two_object"))}
    for epoch in range(start_epoch, o.epochs):
        if d.synthetic:
            batches = _synthetic_pair_batches(cfg, epoch, steps_cap or 50)
        else:
            batches = _clip_pair_batches(cfg, epoch)
        step_in_epoch = 0
        metrics = None
        for im1, im2 in batches:
            if steps_cap and step_in_epoch >= steps_cap:
                break
            metrics = flow_pretrain_step(
                state, torch.from_numpy(im1).to(device),
                torch.from_numpy(im2).to(device), smooth_weight)
            step_in_epoch += 1
            if step_in_epoch % cfg.train.log_every == 0 or steps_cap:
                logger.log(step=state.step, epoch=epoch,
                           **{k: float(v) for k, v in metrics.items()})
            if guard.preempted:
                break
        if metrics is not None:  # an epoch can yield zero usable batches
            last = {k: float(v) for k, v in metrics.items()}
            with torch.no_grad():
                for kind, (p1, p2, gt) in probe.items():
                    pred = state.model(torch.from_numpy(p1).to(device),
                                       torch.from_numpy(p2).to(device))
                    last[f"epe_{kind}"] = epe(pred.cpu().numpy(), gt)
            if probe:
                logger.log(step=state.step, epoch=epoch,
                           **{k: v for k, v in last.items() if k.startswith("epe_")})
        if guard.preempted:
            save_checkpoint(cfg.train.summaries_dir, tag, epoch - 1, state)
            # (epoch-1 may be -1: a resume then restarts at epoch 0 —
            # max()ing to 0 would mark the partial epoch 0 as complete)
            print(f"[flow] preempted during epoch {epoch}; checkpoint saved")
            break
        save_checkpoint(cfg.train.summaries_dir, tag, epoch, state)
    logger.close()
    guard.restore()
    return last


def _synthetic_pair_batches(cfg: ExperimentConfig, epoch: int, steps: int):
    """Mixed-motion synthetic pairs: translations, random affine fields
    (rotation/scale), and two-object motion — so the pretrained net has seen
    non-constant flow, not just global shifts."""
    rng = np.random.RandomState(cfg.train.seed * 7919 + epoch)
    kinds = ("translate", "affine", "two_object")
    for step in range(steps):
        kind = kinds[step % len(kinds)]
        if kind == "translate":
            im1, im2, _ = translating_pairs(rng, cfg.optim.batch_size,
                                            cfg.data.image_size)
        else:
            im1, im2, _ = warped_pairs(rng, cfg.optim.batch_size,
                                       cfg.data.image_size, kind)
        yield im1, im2


def _clip_pair_batches(cfg: ExperimentConfig, epoch: int):
    """Consecutive-frame pairs from the training clips, in [0,1], on the
    host: (B·(T−1), H, W, 3) twice a batch of B clips of T frames."""
    from avtubes_torch.data.pipeline import BatchLoader
    from avtubes_torch.train.hardway import build_sources

    train_src, _, _ = build_sources(cfg)
    loader = BatchLoader(train_src, cfg.optim.batch_size,
                         num_workers=cfg.data.n_threads, shuffle=True,
                         seed=cfg.train.seed)
    for batch in loader.epoch(epoch):
        clip = batch["clip"].astype(np.float32) / 255.0  # (B,T,H,W,3)
        if clip.shape[1] < 2:
            continue
        b, t = clip.shape[:2]
        im1 = clip[:, :-1].reshape(b * (t - 1), *clip.shape[2:])
        im2 = clip[:, 1:].reshape(b * (t - 1), *clip.shape[2:])
        yield im1, im2
