"""Flow-guided consistency trainer (PyTorch).

Counterpart of `avtubes/train/flow.py`.  Reference mechanics
(`flow.py:127-161`): AVENet heatmaps on consecutive frames; FlowNet2 flow
between the frame pairs; heatmap[t] warped along the flow and compared to
heatmap[t+1].  In the reference the comparison is computed but never
backpropagated — only the hard-way CE reaches backward()
(`flow.py:158-160`).

Here, as in the JAX package, the flow-consistency term is functional and
gated by `flow_loss_weight`: 0.0 reproduces the reference's effective
objective (CE only, warp metric logged); > 0 adds an L1 warp-consistency
loss on the *soft* Pos maps (binarized maps, which the reference warps,
have no gradient).  The flow net is FlowNetLite, FROZEN: it runs under
`torch.no_grad()` on the frames un-normalized to [0, 1] (the domain it was
pretrained on), none of its parameters is in the optimizer, and the cost
volume's backward kernel never runs here.  An epoch is {train, checkpoint
`flow_ep<N>`}:

  host threads decode JPEG clips + WAVs (or make synthetic ones) ->
  device prefetch ->
  one eager step per batch on the card: log-spectrogram (K1), view 1 of the
  augmentation (a random horizontal flip a clip, drawn on the host),
  FlowNetLite on the B·(T−1) consecutive frame pairs in float32 (K3's
  forward), AVENet on the B·T frames with the audio encoded once a clip
  (backbones in `--compute_dtype`, bfloat16 by default as in the JAX
  package; the head and the warp term in float32), CE + weight · warp L1,
  Adam.

`--use_pretrained` warm-starts AVENet from an original `.pth` /
`.pth.tar` (e.g. one written by `cli/export_torch.py`) or resumes from the
newest `flow_ep<N>`; the newest `flownet_ep<N>` of the pretrainer
(`train/flow_pretrain.py`) in `--summaries_dir` is loaded into the flow net
whenever there is one.  Single process, one device: the JAX package's mesh
and replication are not needed; what is not ported raises through
`train/hardway.py::check_supported`.
"""

from __future__ import annotations

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
from avtubes_torch.data.pipeline import BatchLoader
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
from avtubes_torch.data.transforms import augment_view1, denormalize_imagenet
from avtubes_torch.losses.losses import hardway_loss
from avtubes_torch.models.flownet import FlowNetLite
from avtubes_torch.ops.warp import flow_warp
from avtubes_torch.train.flow_pretrain import FLOW_TAG, create_flow_state, resize_linear
from avtubes_torch.train.hardway import (
    build_model,
    build_sources,
    check_supported,
    end_of_epoch_preempted,
    train_epoch,
    warm_start_or_resume,
)
from avtubes_torch.train.state import TrainState, create_train_state
from avtubes_torch.train.steps import _finish, _fold_time
from avtubes_torch.utils.logging import MetricLogger

TAG = "flow"


@torch.no_grad()
def frame_pair_flow(flow_net: FlowNetLite, frames: torch.Tensor) -> torch.Tensor:
    """The frozen flow net's flow between consecutive frames: ImageNet-
    normalized clips (B, T, H, W, 3) -> (B·(T−1), H, W, 2), from the frames
    un-normalized to [0, 1] (FlowNetLite is pretrained on that range, and
    far outside it on normalized input)."""
    b, t = frames.shape[:2]
    raw = denormalize_imagenet(frames)
    return flow_net(raw[:, :-1].reshape(b * (t - 1), *frames.shape[2:]),
                    raw[:, 1:].reshape(b * (t - 1), *frames.shape[2:]))


def warp_consistency(pos: torch.Tensor, flow: torch.Tensor, image_height: int) -> torch.Tensor:
    """mean |warp(pos[t], flow_t) − pos[t+1]| of (B, T, h, w) soft Pos maps
    and the (B·(T−1), H, W, 2) frame-pair flow: the flow resized to h×w as
    `jax.image.resize(..., "linear")` does it (antialiased when it shrinks)
    and its magnitudes scaled by h / H."""
    b, t, h, w = pos.shape
    flow_hw = resize_linear(flow, h, w) * (h / image_height)
    prev = pos[:, :-1].reshape(b * (t - 1), h, w, 1)
    nxt = pos[:, 1:].reshape(b * (t - 1), h, w, 1)
    return (flow_warp(prev, flow_hw) - nxt).abs().mean()


def flow_train_step(state: TrainState, flow_net: FlowNetLite | None, frames: torch.Tensor,
                    spec: torch.Tensor, flow_loss_weight: float = 0.0, watch: bool = False,
                    compute_flow: bool = True) -> dict[str, torch.Tensor]:
    """One update of AVENet from ImageNet-normalized clips (B, T, H, W, 3)
    and one spectrogram a clip (B, F, Tt, 1), on the model's device; the
    flow net frozen.  The loss is `hardway_loss + flow_loss_weight *
    warp_consistency`; one forward (`forward_shared_audio`), so one
    BatchNorm update of each tower.  `compute_flow=False` drops the flow
    net, the resize and the warp (`warp_consistency` reads 0.0).  Updates
    `state` in place; returns `{loss, hardway_loss, warp_consistency}` as
    zero-dimensional tensors, with the per-module norms if `watch`."""
    if flow_loss_weight > 0 and not compute_flow:
        raise ValueError("flow_loss_weight > 0 requires compute_flow=True")
    b, t = frames.shape[:2]
    model = state.model
    model.train()
    flow = frame_pair_flow(flow_net, frames) if compute_flow else None
    state.optimizer.zero_grad(set_to_none=True)
    out = model.forward_shared_audio(_fold_time(frames), spec)
    ce = hardway_loss(out.logits)
    if compute_flow:
        pos = out.pos.reshape(b, t, *out.pos.shape[1:])
        with torch.set_grad_enabled(flow_loss_weight > 0):   # at weight 0: the probe alone
            warp_l1 = warp_consistency(pos, flow, frames.shape[2])
    else:
        warp_l1 = torch.zeros((), device=ce.device)
    loss = ce + flow_loss_weight * warp_l1
    loss.backward()
    state.apply_gradients()
    return _finish(model, {"loss": loss, "hardway_loss": ce, "warp_consistency": warp_l1},
                   watch)


def flow_fused_train_step(state: TrainState, flow_net: FlowNetLite | None,
                          clips_uint8: torch.Tensor, waveforms: torch.Tensor,
                          flip1: torch.Tensor, spec_cfg: SpectrogramConfig,
                          flow_loss_weight: float = 0.0, watch: bool = False,
                          compute_flow: bool = True, impl: str = "kernel"
                          ) -> dict[str, torch.Tensor]:
    """The whole flow step from raw inputs on the model's device:
    host-cropped clips (B, T, S, S, 3) uint8 and prepared waveforms
    (B, num_samples).  Log-spectrogram (K1 on the card; `impl='plain'`: its
    plain version), view 1 of the two-view augmentation alone (`flip1` (B,)
    bool, the draws view 1 takes: the JAX package draws both views and uses
    the first), and `flow_train_step`."""
    spec = log_spectrogram(waveforms, spec_cfg, impl=impl)[..., None]
    return flow_train_step(state, flow_net, augment_view1(clips_uint8, flip1), spec,
                           flow_loss_weight, watch, compute_flow)


def load_flow_net(cfg: ExperimentConfig, device: torch.device,
                  flow_loss_weight: float = 0.0) -> FlowNetLite:
    """The frozen flow net: seeded from `seed + 7`, and the newest
    `flownet_ep<N>` of summaries_dir loaded into it where there is one."""
    flow_net = FlowNetLite(generator=torch.Generator().manual_seed(cfg.train.seed + 7))
    flow_ckpt = latest_checkpoint(cfg.train.summaries_dir, FLOW_TAG)
    if flow_ckpt:
        fstate, _ = restore_checkpoint(
            flow_ckpt, create_flow_state(torch.Generator().manual_seed(0), device=device))
        flow_net = fstate.model
        print(f"[flow] loaded pretrained flow net {flow_ckpt}")
    elif flow_loss_weight > 0:
        print("[flow] WARNING: flow_loss_weight > 0 with a random-init flow "
              "net; pretrain first (python -m avtubes_torch.cli.flow --train_flow)")
    return flow_net.to(device).eval().requires_grad_(False)


def run(cfg: ExperimentConfig, steps_cap: int = 0, tag: str = TAG,
        flow_loss_weight: float = 0.0, compute_flow: bool = True) -> dict:
    """Train and checkpoint on `cfg.train.device` (the card unless the CPU
    is asked for).  Returns the last step's metrics."""
    d, o = cfg.data, cfg.optim
    check_supported(cfg)
    if flow_loss_weight > 0 and not compute_flow:
        raise ValueError("flow_loss_weight > 0 requires compute_flow=True")
    device = resolve_device(cfg.train.device)
    model = build_model(cfg, torch.Generator().manual_seed(cfg.train.seed)).to(device)
    spec_cfg = SpectrogramConfig(samplerate=d.samplerate, seconds=d.audio_seconds)
    train_src, _, _ = build_sources(cfg)
    loader = BatchLoader(train_src, o.batch_size, num_workers=d.n_threads,
                         shuffle=True, seed=cfg.train.seed)
    state = create_train_state(model, o, max(1, len(loader)))
    state, start_epoch = warm_start_or_resume(cfg, tag, state, load_reference_checkpoint)
    flow_net = load_flow_net(cfg, device, flow_loss_weight)

    logger = MetricLogger(cfg.train.summaries_dir, run_name=tag)
    guard = PreemptionGuard()  # SIGTERM/SIGINT -> checkpoint + clean exit
    last: dict = {}
    watch = cfg.train.watch_every > 0  # wandb.watch parity (flow.py:124)
    for epoch in range(start_epoch, o.epochs):
        # the epoch's view-1 flips, drawn on the host
        gen = torch.Generator().manual_seed((cfg.train.seed + 4) * 1_000_003 + epoch)

        def step(batch: dict) -> dict:
            clip = batch["clip"]
            flip1 = torch.rand(clip.shape[0], generator=gen) < 0.5
            return flow_fused_train_step(state, flow_net, clip, batch["waveform"], flip1,
                                         spec_cfg, flow_loss_weight, watch, compute_flow)

        metrics = train_epoch(state, loader, epoch, device, cfg, steps_cap, logger, guard,
                              step)
        if metrics:  # an epoch can yield zero batches (all skipped)
            last = metrics
        if end_of_epoch_preempted(state, loader, epoch, cfg, tag, logger, guard):
            break
        save_checkpoint(cfg.train.summaries_dir, tag, epoch, state)
    logger.close()
    guard.restore()
    return last
