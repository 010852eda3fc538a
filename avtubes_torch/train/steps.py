"""Training and evaluation steps of the flagship trainer (PyTorch).

Counterpart of `avtubes/train/steps.py`.  `hardway_train_step` is the
4-term objective of the original 16-frame trainer:

    hardway  = CE(logits_clean, 0)       * loss_weight
    aug      = CE(logits_augmented, 0)   * loss_weight
    l2       = MSE(weighted_clean, weighted_aug) * (100 - loss_weight)
    prop     = PropagationLoss(weighted_clean as (B,T,14,14))
             + PropagationLoss(weighted_aug  as (B,T,14,14))
    combined = (hardway + aug)/2 + l2 + prop

on clips whose time axis is folded into the batch, with each clip's
spectrogram encoded once.  The image BatchNorm running statistics are
updated by the clean pass and then by the augmented pass; the audio tower
gets its second update in closed form (`_advance_audio_stats`).

Steps run eagerly and update the state in place: the parameters, Adam's
moments and the BatchNorm statistics, which live in the module.
`hardway_fused_train_step` is the whole step from raw inputs: the
log-spectrogram (`data/spectrogram.py::log_spectrogram`, which launches the
hand-written K1 kernel for a waveform on the card), the two-view
augmentation with its draws injected, and the step.

The 1-frame trainer's `hardway_1frame_train_step` and the 3D tube trainer's
`train3d_step` are the plain hard-way CE over ONE forward, so every
BatchNorm (the audio tower's too) takes that forward's update once and
nothing more; `train3d_step` also logs the NP-ratio of the (B, T) heatmaps,
outside autograd.  Their fused forms start from raw inputs like the
flagship's, with their random draws injected.

Each step is one span tree (`utils/debug.py::span`, recorded only while a
`torch.profiler` session runs): the root `train.step`, opened by the
outermost step function and given `TrainState.step`, and its parts
`train.input` (the log-spectrogram and the augmentation, fused steps
only), `train.forward` (the forward passes and losses), `train.backward`
and `train.optimizer` (the rank average, Adam, the audio statistics'
advance and the metrics).

Under a process group every step here holds the rank's rows of the batch:
the BatchNorm statistics and the negative pool span the ranks, and the
gradients and metrics are averaged over them in one all-reduce after the
backward.  Each loss is a mean over the rank's rows and the ranks' row
counts are equal, so the mean of the rank means is the global batch's mean
and the averaged gradient is that of the global batch's mean loss.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterable, Iterator

import torch
from torch import nn

from avtubes_torch.core.convert import flax_path
from avtubes_torch.core.distributed import all_reduce_mean_
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
from avtubes_torch.data.transforms import (
    AugmentDraws,
    augment_train_batch,
    augment_view1,
    normalize_imagenet,
    random_hflip,
)
from avtubes_torch.losses.losses import (
    consistency_l2,
    hardway_loss,
    np_ratio_loss,
    propagation_loss,
)
from avtubes_torch.train.state import TrainState
from avtubes_torch.utils.debug import span

#: EMA momentum of the BatchNorm running statistics in the flax convention
#: (torch's `momentum=0.1`)
BN_MOMENTUM = 0.9


def _fold_time(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B*T, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _audio_bn(model: nn.Module) -> list[nn.BatchNorm2d]:
    return [m for m in model.audnet.modules() if isinstance(m, nn.BatchNorm2d)]


def _audio_stats(model: nn.Module) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """A copy of the audio tower's running statistics, before a forward."""
    return [(bn.running_mean.clone(), bn.running_var.clone()) for bn in _audio_bn(model)]


@torch.no_grad()
def _advance_audio_stats(model: nn.Module, old_stats: list[tuple[torch.Tensor, torch.Tensor]],
                         momentum: float = BN_MOMENTUM) -> None:
    """Advance the audio tower's BatchNorm running statistics one extra EMA
    step, in place.

    The original trainer forwards the model once per view on the SAME audio
    batch, so its audio BatchNorm statistics advance TWO EMA steps a
    training step; `two_view_forward` encodes the shared audio once (one
    step).  With the same batch statistic x in both updates

        new  = m*old + (1-m)*x
        next = m*new + (1-m)*x = (1+m)*new - m*old

    exact for whatever statistic the layer stored (biased or unbiased
    variance alike).  `num_batches_tracked` counts the second batch too.
    """
    for bn, (old_mean, old_var) in zip(_audio_bn(model), old_stats):
        bn.running_mean.mul_(1.0 + momentum).sub_(old_mean, alpha=momentum)
        bn.running_var.mul_(1.0 + momentum).sub_(old_var, alpha=momentum)
        bn.num_batches_tracked.add_(1)


def pytree_group_norms(named: Iterable[tuple[str, torch.Tensor]],
                       prefix: str) -> dict[str, torch.Tensor]:
    """Per-module L2 norms of named AVENet or FullModel tensors (parameters
    or their gradients), grouped two levels deep in the JAX package's tree (e.g.
    ``grad_norm/imgnet/layer1_block0``): the keys are the JAX package's,
    through `core/convert.py::flax_path`."""
    squares: dict[str, list[torch.Tensor]] = {}
    for name, t in named:
        if t is None:
            continue
        key = "/".join((prefix, *flax_path(name)[:2]))
        squares.setdefault(key, []).append(t.detach().to(torch.float32).square().sum())
    return {k: torch.stack(v).sum().sqrt() for k, v in squares.items()}


def _average_over_ranks(model: nn.Module, metrics: dict[str, torch.Tensor]) -> None:
    """The gradients and the metrics, in place, as their means over the
    ranks, in ONE all-reduce (nothing without a process group)."""
    all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None]
                     + list(metrics.values()))

def hardway_train_step(state: TrainState, frames: torch.Tensor, augmented: torch.Tensor,
                       spec: torch.Tensor, loss_weight: float = 0.1,
                       watch: bool = False, negative_pool: str = "global"
                       ) -> dict[str, torch.Tensor]:
    """One update from a clean view (B, T, H, W, 3), an augmented view of the
    same shape and per-clip spectrograms (B, F, Tt, 1), all on the model's
    device.  Updates `state` in place; returns the metrics as zero-dimensional
    tensors (reading one waits for the device).  `watch` adds per-module
    gradient and parameter norms.

    Under a process group the batch is this rank's slice of the global
    batch: the BatchNorm statistics and the `negative_pool` head span the
    ranks, and the gradients and the metrics are averaged over them in one
    all-reduce after the backward (the gradient of the global batch's mean
    loss), so every rank takes the same update."""
    b, t = frames.shape[:2]
    model = state.model
    with span("train.step", state.step):
        with span("train.forward"):
            model.train()
            old_stats = _audio_stats(model)
            state.optimizer.zero_grad(set_to_none=True)
            out, out2 = model.two_view_forward(_fold_time(frames), _fold_time(augmented), spec,
                                               t, negative_pool)
            hw = hardway_loss(out.logits) * loss_weight
            aug = hardway_loss(out2.logits) * loss_weight
            l2 = consistency_l2(out.weighted_map, out2.weighted_map) * (100.0 - loss_weight)
            att1 = out.weighted_map.reshape(b, t, *out.weighted_map.shape[1:])
            att2 = out2.weighted_map.reshape(b, t, *out2.weighted_map.shape[1:])
            prop = propagation_loss(att1) + propagation_loss(att2)
            combined = (hw + aug) / 2.0 + l2 + prop
        with span("train.backward"):
            combined.backward()
        with span("train.optimizer"):
            metrics = {k: v.detach().clone() for k, v in (
                ("loss", combined), ("hardway_loss", hw), ("aug_loss", aug), ("l2_loss", l2),
                ("consistency_loss", prop))}
            _average_over_ranks(model, metrics)
            state.apply_gradients()
            _advance_audio_stats(model, old_stats)
            return _finish(model, metrics, watch)


def _finish(model: nn.Module, metrics: dict[str, torch.Tensor],
            watch: bool) -> dict[str, torch.Tensor]:
    """The step's metrics, detached, with the per-module norms if `watch`."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if watch:
        metrics.update(pytree_group_norms(
            ((n, p.grad) for n, p in model.named_parameters()), "grad_norm"))
        metrics.update(pytree_group_norms(model.named_parameters(), "param_norm"))
    return metrics


def hardway_fused_train_step(state: TrainState, clips_uint8: torch.Tensor,
                             waveforms: torch.Tensor, draws: AugmentDraws,
                             spec_cfg: SpectrogramConfig, loss_weight: float = 0.1,
                             image_size: int = 224, watch: bool = False,
                             impl: str = "kernel", negative_pool: str = "global"
                             ) -> dict[str, torch.Tensor]:
    """The whole training step from raw inputs on the model's device:
    host-cropped clips (B, T, S, S, 3) uint8 and prepared waveforms
    (B, num_samples) in any audio transport.  Log-spectrogram (K1 on the
    card; `impl='plain'` runs its plain version), two-view augmentation with
    `draws` (this rank's rows of the global batch's draws), both forward
    passes, the 4-term loss, the Adam update (`hardway_train_step`)."""
    with span("train.step", state.step):
        with span("train.input"):
            spec = log_spectrogram(waveforms, spec_cfg, impl=impl)[..., None]
            v1, v2 = augment_train_batch(clips_uint8, draws, image_size)
        return hardway_train_step(state, v1, v2, spec, loss_weight, watch, negative_pool)


def hardway_1frame_train_step(state: TrainState, frames: torch.Tensor, spec: torch.Tensor,
                              watch: bool = False) -> dict[str, torch.Tensor]:
    """One update of AVENet from single frames (B, H, W, 3) and their
    spectrograms (B, F, Tt, 1): the plain hard-way CE over one forward.
    Each BatchNorm, the audio tower's included, takes that forward's update
    once (no `_advance_audio_stats`).  Under a process group the batch is
    the rank's rows of the global batch: each frame is contrasted with the
    audio of the global batch, and the gradients and the loss (a mean over
    equal-sized rank slices) are averaged over the ranks."""
    model = state.model
    with span("train.step", state.step):
        with span("train.forward"):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            loss = hardway_loss(model(frames, spec, negative_pool="global").logits)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            metrics = {"loss": loss.detach().clone()}
            _average_over_ranks(model, metrics)
            state.apply_gradients()
            return _finish(model, metrics, watch)



def hardway_1frame_fused_step(state: TrainState, frames_uint8: torch.Tensor,
                              waveforms: torch.Tensor, flips: torch.Tensor,
                              spec_cfg: SpectrogramConfig, watch: bool = False,
                              impl: str = "kernel") -> dict[str, torch.Tensor]:
    """The 1-frame step from raw inputs on the model's device: middle frames
    (B, S, S, 3) uint8 and prepared waveforms (B, num_samples).
    Log-spectrogram (K1 on the card; `impl='plain'` runs its plain version),
    ImageNet normalization, a horizontal flip of each frame whose `flips`
    (B,) bool draw is true, and `hardway_1frame_train_step`."""
    with span("train.step", state.step):
        with span("train.input"):
            spec = log_spectrogram(waveforms, spec_cfg, impl=impl)[..., None]
            frames = random_hflip(normalize_imagenet(frames_uint8), flips)
        return hardway_1frame_train_step(state, frames, spec, watch)


def train3d_step(state: TrainState, video: torch.Tensor, spec: torch.Tensor,
                 watch: bool = False) -> dict[str, torch.Tensor]:
    """One update of FullModel from clips (B, T, H, W, 3) and one spectrogram
    a clip (B, F, Tt, 1): the hard-way CE over the (b·t) frames, the audio
    encoded once a clip (`forward_shared_audio`); one BatchNorm update of
    each tower.  The NP-ratio of the (B, T, h, w) heatmaps is logged, not
    backpropagated.  Under a process group the clips are the rank's rows:
    the 3-D and 2-D BatchNorm statistics are the global batch's, every
    frame is contrasted with the audio keys of the global batch's b·t
    frames, and the gradients, the CE and the NP-ratio (both means over
    equal-sized rank slices) are averaged over the ranks."""
    b, t = video.shape[:2]
    model = state.model
    with span("train.step", state.step):
        with span("train.forward"):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            out = model.forward_shared_audio(spec, video, negative_pool="global")
            loss = hardway_loss(out.logits)
            with torch.no_grad():
                np_ratio = np_ratio_loss(out.heatmap.reshape(b, t, *out.heatmap.shape[1:]))
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            metrics = {"loss": loss.detach().clone(), "np_ratio": np_ratio}
            _average_over_ranks(model, metrics)
            state.apply_gradients()
            return _finish(model, metrics, watch)


def train3d_fused_step(state: TrainState, clips_uint8: torch.Tensor,
                       waveforms: torch.Tensor, flip1: torch.Tensor,
                       spec_cfg: SpectrogramConfig, watch: bool = False,
                       impl: str = "kernel") -> dict[str, torch.Tensor]:
    """The 3D tube step from raw inputs on the model's device: host-cropped
    clips (B, T, S, S, 3) uint8 and prepared waveforms (B, num_samples).
    Log-spectrogram (K1 on the card; `impl='plain'`: its plain version),
    view 1 of the two-view augmentation alone (`flip1` (B,) bool, the draws
    view 1 takes), and `train3d_step`."""
    with span("train.step", state.step):
        with span("train.input"):
            spec = log_spectrogram(waveforms, spec_cfg, impl=impl)[..., None]
            video = augment_view1(clips_uint8, flip1)
        return train3d_step(state, video, spec, watch)


@contextlib.contextmanager
def eval_mode(model: nn.Module) -> Iterator[nn.Module]:
    """The model in eval mode (BatchNorm from its running statistics, none
    updated) and without autograd, its earlier mode restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield model
    finally:
        model.train(was_training)


def eval_heatmap_step(model: nn.Module, frames: torch.Tensor,
                      spec: torch.Tensor) -> torch.Tensor:
    """Inference: (B,H,W,3) + (B,F,T,1) -> raw (B,14,14) heatmaps."""
    with eval_mode(model):
        return model(frames, spec).heatmap


def eval_heatmap_shared_step(model: nn.Module, frames: torch.Tensor,
                             spec: torch.Tensor) -> torch.Tensor:
    """Per-frame inference with shared clip audio: (B*K,H,W,3) + (B,F,T,1)
    -> (B*K,14,14) heatmaps, the audio encoded once per clip."""
    with eval_mode(model):
        return model.forward_shared_audio(frames, spec).heatmap


def eval3d_heatmap_step(model: nn.Module, video: torch.Tensor,
                        spec: torch.Tensor) -> torch.Tensor:
    """3D inference: (B, T, H, W, 3) + (B, F, Tt, 1) -> (B, T, h, w) heatmaps."""
    b, t = video.shape[:2]
    with eval_mode(model):
        heat = model.forward_shared_audio(spec, video).heatmap
    return heat.reshape(b, t, *heat.shape[1:])
