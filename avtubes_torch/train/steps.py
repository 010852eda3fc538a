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
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterable, Iterator

import torch
from torch import nn

from avtubes_torch.core.convert import flax_path
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
from avtubes_torch.data.transforms import AugmentDraws, augment_train_batch
from avtubes_torch.losses.losses import consistency_l2, hardway_loss, propagation_loss
from avtubes_torch.train.state import TrainState

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
    """Per-module L2 norms of named AVENet tensors (parameters or their
    gradients), grouped two levels deep in the JAX package's tree (e.g.
    ``grad_norm/imgnet/layer1_block0``): the keys are the JAX package's,
    through `core/convert.py::flax_path`."""
    squares: dict[str, list[torch.Tensor]] = {}
    for name, t in named:
        if t is None:
            continue
        key = "/".join((prefix, *flax_path(name)[:2]))
        squares.setdefault(key, []).append(t.detach().to(torch.float32).square().sum())
    return {k: torch.stack(v).sum().sqrt() for k, v in squares.items()}


def hardway_train_step(state: TrainState, frames: torch.Tensor, augmented: torch.Tensor,
                       spec: torch.Tensor, loss_weight: float = 0.1,
                       watch: bool = False) -> dict[str, torch.Tensor]:
    """One update from a clean view (B, T, H, W, 3), an augmented view of the
    same shape and per-clip spectrograms (B, F, Tt, 1), all on the model's
    device.  Updates `state` in place; returns the metrics as zero-dimensional
    tensors (reading one waits for the device).  `watch` adds per-module
    gradient and parameter norms."""
    b, t = frames.shape[:2]
    model = state.model
    model.train()
    old_stats = _audio_stats(model)
    state.optimizer.zero_grad(set_to_none=True)
    out, out2 = model.two_view_forward(_fold_time(frames), _fold_time(augmented), spec, t)
    hw = hardway_loss(out.logits) * loss_weight
    aug = hardway_loss(out2.logits) * loss_weight
    l2 = consistency_l2(out.weighted_map, out2.weighted_map) * (100.0 - loss_weight)
    att1 = out.weighted_map.reshape(b, t, *out.weighted_map.shape[1:])
    att2 = out2.weighted_map.reshape(b, t, *out2.weighted_map.shape[1:])
    prop = propagation_loss(att1) + propagation_loss(att2)
    combined = (hw + aug) / 2.0 + l2 + prop
    combined.backward()
    state.apply_gradients()
    _advance_audio_stats(model, old_stats)
    metrics = {"loss": combined, "hardway_loss": hw, "aug_loss": aug,
               "l2_loss": l2, "consistency_loss": prop}
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
                             impl: str = "kernel") -> dict[str, torch.Tensor]:
    """The whole training step from raw inputs on the model's device:
    host-cropped clips (B, T, S, S, 3) uint8 and prepared waveforms
    (B, num_samples) in any audio transport.  Log-spectrogram (K1 on the
    card; `impl='plain'` runs its plain version), two-view augmentation with
    `draws`, both forward passes, the 4-term loss, the Adam update."""
    spec = log_spectrogram(waveforms, spec_cfg, impl=impl)[..., None]
    v1, v2 = augment_train_batch(clips_uint8, draws, image_size)
    return hardway_train_step(state, v1, v2, spec, loss_weight, watch)


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
