"""Checkpoints of the original PyTorch implementation (`.pth` / `.pth.tar`).

Counterpart of `avtubes/core/torch_import.py::load_torch_state_dict` /
`avenet_from_torch` and `core/torch_export.py::avenet_to_torch` /
`save_torch_checkpoint`.  The port's AVENet carries the original module
names (`core/convert.py`), so crossing is a filter, not a rename:

  * reading (`--use_pretrained` warm start): the envelope's
    `model_state_dict` (or a bare state_dict), a leading DataParallel
    `module.` stripped, minus the tensors the port's AVENet does not own —
    the stems of the other modalities and the dead `fc` classifier head —
    loaded strictly;
  * writing: `{'epoch', 'model_state_dict', 'optimizer_state_dict': {}}`,
    with those dead tensors synthesized as zeros (inert: no localization
    forward uses them) so the original `AVENet.load_state_dict` passes with
    strict checking.

Loading uses ``weights_only=True``: tensors and plain containers only.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from avtubes_torch.models.resnet2d import STEM_CHANNELS, STEM_NAMES

#: width of layer4 and so of the dead classifier head's input
_FC_IN = 512
_FC_CLASSES = 1000


def load_reference_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a reference checkpoint, `module.` stripped."""
    obj = torch.load(Path(path), map_location="cpu", weights_only=True)
    sd = obj.get("model_state_dict", obj) if isinstance(obj, dict) else obj
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _dead(name: str, model: nn.Module) -> bool:
    """A tensor of the original model that the port's does not own."""
    net, head = name.split(".")[:2]
    if head in ("fc", "avgpool"):
        return True
    backbone = getattr(model, net, None)
    return head in STEM_NAMES.values() and backbone is not None and \
        head != STEM_NAMES[backbone.modal]


def load_reference_checkpoint(path: str | Path, model: nn.Module) -> nn.Module:
    """Load a reference AVENet checkpoint into the port's AVENet (in place,
    strict about every tensor it owns)."""
    sd = load_reference_state_dict(path)
    kept = {k: v for k, v in sd.items() if not _dead(k, model)}
    model.load_state_dict(kept, strict=True)
    return model


def reference_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The port's AVENet as the original model's state_dict: its own tensors
    on the CPU plus zeros for the other modalities' stems and the fc head."""
    out = {k: v.detach().to("cpu") for k, v in model.state_dict().items()}
    for net in ("imgnet", "audnet"):
        for modal, stem in STEM_NAMES.items():
            out.setdefault(f"{net}.{stem}.weight",
                           torch.zeros(64, STEM_CHANNELS[modal], 7, 7))
        out.setdefault(f"{net}.fc.weight", torch.zeros(_FC_CLASSES, _FC_IN))
        out.setdefault(f"{net}.fc.bias", torch.zeros(_FC_CLASSES))
    return out


def save_reference_checkpoint(path: str | Path, model: nn.Module, epoch: int = 0) -> Path:
    """Write `.pth.tar` in the original checkpoint envelope; the optimizer
    entry is empty (an optimizer restarts from it as from scratch)."""
    path = Path(path)
    torch.save({"epoch": int(epoch), "model_state_dict": reference_state_dict(model),
                "optimizer_state_dict": {}}, path)
    return path
