"""Checkpoints of the original PyTorch implementation (`.pth` / `.pth.tar`).

Counterpart of `avtubes/core/torch_import.py::load_torch_state_dict` /
`avenet_from_torch` / `fullmodel_from_torch` and
`core/torch_export.py::avenet_to_torch` / `fullmodel_to_torch` /
`save_torch_checkpoint`.  The
port's AVENet and FullModel carry the original module names
(`core/convert.py`), so crossing is a filter, not a rename:

  * reading (`--use_pretrained` warm start): the envelope's
    `model_state_dict` (or a bare state_dict), a leading DataParallel
    `module.` stripped, minus the tensors the port's AVENet does not own —
    the stems of the other modalities and the dead `fc` classifier head —
    loaded strictly;
  * writing (`cli/export_torch.py`): `{'epoch', 'model_state_dict',
    'optimizer_state_dict': {}}`, with those dead tensors synthesized as
    zeros (inert: no localization forward uses them) so the original
    `AVENet` or `FullModel`'s `load_state_dict` passes with strict checking.

A FullModel warm start (`load_fullmodel_reference_checkpoint`) takes either
a `vidnet.`/`audnet.`-prefixed FullModel state_dict, which loads both towers,
or a bare r3d-18 state_dict (the Kinetics-pretrained video net), which loads
the tube encoder only; the dead `fc` heads are dropped.

Loading uses ``weights_only=True``: tensors and plain containers only.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from avtubes_torch.models.resnet2d import STEM_CHANNELS, STEM_NAMES

#: width of layer4 and so of the dead classifier heads' input
_FC_IN = 512
#: classes of each backbone's dead fc head: ImageNet's, and the original
#: FullModel's r3d-18 built with n_classes=1039 (`model.py:20`)
_FC_CLASSES = {"imgnet": 1000, "audnet": 1000, "vidnet": 1039}


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
    modal = getattr(getattr(model, net, None), "modal", None)   # None: the 3D net
    return head in STEM_NAMES.values() and modal is not None and head != STEM_NAMES[modal]


def load_reference_checkpoint(path: str | Path, model: nn.Module) -> nn.Module:
    """Load a reference AVENet checkpoint into the port's AVENet (in place,
    strict about every tensor it owns)."""
    sd = load_reference_state_dict(path)
    kept = {k: v for k, v in sd.items() if not _dead(k, model)}
    model.load_state_dict(kept, strict=True)
    return model


def load_fullmodel_reference_checkpoint(path: str | Path, model: nn.Module) -> tuple[str, ...]:
    """Load a reference FullModel checkpoint (both towers) or a bare r3d-18
    one (the tube encoder only) into the port's FullModel, in place and
    strict about every tensor loaded.  Returns the towers it loaded."""
    sd = load_reference_state_dict(path)
    if any(k.startswith("vidnet.") for k in sd):
        model.load_state_dict({k: v for k, v in sd.items() if not _dead(k, model)},
                              strict=True)
        return ("vidnet", "audnet")
    model.vidnet.load_state_dict(
        {k: v for k, v in sd.items() if k.split(".")[0] not in ("fc", "avgpool")},
        strict=True)
    return ("vidnet",)


def reference_state_dict(model: nn.Module, strict: bool = True) -> dict[str, torch.Tensor]:
    """The port's AVENet or FullModel as the original model's state_dict:
    its own tensors on the CPU and, where `strict`, zeros for the tensors the
    original owns and no localization forward uses (each 2D backbone's
    stems of the other modalities, every backbone's fc head), so that the
    original module loads it with strict checking."""
    out = {k: v.detach().to("cpu") for k, v in model.state_dict().items()}
    if not strict:
        return out
    for net, classes in _FC_CLASSES.items():
        backbone = getattr(model, net, None)
        if backbone is None:
            continue
        if getattr(backbone, "modal", None) is not None:      # the 2D nets
            for modal, stem in STEM_NAMES.items():
                out.setdefault(f"{net}.{stem}.weight",
                               torch.zeros(64, STEM_CHANNELS[modal], 7, 7))
        out.setdefault(f"{net}.fc.weight", torch.zeros(classes, _FC_IN))
        out.setdefault(f"{net}.fc.bias", torch.zeros(classes))
    return out


def save_reference_checkpoint(path: str | Path, model: nn.Module, epoch: int = 0) -> Path:
    """Write `.pth.tar` in the original checkpoint envelope; the optimizer
    entry is empty (an optimizer restarts from it as from scratch)."""
    return save_reference_state_dict(path, reference_state_dict(model), epoch)


def save_reference_state_dict(path: str | Path, state_dict: dict[str, torch.Tensor],
                              epoch: int = 0) -> Path:
    """`state_dict` in the original checkpoint envelope, written to `path`."""
    path = Path(path)
    torch.save({"epoch": int(epoch), "model_state_dict": state_dict,
                "optimizer_state_dict": {}}, path)
    return path
