"""Weight bridge: flax parameter trees -> the port's state_dicts.

Counterpart of `avtubes/core/torch_export.py` / `core/torch_import.py`, with
its own copy of the name map.  The input is a plain nested dict of numpy
arrays (the caller fetches it from the device; this module never sees a
framework other than torch).  The port's sub-modules carry the original
PyTorch model's names, so the translation is a rename:

    stem_vision / stem_audio / stem_flow -> conv1 / conv1_a / conv1_flow
    stem_bn                              -> bn1
    layer{L}_block{B}.conv{1,2}.kernel   -> layer{L}.{B}.conv{1,2}.weight
    ...bn{1,2}.{scale,bias}              -> layer{L}.{B}.bn{1,2}.{weight,bias}
    batch_stats ...bn.{mean,var}         -> ...running_{mean,var}
    downsample_conv / downsample_bn      -> downsample.{0,1}

Conv kernels transpose HWIO -> OIHW (DHWIO -> OIDHW for the 3D tube
encoder, whose one stem `stem` is `conv1`).  BatchNorm's
`num_batches_tracked` is emitted as 0, so `load_state_dict(sd, strict=True)`
passes on the port's `AVENet` / `FullModel` / `ResNet2D` / `ResNet3D`
(which own one stem each and no classifier head).

`FlowNetLite` keeps the flax names, so `flownet_from_flax` only joins the
path with dots, transposes the kernels and carries `corr_temp`.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_TORCH_NAME_BY_STEM = {"stem_vision": "conv1", "stem_audio": "conv1_a",
                       "stem_flow": "conv1_flow"}
_STEM_BY_TORCH_NAME = {v: k for k, v in _TORCH_NAME_BY_STEM.items()}


def _bn_out(params_node: Mapping, stats_node: Mapping, prefix: str,
            out: dict[str, torch.Tensor]) -> None:
    scale = np.asarray(params_node["scale"], np.float32)
    out[f"{prefix}.weight"] = torch.from_numpy(scale.copy())
    out[f"{prefix}.bias"] = torch.from_numpy(
        np.array(params_node["bias"], np.float32))
    # an un-trained tree may carry no batch_stats yet: identity stats
    out[f"{prefix}.running_mean"] = torch.from_numpy(
        np.array(stats_node.get("mean", np.zeros_like(scale)), np.float32))
    out[f"{prefix}.running_var"] = torch.from_numpy(
        np.array(stats_node.get("var", np.ones_like(scale)), np.float32))
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _backbone_from_flax(params: Mapping, stats: Mapping, prefix: str,
                        stems: Mapping[str, str]) -> dict[str, torch.Tensor]:
    """One backbone's flax tree -> state_dict entries under `prefix`; `stems`
    maps its flax stem names to the torch ones."""
    out: dict[str, torch.Tensor] = {}

    def kernel(node) -> torch.Tensor:  # HWIO -> OIHW, DHWIO -> OIDHW
        k = np.asarray(node["kernel"], np.float32)
        order = (4, 3, 0, 1, 2) if k.ndim == 5 else (3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(k.transpose(order)))

    for name, node in sorted(params.items()):
        if name == "stem_bn":
            _bn_out(node, stats.get("stem_bn", {}), f"{prefix}bn1", out)
        elif name in stems:
            out[f"{prefix}{stems[name]}.weight"] = kernel(node)
        elif "_block" in name:
            layer, block = name.split("_block")
            tp = f"{prefix}{layer}.{block}."
            block_stats = stats.get(name, {})
            for sub, val in sorted(node.items()):
                if sub in ("conv1", "conv2"):
                    out[f"{tp}{sub}.weight"] = kernel(val)
                elif sub in ("bn1", "bn2"):
                    _bn_out(val, block_stats.get(sub, {}), tp + sub, out)
                elif sub == "downsample_conv":
                    out[f"{tp}downsample.0.weight"] = kernel(val)
                elif sub == "downsample_bn":
                    _bn_out(val, block_stats.get(sub, {}), f"{tp}downsample.1", out)
                else:
                    raise ValueError(f"unknown block entry {name}.{sub}")
        else:
            raise ValueError(f"unknown backbone entry {name}")
    return out


def resnet2d_from_flax(params: Mapping, stats: Mapping, prefix: str = ""
                       ) -> dict[str, torch.Tensor]:
    """One 2D backbone's flax tree -> state_dict entries under `prefix`."""
    return _backbone_from_flax(params, stats, prefix, _TORCH_NAME_BY_STEM)


def resnet3d_from_flax(params: Mapping, stats: Mapping, prefix: str = ""
                       ) -> dict[str, torch.Tensor]:
    """The 3D tube encoder's flax tree -> state_dict entries under `prefix`."""
    return _backbone_from_flax(params, stats, prefix, {"stem": "conv1"})


_FLAX_LEAF = {"weight": "kernel"}
_FLAX_BN_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                 "running_var": "var"}


def flax_path(name: str) -> tuple[str, ...]:
    """The flax path of one of the port's AVENet or FullModel `state_dict`
    names — the inverse of the rename above: ``imgnet.layer1.0.bn2.weight``
    -> ``('imgnet', 'layer1_block0', 'bn2', 'scale')``,
    ``audnet.conv1_a.weight`` -> ``('audnet', 'stem_audio', 'kernel')``,
    ``vidnet.conv1.weight`` -> ``('vidnet', 'stem', 'kernel')``."""
    parts = name.split(".")
    net, head, leaf = parts[0], parts[1], parts[-1]
    if net == "vidnet" and head == "conv1":     # the 3D tube encoder's one stem
        return (net, "stem", _FLAX_LEAF.get(leaf, leaf))
    if head in _STEM_BY_TORCH_NAME:
        return (net, _STEM_BY_TORCH_NAME[head], _FLAX_LEAF.get(leaf, leaf))
    if head == "bn1":
        return (net, "stem_bn", _FLAX_BN_LEAF.get(leaf, leaf))
    block = f"{head}_block{parts[2]}"
    sub = parts[3]
    if sub == "downsample":
        sub = "downsample_conv" if parts[4] == "0" else "downsample_bn"
    table = _FLAX_BN_LEAF if "bn" in sub else _FLAX_LEAF
    return (net, block, sub, table.get(leaf, leaf))


def avenet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """`{'params', 'batch_stats'}` of the JAX package's AVENet, as nested
    dicts of numpy arrays -> state_dict for `avtubes_torch.models.avenet.AVENet`
    (loads with ``strict=True``)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: dict[str, torch.Tensor] = {}
    for net in ("imgnet", "audnet"):
        out.update(resnet2d_from_flax(params[net], stats.get(net, {}), f"{net}."))
    return out


def fullmodel_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """`{'params', 'batch_stats'}` of the JAX package's FullModel, as nested
    dicts of numpy arrays -> state_dict for
    `avtubes_torch.models.fullmodel.FullModel` (loads with ``strict=True``)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out = resnet3d_from_flax(params["vidnet"], stats.get("vidnet", {}), "vidnet.")
    out.update(resnet2d_from_flax(params["audnet"], stats.get("audnet", {}), "audnet."))
    return out


def flownet_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """`params` of the JAX package's FlowNetLite, as nested dicts of numpy
    arrays -> state_dict for `avtubes_torch.models.flownet.FlowNetLite`
    (loads with ``strict=True``): conv kernels HWIO -> OIHW, biases and the
    softmax temperature `corr_temp` as they are."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, val in sorted(node.items()):
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{name}.")
            elif name == "kernel":
                out[f"{prefix}weight"] = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(val, np.float32).transpose(3, 2, 0, 1)))
            elif name in ("bias", "corr_temp"):
                out[f"{prefix}{name}"] = torch.from_numpy(np.array(val, np.float32))
            else:
                raise ValueError(f"unknown FlowNetLite entry {prefix}{name}")

    walk(params, "")
    return out
