"""The one place that answers "which device does the port compute on?".

Counterpart of `avtubes/core/platform.py`.  Every entry point of the port
takes an explicit `device` argument whose default is ``"cuda"``; asking for
CUDA on a machine without a card raises here — nothing carries on
silently on the CPU.  The CPU is used only when the caller names it
(``device="cpu"`` / ``--device cpu``), as the tests do.
"""

from __future__ import annotations

import subprocess

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device` (default ``"cuda"``) as a `torch.device`.

    Raises RuntimeError when a CUDA device is asked for and
    `torch.cuda.is_available()` is false, or its index is out of range.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU explicitly")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    return dev


def device_report() -> str:
    """Card name and power limit, one line per card, as printed by
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
    Every time the port reports stands beside this line: a card set below
    its maximum power limit runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
