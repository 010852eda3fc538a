"""Small numeric helpers (reference `utils.py:194-201`).

The port's own numpy copy of `avtubes/utils/misc.py`."""

from __future__ import annotations

import numpy as np


def gkern(kernlen: int = 21, std: float | None = None) -> np.ndarray:
    """2D Gaussian kernel (outer product of a 1D Gaussian window)."""
    if std is None:
        std = kernlen / 6.0
    n = np.arange(kernlen) - (kernlen - 1) / 2.0
    g1 = np.exp(-0.5 * (n / std) ** 2)
    return np.outer(g1, g1)


def rescale_loss(value, vmin, vmax, new_min=0.0, new_max=1.0):
    """Linear rescale from [vmin, vmax] to [new_min, new_max]."""
    return ((value - vmin) / (vmax - vmin)) * (new_max - new_min) + new_min
