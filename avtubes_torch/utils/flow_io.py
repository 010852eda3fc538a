"""Optical-flow I/O and visualization (Middlebury .flo, color-wheel render).

The port's own numpy copy of `avtubes/utils/flow_io.py`, the reference's
flow helpers (`utils.py:13-192`): read/write .flo files and render a flow
field to the Middlebury color-wheel RGB image used by `flow.py:157` for
qualitative dumps.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_TAG = 202021.25  # Middlebury sanity magic


def read_flo(path: str | Path) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32 (u, v)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _TAG:
            raise ValueError(f"{path}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str | Path, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow to a Middlebury .flo file."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"expected a (H, W, 2) flow, got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([_TAG], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.tofile(f)


def make_color_wheel() -> np.ndarray:
    """Middlebury color wheel: (55, 3) RGB rows over hue transitions."""
    transitions = [(15, 0, 1, False), (6, 1, 0, True), (4, 1, 2, False),
                   (11, 2, 1, True), (13, 2, 0, False), (6, 0, 2, True)]
    rows = []
    for count, base, ramp, down in transitions:
        seg = np.zeros((count, 3))
        seg[:, base] = 255
        vals = np.floor(255 * np.arange(count) / count)
        seg[:, ramp] = 255 - vals if down else vals
        rows.append(seg)
    return np.concatenate(rows, axis=0)


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """Render (H, W, 2) flow to an RGB uint8 color-wheel image."""
    u = flow[..., 0].astype(np.float64).copy()
    v = flow[..., 1].astype(np.float64).copy()
    bad = (np.abs(u) > 1e7) | (np.abs(v) > 1e7) | np.isnan(u) | np.isnan(v)
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(rad.max(), 1e-12)
    u, v = u / maxrad, v / maxrad
    rad = rad / maxrad

    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    angle = np.arctan2(-v, -u) / np.pi           # [-1, 1]
    fk = (angle + 1) / 2 * (ncols - 1)           # [0, ncols-1]
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    frac = (fk - k0)[..., None]
    col = (1 - frac) * wheel[k0] / 255.0 + frac * wheel[k1] / 255.0
    # saturate toward white inside the unit circle, darken outside
    inside = rad[..., None] <= 1
    col = np.where(inside, 1 - rad[..., None] * (1 - col), col * 0.75)
    col[bad] = 0
    return np.uint8(np.floor(col * 255))
