"""Qualitative visualization: heatmap/GT overlays on frames.

The port's own copy of `avtubes/utils/visual.py` (numpy, with OpenCV where
it is installed): the original `save_image` compositing,
0.4 * frame + 0.6 * (0.5 * JET(gt) + 0.5 * JET(pred)), uint8 RGB out.
OpenCV is imported inside the functions, never when the module is; without
it a pure-numpy JET map and a nearest-neighbour resize take its place.
"""

from __future__ import annotations

import numpy as np


def _jet(x: np.ndarray) -> np.ndarray:
    """Map [0,1] -> JET-style RGB uint8 (cv2.applyColorMap-compatible look)."""
    try:
        import cv2

        bgr = cv2.applyColorMap(np.uint8(np.clip(x, 0, 1) * 255), cv2.COLORMAP_JET)
        return bgr[:, :, ::-1]
    except ImportError:
        v = np.clip(x, 0, 1)
        r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
        return np.uint8(np.stack([r, g, b], -1) * 255)


def _match_size(m: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    if m.shape[:2] == hw:
        return m
    try:
        import cv2

        return cv2.resize(m.astype(np.float32), (hw[1], hw[0]),
                          interpolation=cv2.INTER_LINEAR)
    except ImportError:
        yi = (np.arange(hw[0]) * m.shape[0] / hw[0]).astype(int)
        xi = (np.arange(hw[1]) * m.shape[1] / hw[1]).astype(int)
        return m[yi][:, xi]


def overlay_heatmap(frame: np.ndarray, pred: np.ndarray,
                    gt_map: np.ndarray | None = None) -> np.ndarray:
    """frame: (H,W,3) uint8/float; pred/gt: any-resolution [0,1] maps
    (resized to the frame). Returns uint8 RGB."""
    frame = np.asarray(frame, np.float64)
    pred = _match_size(np.asarray(pred), frame.shape[:2])
    if gt_map is not None:
        gt_map = _match_size(np.asarray(gt_map), frame.shape[:2])
    if frame.max() > 1.5:
        frame = frame / 255.0
    frame = (frame - frame.min()) / max(frame.max() - frame.min(), 1e-12)
    layers = _jet(pred) * 0.5
    if gt_map is not None:
        # halve the COLORMAPPED image, not the input (a gt of 1.0 must map
        # through JET at 1.0, red, before the 50/50 blend with pred)
        layers = layers + _jet(np.clip(gt_map, 0, 1)) * 0.5
    out = frame * 255.0 * 0.4 + layers * 0.6
    return np.uint8(np.clip(out, 0, 255))
