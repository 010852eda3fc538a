"""Image transforms of the serving path (PyTorch + host).

Counterpart of `avtubes/data/transforms.py`, the part the localizer needs:

  * HOST (per request, variable shapes): decode, aspect-preserving
    shortest-side bicubic resize (PIL), centre crop.  Output: fixed-shape
    uint8 (size, size, 3).  PIL is imported inside the functions that use it.
  * DEVICE (batched, fixed shapes): ImageNet normalization.

The training augmentation (flip, crop, colour jitter, bicubic resize) waits
for the trainer.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------- host side

def shortest_side_dims(h: int, w: int, target: int) -> tuple[int, int]:
    """(rh, rw) of a shortest-side resize to `target` (round half to even)."""
    if w < h:
        return max(1, round(h * target / w)), target
    return target, max(1, round(w * target / h))


def host_resize_shortest(img, size: int):
    """PIL aspect-preserving bicubic resize of the shortest side."""
    from PIL import Image

    w, h = img.size
    rh, rw = shortest_side_dims(h, w, size)
    return img.resize((rw, rh), Image.BICUBIC)


def host_center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return arr[top : top + size, left : left + size]


def eval_frame_from_bytes(data: bytes, image_size: int = 224) -> np.ndarray:
    """An in-memory encoded image (serving requests arrive as bytes, not
    files): decode -> shortest-side bicubic resize -> centre crop.
    uint8 (size, size, 3)."""
    from io import BytesIO

    from PIL import Image

    img = Image.open(BytesIO(data)).convert("RGB")
    img = host_resize_shortest(img, image_size)
    return host_center_crop(np.asarray(img), image_size)


# -------------------------------------------------------------- device side

def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """uint8/float [0,255] (..., H, W, 3) -> ImageNet-normalized float32."""
    x = x.to(torch.float32) / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std
