"""The two-view training augmentation, plain, sample by sample.

view 1 = the clip, flipped left-right where `flip1`;
view 2 = view 1 cropped to 0.7 of its size at (top, left) -> colour jitter
         (brightness, contrast, saturation, hue) in the sample's own order
         -> bicubic resize back (Keys' kernel, a = -0.5, half-pixel centres,
         out-of-image taps dropped and the rest renormalised) -> clamp to
         [0, 1] -> flipped where `flip2`;
both ImageNet-normalised.  Clips are (B, T, S, S, 3) uint8; the draws are
per sample (B,) (`order` is (B, 4)).

`augment_draws` is the reference's own generator of a step's draws, on the
host, with the trainer's distributions: Bernoulli(0.5) flips, crop offsets
uniform on [0, S - 0.7 S], jitter factors uniform on [0.5, 1.5], a hue
shift uniform on [-0.5, 0.5], a uniform random order of the four ops.  The
check holds the program's draws to it, draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GREY = (0.299, 0.587, 0.114)
CROP_FRACTION = 0.7
JITTER = 0.5


def augment_draws(g: torch.Generator, batch: int, size: int) -> dict:
    """One step's draws of the two-view augmentation, on the host."""
    span = size - int(size * CROP_FRACTION) + 1

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(batch, generator=g)

    flip1 = torch.rand(batch, generator=g) < 0.5
    top = torch.randint(0, span, (batch,), generator=g)
    left = torch.randint(0, span, (batch,), generator=g)
    brightness, contrast, saturation = (uniform(max(0.0, 1.0 - JITTER), 1.0 + JITTER)
                                        for _ in range(3))
    hue = uniform(-JITTER, JITTER)
    order = torch.stack([torch.randperm(4, generator=g) for _ in range(batch)])
    flip2 = torch.rand(batch, generator=g) < 0.5
    return {"flip1": flip1, "top": top, "left": left, "brightness": brightness,
            "contrast": contrast, "saturation": saturation, "hue": hue, "order": order,
            "flip2": flip2}


def normalize01(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) weights of the cubic resize along one axis."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bicubic(x: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., size, size, C)."""
    h, w = x.shape[-3], x.shape[-2]
    wh = torch.tensor(cubic_weights(h, size), device=x.device)
    ww = torch.tensor(cubic_weights(w, size), device=x.device)
    x = torch.einsum("...hwc,hy->...ywc", x, wh)
    return torch.einsum("...ywc,wx->...yxc", x, ww)


def grey(x: torch.Tensor) -> torch.Tensor:
    return (x * torch.tensor(GREY, dtype=x.dtype, device=x.device)).sum(-1, keepdim=True)


def blend(a: torch.Tensor, b, f: float) -> torch.Tensor:
    return torch.clamp(f * a + (1.0 - f) * b, 0.0, 1.0)


def hue_shift(x: torch.Tensor, shift: float) -> torch.Tensor:
    """Hue moved by `shift` (a fraction of the circle) through HSV."""
    r, g, b = x.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    span = maxc - minc
    s = torch.where(maxc > 0, span / torch.clamp_min(maxc, 1e-12), 0.0)
    safe = torch.clamp_min(span, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(span == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    h = torch.remainder(h + shift, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = maxc * (1.0 - s), maxc * (1.0 - s * f), maxc * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    v = maxc
    table = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))
    out = torch.stack(table[5], dim=-1)
    for k in range(4, -1, -1):
        out = torch.where((i == k)[..., None], torch.stack(table[k], dim=-1), out)
    return out


def jitter(x: torch.Tensor, op: int, f: float) -> torch.Tensor:
    """One jitter op on one clip (T, H, W, 3) in [0, 1]."""
    if op == 0:
        return blend(x, 0.0, f)
    if op == 1:
        return blend(x, grey(x).mean(dim=(-3, -2, -1), keepdim=True), f)
    if op == 2:
        return blend(x, grey(x), f)
    return hue_shift(x, f)


def view1(clips: torch.Tensor, flip1: torch.Tensor) -> torch.Tensor:
    """[0, 1] float32 clips flipped where `flip1`, not yet normalised."""
    x = clips.to(torch.float32) / 255.0
    return torch.stack([c.flip(-2) if bool(f) else c for c, f in zip(x, flip1.tolist())])


def two_views(clips: torch.Tensor, draws: dict, image_size: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(view 1, view 2), both normalised float32 (B, T, S, S, 3)."""
    crop = int(image_size * CROP_FRACTION)
    v1 = view1(clips, draws["flip1"])
    out = []
    for i in range(v1.shape[0]):
        top, left = int(draws["top"][i]), int(draws["left"][i])
        x = v1[i, :, top:top + crop, left:left + crop, :]
        factors = (float(draws["brightness"][i]), float(draws["contrast"][i]),
                   float(draws["saturation"][i]), float(draws["hue"][i]))
        for op in draws["order"][i].tolist():
            x = jitter(x, int(op), factors[int(op)])
        x = torch.clamp(resize_bicubic(x, image_size), 0.0, 1.0)
        out.append(x.flip(-2) if bool(draws["flip2"][i]) else x)
    return normalize01(v1), normalize01(torch.stack(out))
