"""Image and clip transforms (PyTorch + host).

Counterpart of `avtubes/data/transforms.py`:

  * HOST (per sample, variable shapes): decode, aspect-preserving
    shortest-side bicubic resize, the centre crop of evaluation and the one
    random crop shared by every frame of a training clip.  Output:
    fixed-shape uint8.  JPEGs go through the port's native core
    (`avtubes_torch.native`: libjpeg + a PIL-compatible bicubic resize in
    C++, off the GIL) where it is available, exactly where the JAX package
    uses its own: training clips with libjpeg's DCT-domain scaling (about
    two levels from PIL), evaluation frames at full resolution (within one
    level of PIL), served frames scaled only under `fast=True`.  PIL, imported
    inside the functions that use it, decodes everything else and is the
    fallback.
  * DEVICE (batched, fixed shapes): ImageNet normalization and the training
    augmentation — view 1 = a random horizontal flip of the host-cropped
    clip; view 2 = RandomCrop(0.7 size) -> ColorJitter(.5, .5, .5, .5) in a
    random per-sample order -> bicubic resize back to size -> random flip,
    built from view 1.

The JAX package draws the augmentation from a threefry key inside the
program.  Threefry and torch's Philox give different numbers, so here the
draws are an explicit argument (`AugmentDraws`), made by
`sample_augment_draws` from a `torch.Generator` with the JAX package's
distributions — or, in the tests, from the JAX key itself.  A batch's draws
are made on the host and reach the card in ONE pinned, non-blocking copy
(`to_device_in_one_copy`), with the sample groups of the colour jitter; every
decision that reads a draw (which jitter op a sample takes where) reads the
host copy, so the augmentation never waits for the card's queue to drain.
The constants (ImageNet statistics, grey weights, bicubic weight matrices)
are made once per device.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Sequence

import numpy as np
import torch

from avtubes_torch import native
from avtubes_torch.native import shortest_side_dims

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

#: the second view's crop, as a fraction of the image size
CROP_FRACTION = 0.7
#: colour jitter strength of each op (brightness, contrast, saturation, hue)
JITTER = (0.5, 0.5, 0.5, 0.5)
#: the order of the four jitter ops under `jitter_order='fixed'`
FIXED_ORDER = (0, 1, 2, 3)


# ---------------------------------------------------------------- host side

def open_rgb(path):
    """Open an image as an RGB PIL.Image, through the native libjpeg decoder
    where it is available (no PIL decode), else PIL."""
    from PIL import Image

    if str(path).lower().endswith((".jpg", ".jpeg")) and native.available():
        arr = native.decode_jpeg(path)
        if arr is not None:
            return Image.fromarray(arr)
    return Image.open(path).convert("RGB")


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


def host_random_crop_params(rng: np.random.RandomState, h: int, w: int, size: int):
    top = rng.randint(0, max(1, h - size + 1))
    left = rng.randint(0, max(1, w - size + 1))
    return top, left


def _is_jpeg(path) -> bool:
    return str(path).lower().endswith((".jpg", ".jpeg"))


def host_load_train_clip(paths, rng: np.random.RandomState, image_size: int = 224,
                         resize_factor: float = 1.1, threads: int = 1) -> np.ndarray:
    """Decode clip frames -> shortest-side resize (1.1x) -> one random crop
    shared by all frames, drawn from frame 0's resized geometry.  Returns
    uint8 (T, size, size, 3); the same `rng` gives the JAX package's clip.

    With the native core, a clip of JPEGs is one fused C++ call
    (`decode_clip_train`, `threads` decoders); a frame it declines falls
    back to the per-frame native decode, then to PIL.  The crop is drawn
    once, before the fused call, so the rng stream does not depend on which
    path succeeded."""
    target = int(image_size * resize_factor)
    use_native = native.available()
    crop = None
    if use_native and len(paths) > 1 and all(_is_jpeg(p) for p in paths):
        size0 = native.jpeg_size(paths[0])
        if size0 is not None:
            rh, rw = native.shortest_side_dims(*size0, target)
            crop = host_random_crop_params(rng, rh, rw, image_size)
            clip = native.decode_clip_train(paths, target, image_size, crop[0], crop[1],
                                            threads=threads, scaled=True)
            if clip is not None:
                return clip
    frames = []
    for p in paths:
        arr = None
        if use_native and _is_jpeg(p):
            # no crop here: the crop below is shared by the whole clip.
            # scaled=True: DCT-domain scaling, ~2 levels from PIL, far below
            # the crop and jitter augmentation's noise
            arr = native.decode_jpeg_shortest(p, target, scaled=True)
        if arr is None:
            arr = np.asarray(host_resize_shortest(open_rgb(p), target))
        if crop is None:
            crop = host_random_crop_params(rng, arr.shape[0], arr.shape[1], image_size)
        top, left = crop
        frames.append(arr[top : top + image_size, left : left + image_size])
    return np.stack(frames)


def host_load_eval_frame(path, image_size: int = 224) -> np.ndarray:
    """Decode -> shortest-side resize to size -> centre crop.  uint8 (H, W, 3).

    A JPEG takes the native fused decode + bicubic resize + crop at full
    resolution (`scaled=False`: within one level of PIL, so evaluation
    inputs stay parity-grade); PIL computes the same transform otherwise."""
    if _is_jpeg(path) and native.available():
        out = native.decode_jpeg_shortest(path, image_size, crop=image_size, scaled=False)
        if out is not None:
            return out
    img = host_resize_shortest(open_rgb(path), image_size)
    return host_center_crop(np.asarray(img), image_size)


def eval_frame_from_bytes(data: bytes, image_size: int = 224,
                          fast: bool = False) -> np.ndarray:
    """An in-memory encoded image (serving requests arrive as bytes, not
    files): decode -> shortest-side bicubic resize -> centre crop.
    uint8 (size, size, 3).

    Default: PIL decode + the parity-grade resize and crop.  fast=True
    (`serve --fast_decode`): the native decode with libjpeg's DCT-domain M/8
    scaling, about two levels from the exact decode.  Non-JPEG payloads
    (PNG etc.) and the native core's absence take the default path."""
    if fast and native.available():
        out = native.decode_jpeg_shortest_bytes(data, image_size, crop=image_size,
                                                scaled=True)
        if out is not None:
            return out
    from io import BytesIO

    from PIL import Image

    img = Image.open(BytesIO(data)).convert("RGB")
    img = host_resize_shortest(img, image_size)
    return host_center_crop(np.asarray(img), image_size)


def host_eval_clip(frames: np.ndarray, image_size: int = 224) -> np.ndarray:
    """Resize + centre-crop an already-decoded (T, H, W, 3) uint8 video."""
    from PIL import Image

    out = []
    for f in frames:
        img = host_resize_shortest(Image.fromarray(f), image_size)
        out.append(host_center_crop(np.asarray(img), image_size))
    return np.stack(out)


# -------------------------------------------------------------- device side

def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """uint8/float [0,255] (..., H, W, 3) -> ImageNet-normalized float32."""
    x = x.to(torch.float32) / 255.0
    return _normalize01(x)


def to_device_in_one_copy(tensors: Sequence[torch.Tensor],
                          device: str | torch.device) -> list[torch.Tensor]:
    """Host tensors -> the same tensors on `device`, through one copy.

    Their bytes are packed into one buffer (8-byte aligned slots; pinned
    when `device` is a card), which is copied with ``non_blocking=True``, and
    each tensor comes back as a view of its slot with its own dtype and
    shape: bit-exact, since bytes are moved and nothing is converted.  On
    the CPU the views are of the host buffer."""
    device = torch.device(device)
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    sizes = [t.numel() * t.element_size() for t in flat]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 8) * 8
    buf = torch.empty(max(total, 8), dtype=torch.uint8, pin_memory=device.type == "cuda")
    for t, off, n in zip(flat, offsets, sizes):
        buf[off:off + n].copy_(t.view(torch.uint8))
    moved = buf.to(device, non_blocking=True)
    return [moved[off:off + n].view(t.dtype).view(src.shape)
            for src, t, off, n in zip(tensors, flat, offsets, sizes)]


@functools.lru_cache(maxsize=8)
def _imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) float32 (3,) on `device`; made once, shared."""
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))


def _normalize01(x: torch.Tensor) -> torch.Tensor:
    """[0,1] float32 (..., 3) -> ImageNet-normalized."""
    mean, std = _imagenet_stats(x.device)
    return (x - mean) / std


def denormalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalized float32 (..., 3) -> [0,1]: `x * std + mean`."""
    mean, std = _imagenet_stats(x.device)
    return x * std + mean


def _per_sample(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(n,) -> (n, 1, ..., 1) on `like`'s device, to broadcast over a sample."""
    return v.to(like.device).view(-1, *([1] * (like.ndim - 1)))


def hflip_clip(clip: torch.Tensor) -> torch.Tensor:
    """Flip (..., H, W, C) along W."""
    return torch.flip(clip, dims=(-2,))


def random_hflip(clip: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip the samples of a batch (n, ..., W, C) whose `flip` (n,) is true."""
    return torch.where(_per_sample(flip, clip), hflip_clip(clip), clip)


def random_crop_clip(clip: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
                     size: int) -> torch.Tensor:
    """(n, T, H, W, C) -> (n, T, size, size, C): each sample's crop at its own
    (top, left), the same for all its frames — one gather."""
    n = clip.shape[0]
    offsets = torch.arange(size, device=clip.device)
    rows = top.to(clip.device).view(n, 1) + offsets                  # (n, size)
    cols = left.to(clip.device).view(n, 1) + offsets
    picked = clip[torch.arange(n, device=clip.device).view(n, 1, 1), :,
                  rows[:, :, None], cols[:, None, :]]                 # (n, size, size, T, C)
    return picked.permute(0, 3, 1, 2, 4).contiguous()


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (`jax.image.resize`'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


@functools.lru_cache(maxsize=16)
def cubic_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of `jax.image.resize(method="cubic")`
    along one axis: half-pixel centres, the kernel widened by the scale when
    shrinking (antialias), taps outside the image dropped and the rest
    divided by their sum (not clamped indices), outputs whose centre falls
    outside the input zeroed.  The array is read-only: it is shared."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    out = np.where(inside[None, :], weights, 0).astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=16)
def _cubic_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`cubic_weight_matrix` on `device`; made once, shared."""
    return torch.tensor(cubic_weight_matrix(in_size, out_size), device=device)


def resize_bicubic(clip: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., size, size, C) as `jax.image.resize(...,
    method="cubic")` computes it: one weight matrix per axis, applied as a
    matrix product (torch's bicubic takes a = -0.75 and clamps the border,
    which is another function)."""
    h, w = clip.shape[-3], clip.shape[-2]
    x = clip
    if h != size:
        x = torch.einsum("...hwc,hy->...ywc", x, _cubic_weights(h, size, clip.device))
    if w != size:
        x = torch.einsum("...ywc,wx->...yxc", x, _cubic_weights(w, size, clip.device))
    return x


@functools.lru_cache(maxsize=8)
def _grey_weights(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor([0.299, 0.587, 0.114], dtype=dtype, device=device)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    return (x * _grey_weights(x.dtype, x.device)).sum(-1, keepdim=True)


def _blend(a: torch.Tensor, b, factor: torch.Tensor) -> torch.Tensor:
    return torch.clamp(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def _hue_shift(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Shift hue by `shift` (fraction of the full circle) via an HSV round
    trip; `%` is the floored remainder, as in the JAX package."""
    r, g, b = x.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    rng_ = maxc - minc
    s = torch.where(maxc > 0, rng_ / torch.clamp_min(maxc, 1e-12), 0.0)
    safe = torch.clamp_min(rng_, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(rng_ == 0, 0.0, h)
    h = torch.remainder(h + shift, 1.0)
    # HSV -> RGB
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(opts):
        out = opts[-1]
        for k in range(len(opts) - 2, -1, -1):
            out = torch.where(i == k, opts[k], out)
        return out

    r2 = pick([v, q, p, p, t, v])
    g2 = pick([t, v, v, q, p, p])
    b2 = pick([p, p, t, v, v, q])
    return torch.stack([r2, g2, b2], dim=-1)


def _jitter_op(op: int, x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """One of the four jitter ops (0 brightness, 1 contrast, 2 saturation,
    3 hue) on clips (n, T, H, W, C) in [0,1] with per-sample factors (n,)."""
    f = _per_sample(factor, x)
    if op == 0:
        return _blend(x, 0.0, f)
    if op == 1:
        # the mean over axes (-3, -2, -1) of the grey (..., H, W, 1): each
        # frame's own mean, as in the JAX package
        return _blend(x, _grayscale(x).mean(dim=(-3, -2, -1), keepdim=True), f)
    if op == 2:
        return _blend(x, _grayscale(x), f)
    return _hue_shift(x, f[..., 0])


def jitter_groups(order, n: int) -> tuple[list[list[tuple[int, int | None]]],
                                          list[torch.Tensor]]:
    """The host half of `color_jitter`: `order` (a static permutation of
    (0, 1, 2, 3), or an (n, 4) tensor with each sample's own) read on the
    host.  Returns (steps, indices): at each of the four positions a list of
    (op, k), `indices[k]` being the samples that take `op` there, or
    [(op, None)] when every sample takes it."""
    order = torch.as_tensor(order, dtype=torch.long, device="cpu").expand(n, 4)
    steps, indices = [], []
    for step in range(4):
        ops = order[:, step]
        if bool((ops == ops[0]).all()):
            steps.append([(int(ops[0]), None)])
            continue
        groups = []
        for op in torch.unique(ops).tolist():
            groups.append((op, len(indices)))
            indices.append(torch.nonzero(ops == op).flatten())
        steps.append(groups)
    return steps, indices


def _apply_jitter(x: torch.Tensor, factors: Sequence[torch.Tensor],
                  steps: list[list[tuple[int, int | None]]],
                  indices: Sequence[torch.Tensor]) -> torch.Tensor:
    """The four positions of `jitter_groups`, each group running its op
    once; factors and indices already on `x`'s device."""
    for groups in steps:
        if groups[0][1] is None:
            op = groups[0][0]
            x = _jitter_op(op, x, factors[op])
            continue
        out = torch.empty_like(x)
        for op, k in groups:
            out[indices[k]] = _jitter_op(op, x[indices[k]], factors[op][indices[k]])
        x = out
    return x


def color_jitter(clip01: torch.Tensor, factors: tuple[torch.Tensor, ...],
                 order) -> torch.Tensor:
    """torchvision-semantics colour jitter of clips (n, T, H, W, C) in [0,1].

    `factors` = (brightness, contrast, saturation, hue shift), each (n,);
    `order` is a static permutation of (0, 1, 2, 3) for every sample, or an
    (n, 4) CPU tensor with each sample's own.  At each of the four positions
    the samples are grouped by the op they take there and each group runs
    its op once: the values of the JAX package's vmapped switch, without
    computing the three branches it throws away.  The grouping is made on
    the host; factors and group indices reach the device in one copy.
    """
    steps, indices = jitter_groups(order, clip01.shape[0])
    moved = to_device_in_one_copy([*factors, *indices], clip01.device)
    return _apply_jitter(clip01, moved[:4], steps, moved[4:])


@dataclasses.dataclass(frozen=True)
class AugmentDraws:
    """Every random number of one batch's augmentation, per sample (n,)."""

    flip1: torch.Tensor        # bool: flip view 1 (and so view 2's source)
    top: torch.Tensor          # int64: view 2's crop offsets in view 1
    left: torch.Tensor
    brightness: torch.Tensor   # float32 jitter factors
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor          # float32 hue shift, a fraction of the circle
    order: torch.Tensor        # int64 (n, 4): each sample's jitter-op order, on the CPU
    flip2: torch.Tensor        # bool: flip view 2 after the resize

    def rows(self, start: int, stop: int) -> AugmentDraws:
        """The draws of samples [start, stop): a rank's slice of the global
        batch's draws."""
        return AugmentDraws(*(getattr(self, f.name)[start:stop]
                              for f in dataclasses.fields(self)))


def sample_augment_draws(b: int, generator: torch.Generator, jitter_order: str = "random",
                         image_size: int = 224, clip_size: int | None = None) -> AugmentDraws:
    """The draws of `augment_train_batch` for `b` clips of `clip_size`
    (default `image_size`) pixels, from `generator` (a CPU generator: the
    draws are made on the host), with the JAX package's distributions:
    Bernoulli(0.5) flips, crop offsets uniform on [0, clip_size - crop], jitter
    factors uniform on [max(0, 1 - 0.5), 1.5], a hue shift uniform on
    [-0.5, 0.5], and a uniform random order of the four ops ('random') or
    brightness -> contrast -> saturation -> hue ('fixed')."""
    if jitter_order not in ("random", "fixed"):
        raise ValueError(f"jitter_order must be 'random' or 'fixed', got {jitter_order!r}")
    span = (clip_size or image_size) - int(image_size * CROP_FRACTION) + 1

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(b, generator=generator)

    flip1 = torch.rand(b, generator=generator) < 0.5
    top = torch.randint(0, span, (b,), generator=generator)
    left = torch.randint(0, span, (b,), generator=generator)
    fb, fc, fs = (uniform(max(0.0, 1.0 - a), 1.0 + a) for a in JITTER[:3])
    shift = uniform(-JITTER[3], JITTER[3])
    if jitter_order == "random":
        order = torch.stack([torch.randperm(4, generator=generator) for _ in range(b)])
    else:
        order = torch.tensor(FIXED_ORDER).expand(b, 4).clone()
    flip2 = torch.rand(b, generator=generator) < 0.5
    return AugmentDraws(flip1, top, left, fb, fc, fs, shift, order, flip2)


def augment_train_batch(clips_uint8: torch.Tensor, draws: AugmentDraws,
                        image_size: int = 224) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side training augmentation of a (B, T, S, S, 3) uint8 batch.

    Returns (view1, view2), both ImageNet-normalized float32 on the batch's
    device:
      view1 = random hflip of the host-cropped clip;
      view2 = RandomCrop(0.7 size) -> ColorJitter(.5, .5, .5, .5) in each
              sample's order -> bicubic resize to size -> random hflip, built
              from view1.
    The draws and the jitter's sample groups reach the batch's device in one
    pinned, non-blocking copy (`to_device_in_one_copy`).
    """
    crop_size = int(image_size * CROP_FRACTION)
    steps, indices = jitter_groups(draws.order, clips_uint8.shape[0])
    moved = to_device_in_one_copy(
        [draws.flip1, draws.top, draws.left, draws.brightness, draws.contrast,
         draws.saturation, draws.hue, draws.flip2, *indices], clips_uint8.device)
    flip1, top, left, *factors, flip2 = moved[:8]
    v1 = random_hflip(clips_uint8.to(torch.float32) / 255.0, flip1)
    v2 = random_crop_clip(v1, top, left, crop_size)
    v2 = _apply_jitter(v2, factors, steps, moved[8:])
    v2 = resize_bicubic(v2, image_size)
    v2 = random_hflip(torch.clamp(v2, 0.0, 1.0), flip2)
    return _normalize01(v1), _normalize01(v2)


def augment_view1(clips_uint8: torch.Tensor, flip1: torch.Tensor) -> torch.Tensor:
    """View 1 of `augment_train_batch` alone, (B, T, S, S, 3) uint8 ->
    ImageNet-normalized float32: each clip flipped where `flip1` (B,) is
    true.  The 3D tube step trains on view 1 only; the JAX package draws
    both views and drops the second, whose work this skips."""
    return _normalize01(random_hflip(clips_uint8.to(torch.float32) / 255.0, flip1))
