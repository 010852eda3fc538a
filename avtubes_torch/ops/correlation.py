"""Correlation cost volume (FlowNet-style): kernels, autograd, plain version.

For every pixel of feature map 1 and every displacement of a
(2*(max_disp//stride) + 1)^2 window, the channel-mean dot product with the
displaced pixel of feature map 2, f2 read as zero outside the map:

    corr[b, i, j, k] = mean_c f1[b, i, j, c] * f2[b, i + dy, j + dx, c]

with k = iy * n + ix over (dy, dx) in {i * stride}^2, dy outer — the channel
order of the JAX package, which `FlowNetLite`'s soft-argmax relies on.

Replaces the TPU kernel `_corr_kernel` of `avtubes/ops/correlation.py`
(launched by `correlation_pallas`) and the backward of
`_correlation_pallas_ad`.  The kernels are `csrc/correlation.cu`, written by
hand for sm_90a and bound through `ctypes`.  The work is bound by bytes on
paper (each map read once, the volume written once); what a kernel pays above
that is the re-reading of the other map's halo from L2, the shared-memory
operands of its FMAs, and loads that do not overlap arithmetic.  The tiled
kernels answer each: a block owns a 2-D tile (TH x TW pixels of one image)
and stages the (TH + 2R) x (TW + 2R) halo, the channels are copied by
`cp.async` in chunks of `TILE_CK` while the sums stay in registers — into a
ring of two buffers where the grid is one wave and a block is alone on its
SM, into one buffer where two blocks an SM overlap each other — and a thread
owns several outputs that share operands (forward: 4 columns x 9 dx of one
row and dy; backward: 4 columns x 4 channels).  Both gradients come from one
launch, in gather form without atomics (deterministic); the coefficients of
the f2 gradient are the mirrored patch of the cotangent, built in shared
memory.  Every sum runs in increasing index order (channels chunk after
chunk in the forward, displacements dy-outer in the backward).

Which kernel runs follows from the geometry alone: `correlation_plan` (its
twin in C is `avt_correlation_variant`; `correlation_plan_cuda` asks it):
`tiled` for stride 1, C % 4 == 0 and 16-byte aligned maps whose tile fits
shared memory; the row-segment kernels `rowseg_vec4` / `rowseg_scalar` for
other strides, channel counts and alignments; `direct` for a window no tile
holds.  `correlation_tiled_plain` and `correlation_backward_both_plain` write
the tiled algorithm out on tensors, tile by tile and chunk by chunk, for the
CPU tests.

`CorrelationFunction` ties the kernels into autograd: one forward launch, and
one backward launch that computes the gradients that are needed and no other.

Layout: the interface is channels last, (B, H, W, C) in and (B, H, W, D)
out, as in the JAX package.  That is also what the consumer wants: the
softmax runs over the contiguous D axis, and the concat with f1 is a
channels-last tensor that a convolution takes as it is.  `FlowNetLite`'s
encoder produces (B, C, H, W); the one copy that costs,
`permute(0, 2, 3, 1).contiguous()`, is made inside `correlation_cost_volume`,
so whoever times that function times the copy with the kernel.

`correlation_cost_volume` takes the plain version only for a tensor that
lies on the CPU.  For a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch


def displacements(max_disp: int, stride: int) -> list[int]:
    """The symmetric grid i * stride, |i| <= max_disp // stride: it always
    holds 0, also when stride does not divide max_disp."""
    steps = max_disp // stride
    return [i * stride for i in range(-steps, steps + 1)]


def _check_args(max_disp: int, stride: int) -> None:
    if max_disp < 0 or stride < 1:
        raise ValueError(f"need max_disp >= 0 and stride >= 1, got {max_disp}, {stride}")


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4,
                      stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, C) x2 -> (B, H, W, D), one
    shift-multiply-mean per displacement on a zero-padded f2.  Differentiable
    by autograd, on any device and float type; the CPU tests use it and the
    kernels are held against it on the card."""
    _check_args(max_disp, stride)
    _, h, w, _ = f1.shape
    f2p = torch.nn.functional.pad(f2, (0, 0, max_disp, max_disp, max_disp, max_disp))
    disps = displacements(max_disp, stride)
    outs = []
    for dy in disps:
        for dx in disps:
            shifted = f2p[:, max_disp + dy:max_disp + dy + h,
                          max_disp + dx:max_disp + dx + w]
            outs.append((f1 * shifted).mean(dim=-1))
    return torch.stack(outs, dim=-1)


# ---- which kernel, which tile: the twin of `make_plan` in csrc/correlation.cu

#: names of the kernels' variants, by the code `avt_correlation_variant` gives
VARIANTS = ("direct", "rowseg_scalar", "rowseg_vec4", "tiled")
#: the fields `avt_correlation_variant` fills, in its order
PLAN_FIELDS = ("variant", "th", "tw", "ck", "stages", "smem", "blocks", "threads")
MAX_DYNAMIC_SMEM = 232448 - 1024   # bytes of shared memory a block may ask for
ROWSEG_SMEM_TARGET = 64 * 1024     # a row-segment block: three fit one SM
ROWSEG_THREADS = 256
TILE_CK = 32          # channels a chunk of the tiled kernels
TILE_CKP = 36         # floats a staged pixel takes (an odd number of float4)
TILE_JT = 4           # neighbouring columns a thread owns
TILE_NX = 9           # displacements along x a forward thread owns
TILE_THREADS = 320    # most threads a tiled block has
DENSE_THREADS = 256   # ... a forward block without a ring (two fit an SM)
SM_COUNT = 132        # of an H100
SM_SMEM = 233472      # shared memory of one SM; a block takes 1 KB beside its own
COPY_COST = 13        # FMAs that one float copied from L2 costs (measured)


def _plan_tiled(backward: bool, gradients: int, b: int, h: int, w: int, c: int,
                r: int) -> dict | None:
    """The tile and ring depth of the tiled kernels (stride 1, reach `r`): the
    candidate with the least modelled time, or None when no tile fits a
    block.  Candidates: every tile whose work fits one block (a thread per
    item), with one buffer or a ring of two.  The model, in FMA times: a
    block copies `copy` floats at `COPY_COST` each and does `comp` FMAs;
    alone on its SM with one buffer it takes their sum; with a ring, or with
    a second block beside it, the smaller hides behind the larger except for
    one chunk; the busiest SM gets ceil(blocks / SM_COUNT) blocks.  Integers
    only and the same order of trial as the C twin (`plan_tiled`)."""
    n = 2 * r + 1
    d = n * n
    nxc = -(-n // TILE_NX)
    nch = -(-c // TILE_CK)
    best = None
    for th in range(1, min(h, TILE_THREADS) + 1):
        for tq in range(1, -(-w // TILE_JT) + 1):
            tw = TILE_JT * tq
            items = th * tq * (TILE_CK // 4) if backward else th * tq * n * nxc
            if items > TILE_THREADS:
                break
            hrows, hcols = th + 2 * r, tw + 2 * r
            hpitch = hcols if backward else (tw + TILE_NX * nxc - 1) | 1
            blocks = -(-h // th) * -(-w // tw) * b
            if blocks * gradients > 0x7FFFFFFF:
                continue
            m = -(-blocks * (gradients if backward else 1) // SM_COUNT)
            copy = COPY_COST * (nch * TILE_CK * (hrows * hcols + (0 if backward else th * tw))
                                + (th * tw * d if backward else 0))
            comp = th * tw * d * c
            overlapped = max(copy, comp) + min(copy, comp) // nch
            for stages in (1, 2):
                if not backward and stages == 1 and items > DENSE_THREADS:
                    continue
                if backward:
                    smem = (4 * ((th * tw * d + 3) & ~3)
                            + 4 * stages * TILE_CKP * hrows * hpitch)
                else:
                    smem = max(4 * stages * TILE_CKP * (hrows * hpitch + th * (tw | 1)),
                               4 * th * tw * d)
                if smem > MAX_DYNAMIC_SMEM:
                    continue
                alone = (not backward and stages == 2) or 2 * (smem + 1024) > SM_SMEM
                serial = stages == 1 and (m == 1 or alone)
                time = m * (copy + comp if serial else overlapped)
                if best is not None and time >= best[0]:
                    continue
                best = (time, {
                    "variant": "tiled", "th": th, "tw": tw, "ck": TILE_CK,
                    "stages": stages, "smem": smem, "blocks": blocks,
                    "threads": -(-items // 32) * 32})
    return None if best is None else best[1]


def correlation_plan(b: int, h: int, w: int, c: int, max_disp: int, stride: int,
                     aligned: bool, backward: bool = False, gradients: int = 2) -> dict:
    """Which kernel maps of this geometry take and with which tile, from the
    geometry and `aligned` (every map on a 16-byte boundary) alone: a dict
    of `PLAN_FIELDS`.  `gradients` is what one backward launch computes (1 or
    2; the forward ignores it); `blocks` counts one gradient's blocks.  Pure
    Python: needs neither the card nor the library."""
    _check_args(max_disp, stride)
    if gradients not in (1, 2):
        raise ValueError(f"gradients must be 1 or 2, got {gradients}")
    if min(b, h, w, c) < 1:
        raise ValueError(f"empty maps: B={b}, H={h}, W={w}, C={c}")
    aligned = bool(aligned) and c % 4 == 0
    steps = max_disp // stride
    n, r = 2 * steps + 1, steps * stride
    d = n * n
    if stride == 1 and aligned:
        plan = _plan_tiled(backward, gradients, b, h, w, c, r)
        if plan is not None:
            return plan
    c4 = -(-c // 4)
    cp = 4 * (c4 | 1)
    extra = d if backward else cp

    def seg_bytes(tw):
        return 4 * (n * (tw + 2 * r) * cp + tw * extra)

    if seg_bytes(1) > MAX_DYNAMIC_SMEM:
        total = b * h * w * (c if backward else d)
        return {"variant": "direct", "th": 0, "tw": 0, "ck": c, "stages": 1, "smem": 0,
                "blocks": min(-(-total // ROWSEG_THREADS), 65536),
                "threads": ROWSEG_THREADS}
    tw = 1
    while tw < w and seg_bytes(tw + 1) <= ROWSEG_SMEM_TARGET:
        tw += 1
    nt = -(-w // tw)
    tw = -(-w // nt)
    work = tw * (c4 if backward else d)
    rounds = -(-work // ROWSEG_THREADS)
    return {"variant": "rowseg_vec4" if aligned else "rowseg_scalar", "th": 1, "tw": tw,
            "ck": c, "stages": 1, "smem": seg_bytes(tw), "blocks": b * h * nt,
            "threads": -(-(-(-work // rounds)) // 32) * 32}


def correlation_variant(b: int, h: int, w: int, c: int, max_disp: int, stride: int,
                        aligned: bool, backward: bool = False, gradients: int = 2) -> str:
    """The name of the kernel variant `correlation_plan` chooses (one of
    `VARIANTS`)."""
    return correlation_plan(b, h, w, c, max_disp, stride, aligned, backward,
                            gradients)["variant"]


def _aligned(*maps: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in maps)


def _bind():
    """The kernels' library with its three entry points declared."""
    from avtubes_torch.ops._build import load_library

    lib = load_library("correlation")
    if lib.avt_correlation_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.avt_correlation_forward.argtypes = [p, p, p] + [i] * 7 + [p]
        lib.avt_correlation_backward.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.avt_correlation_variant.argtypes = [i] * 9 + [ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.avt_correlation_forward, lib.avt_correlation_backward,
                   lib.avt_correlation_variant):
            fn.restype = ctypes.c_int
    return lib


def correlation_plan_cuda(b: int, h: int, w: int, c: int, max_disp: int, stride: int,
                          aligned: bool, backward: bool = False, gradients: int = 2) -> dict:
    """`correlation_plan` as the library's launcher decides it
    (`avt_correlation_variant`): the smoke script holds the two against each
    other.  Needs the built library, not the card."""
    fields = (ctypes.c_int * len(PLAN_FIELDS))()
    code = _bind().avt_correlation_variant(int(backward), gradients, b, h, w, c, max_disp,
                                           stride, int(aligned), fields)
    if code < 0:
        raise ValueError("no correlation kernel takes this geometry")
    plan = dict(zip(PLAN_FIELDS, fields))
    plan["variant"] = VARIANTS[code]
    return plan


# ---- the tiled algorithm on tensors (CPU tests)

def _pad_to_tiles(x: torch.Tensor, th: int, tw: int, reach: int) -> torch.Tensor:
    """(B, H, W, C) zero-padded by `reach` on every side, and below and to
    the right up to whole tiles."""
    _, h, w, _ = x.shape
    return torch.nn.functional.pad(
        x, (0, 0, reach, reach + -w % tw, reach, reach + -h % th))


def correlation_tiled_plain(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4,
                            stride: int = 1, tile: tuple[int, int] | None = None,
                            chunk: int = TILE_CK) -> torch.Tensor:
    """The forward as the tiled kernel runs it, on tensors: per (TH x TW)
    tile the zero-filled (TH + 2R) x (TW + 2R) halo of f2, the channels in
    chunks of `chunk` accumulated in order into one accumulator per output,
    ragged tile edges cut at the store.  `tile` defaults to the plan's.  (The
    kernel takes stride 1; the algorithm here takes any.)"""
    _check_args(max_disp, stride)
    b, h, w, c = f1.shape
    n, r = 2 * (max_disp // stride) + 1, max_disp // stride * stride
    if tile is None:
        plan = _plan_tiled(False, 1, b, h, w, c, r)
        tile = (plan["th"], plan["tw"])
    th, tw = tile
    f1p = _pad_to_tiles(f1, th, tw, 0)
    f2p = _pad_to_tiles(f2, th, tw, r)
    out = f1.new_zeros((b, f1p.shape[1], f1p.shape[2], n * n))
    for i0 in range(0, h, th):
        for j0 in range(0, w, tw):
            own = f1p[:, i0:i0 + th, j0:j0 + tw]
            halo = f2p[:, i0:i0 + th + 2 * r, j0:j0 + tw + 2 * r]
            acc = f1.new_zeros((b, th, tw, n * n))
            for c0 in range(0, c, chunk):
                a = own[..., c0:c0 + chunk]
                for iy in range(n):
                    for ix in range(n):
                        v = halo[:, iy * stride:iy * stride + th,
                                 ix * stride:ix * stride + tw, c0:c0 + chunk]
                        acc[..., iy * n + ix] += (a * v).sum(dim=-1)
            out[:, i0:i0 + th, j0:j0 + tw] = acc / c
    return out[:, :h, :w]


def correlation_backward_both_plain(
        grad_out: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4,
        stride: int = 1, tile: tuple[int, int] | None = None, chunk: int = TILE_CK,
        want: tuple[bool, bool] = (True, True),
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Both gradients as the tiled backward kernel computes them in one
    launch, on tensors (any stride; the kernel takes stride 1).  Per tile and gradient: the coefficients
    (TH, TW, D) — the cotangent's own tile for f1's gradient; for f2's the
    mirrored patch, coefficient k of a pixel = channel D-1-k of the cotangent
    at that pixel's neighbour k — then per chunk of output channels the D-long
    gather sum over the source's halo, dy outer."""
    _check_args(max_disp, stride)
    b, h, w, c = f1.shape
    n, r = 2 * (max_disp // stride) + 1, max_disp // stride * stride
    d = n * n
    if tile is None:
        plan = _plan_tiled(True, sum(want), b, h, w, c, r)
        tile = (plan["th"], plan["tw"])
    th, tw = tile
    gp = _pad_to_tiles(grad_out, th, tw, r)
    grads: list[torch.Tensor | None] = [None, None]
    for mirror in (False, True):
        if not want[mirror]:
            continue
        srcp = _pad_to_tiles(f1 if mirror else f2, th, tw, r)
        grad = f1.new_zeros((b, h + -h % th, w + -w % tw, c))
        for i0 in range(0, h, th):
            for j0 in range(0, w, tw):
                patch = gp[:, i0:i0 + th + 2 * r, j0:j0 + tw + 2 * r]
                if mirror:
                    coef = torch.stack(
                        [patch[:, k // n * stride:k // n * stride + th,
                               k % n * stride:k % n * stride + tw, d - 1 - k]
                         for k in range(d)], dim=-1)
                else:
                    coef = patch[:, r:r + th, r:r + tw]
                halo = srcp[:, i0:i0 + th + 2 * r, j0:j0 + tw + 2 * r]
                for c0 in range(0, c, chunk):
                    acc = f1.new_zeros((b, th, tw, min(chunk, c - c0)))
                    for k in range(d):
                        v = halo[:, k // n * stride:k // n * stride + th,
                                 k % n * stride:k % n * stride + tw, c0:c0 + chunk]
                        acc += coef[..., k, None] * v
                    grad[:, i0:i0 + th, j0:j0 + tw, c0:c0 + chunk] = acc / c
        grads[mirror] = grad[:, :h, :w]
    return grads[0], grads[1]


# ---- the wrappers

def _check_maps(what: str, *maps: torch.Tensor) -> None:
    first = maps[0]
    for t in maps:
        if not t.is_cuda:
            raise ValueError(f"{what} needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: maps must be float32, got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{what}: expected (B, H, W, C), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: maps must be contiguous (B, H, W, C)")
        if t.device != first.device or t.shape[:3] != first.shape[:3]:
            raise ValueError(f"{what}: maps disagree: {tuple(first.shape)} on "
                             f"{first.device} and {tuple(t.shape)} on {t.device}")


def _check_size(b: int, h: int, w: int, c: int, d: int) -> None:
    if min(h, w, c) < 1:
        raise ValueError(f"empty map: H={h}, W={w}, C={c}")
    if h * w * max(c, d) >= 2 ** 31 or b * h * w >= 2 ** 31:
        raise ValueError("map too large for the kernels' int32 pixel index")


def correlation_forward_cuda(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4,
                             stride: int = 1) -> torch.Tensor:
    """Launch the forward kernel: (B, H, W, C) contiguous float32 x2 on the
    card -> (B, H, W, D).  No autograd (see `CorrelationFunction`).  Launches
    on the current stream and does not synchronise.  Raises on anything the
    kernel does not take and on a refused launch; it never takes another
    implementation."""
    _check_args(max_disp, stride)
    _check_maps("correlation_forward_cuda", f1, f2)
    if f1.shape != f2.shape:
        raise ValueError(f"f1 {tuple(f1.shape)} and f2 {tuple(f2.shape)} differ")
    b, h, w, c = f1.shape
    d = len(displacements(max_disp, stride)) ** 2
    _check_size(b, h, w, c, d)
    out = torch.empty((b, h, w, d), dtype=torch.float32, device=f1.device)
    if b == 0:
        return out
    err = _bind().avt_correlation_forward(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, max_disp, stride,
        f1.device.index, torch.cuda.current_stream(f1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"avt_correlation_forward launch failed: CUDA error {err}")
    correlation_forward_cuda.launches += 1
    return out


def _launch_backward(grad_out: torch.Tensor, f1: torch.Tensor | None,
                     f2: torch.Tensor | None, max_disp: int, stride: int,
                     ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """One launch of the backward kernel for the gradients whose source map
    is given: f2 -> the gradient of f1, f1 -> the gradient of f2."""
    _check_args(max_disp, stride)
    maps = [t for t in (f1, f2) if t is not None]
    _check_maps("correlation_backward_cuda", grad_out, *maps)
    if len(maps) == 2 and f1.shape != f2.shape:
        raise ValueError(f"f1 {tuple(f1.shape)} and f2 {tuple(f2.shape)} differ")
    b, h, w, c = maps[0].shape
    d = len(displacements(max_disp, stride)) ** 2
    if grad_out.shape[3] != d:
        raise ValueError(f"grad_out has {grad_out.shape[3]} channels, the window has {d}")
    _check_size(b, h, w, c, d)
    gf1 = torch.empty_like(f2) if f2 is not None else None
    gf2 = torch.empty_like(f1) if f1 is not None else None
    if b == 0:
        return gf1, gf2

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = _bind().avt_correlation_backward(
        grad_out.data_ptr(), ptr(f1), ptr(f2), ptr(gf1), ptr(gf2), b, h, w, c, max_disp,
        stride, grad_out.device.index,
        torch.cuda.current_stream(grad_out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"avt_correlation_backward launch failed: CUDA error {err}")
    correlation_backward_cuda.launches += 1
    correlation_backward_cuda.gradients += len(maps)
    return gf1, gf2


def correlation_backward_cuda(grad_out: torch.Tensor, src: torch.Tensor, wrt: str,
                              max_disp: int = 4, stride: int = 1) -> torch.Tensor:
    """Launch the backward kernel once for one gradient: that of the volume
    with respect to f1 (`wrt='f1'`, `src` is f2) or to f2 (`wrt='f2'`, `src`
    is f1).  grad_out (B, H, W, D), src (B, H, W, C), both contiguous float32
    on the card -> (B, H, W, C).  Raises like `correlation_forward_cuda`."""
    if wrt not in ("f1", "f2"):
        raise ValueError(f"wrt must be 'f1' or 'f2', got {wrt!r}")
    if wrt == "f1":
        return _launch_backward(grad_out, None, src, max_disp, stride)[0]
    return _launch_backward(grad_out, src, None, max_disp, stride)[1]


def correlation_backward_both_cuda(grad_out: torch.Tensor, f1: torch.Tensor,
                                   f2: torch.Tensor, max_disp: int = 4, stride: int = 1,
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel once for both gradients: half of the grid
    computes f1's, the other half f2's.  Shapes and errors as
    `correlation_backward_cuda`."""
    return _launch_backward(grad_out, f1, f2, max_disp, stride)


#: what this process launched (plain ints; the smoke script sets them to 0
#: before the training steps and reads them after).  A training step launches
#: the forward once and the backward once, for both gradients: `launches`
#: counts launches of the backward kernel, `gradients` the gradients they
#: computed.
correlation_forward_cuda.launches = 0
correlation_backward_cuda.launches = 0
correlation_backward_cuda.gradients = 0


class CorrelationFunction(torch.autograd.Function):
    """The CUDA kernels under autograd: forward kernel forward; backward one
    launch that computes the gradients of the inputs that need one."""

    @staticmethod
    def forward(ctx, f1, f2, max_disp, stride):
        ctx.save_for_backward(f1, f2)
        ctx.window = (max_disp, stride)
        return correlation_forward_cuda(f1, f2, max_disp, stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        f1, f2 = ctx.saved_tensors
        need1, need2 = ctx.needs_input_grad[:2]
        if not (need1 or need2):
            return None, None, None, None
        # f2 is the source of f1's gradient and f1 of f2's
        gf1, gf2 = _launch_backward(grad_out.contiguous(), f1 if need2 else None,
                                    f2 if need1 else None, *ctx.window)
        return gf1, gf2, None, None


def correlation_cost_volume(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4,
                            stride: int = 1, impl: str = "kernel") -> torch.Tensor:
    """Cost volume between two (B, H, W, C) feature maps -> (B, H, W, D),
    differentiable with respect to both.

    impl: 'kernel' — the CUDA kernels when the maps are on the card (or an
          error); the plain version only because the maps lie on the CPU;
          'plain' — the shift-multiply-mean loop, on any device.
    A map that is not contiguous in (B, H, W, C) — the permuted output of a
    channels-first convolution — is copied here before the kernel runs.
    """
    if impl == "plain" or (impl == "kernel" and not f1.is_cuda):
        return correlation_plain(f1, f2, max_disp, stride)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    return CorrelationFunction.apply(f1.contiguous(), f2.contiguous(), max_disp, stride)
