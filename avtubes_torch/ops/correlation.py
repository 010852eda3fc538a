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
hand for sm_90a and bound through `ctypes`: one forward kernel and one
gather-form backward kernel that computes either gradient (no atomics, so
the gradients are deterministic).  `CorrelationFunction` ties them into
autograd and launches a backward kernel only for an input that needs its
gradient.  The work is bound by bytes on paper (each map read once, the
volume written once); see the note at the head of the source for what the
design pays above that.

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


def _bind(name: str):
    from avtubes_torch.ops._build import load_library

    fn = getattr(load_library("correlation"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, p, p] + [i] * 7 + [p] if name == "avt_correlation_forward"
                       else [p, p, p] + [i] * 8 + [p])
        fn.restype = ctypes.c_int
    return fn


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
    err = _bind("avt_correlation_forward")(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, max_disp, stride,
        f1.device.index, torch.cuda.current_stream(f1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"avt_correlation_forward launch failed: CUDA error {err}")
    correlation_forward_cuda.launches += 1
    return out


def correlation_backward_cuda(grad_out: torch.Tensor, src: torch.Tensor, wrt: str,
                              max_disp: int = 4, stride: int = 1) -> torch.Tensor:
    """Launch the backward kernel once: the gradient of the volume with
    respect to f1 (`wrt='f1'`, `src` is f2) or to f2 (`wrt='f2'`, `src` is
    f1).  grad_out (B, H, W, D), src (B, H, W, C), both contiguous float32 on
    the card -> (B, H, W, C).  Raises like `correlation_forward_cuda`."""
    _check_args(max_disp, stride)
    if wrt not in ("f1", "f2"):
        raise ValueError(f"wrt must be 'f1' or 'f2', got {wrt!r}")
    _check_maps("correlation_backward_cuda", grad_out, src)
    b, h, w, c = src.shape
    d = len(displacements(max_disp, stride)) ** 2
    if grad_out.shape[3] != d:
        raise ValueError(f"grad_out has {grad_out.shape[3]} channels, the window has {d}")
    _check_size(b, h, w, c, d)
    grad = torch.empty_like(src)
    if b == 0:
        return grad
    err = _bind("avt_correlation_backward")(
        grad_out.data_ptr(), src.data_ptr(), grad.data_ptr(), int(wrt == "f2"),
        b, h, w, c, max_disp, stride, src.device.index,
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"avt_correlation_backward launch failed: CUDA error {err}")
    correlation_backward_cuda.launches += 1
    return grad


#: launches of each CUDA kernel by this process (plain ints; the smoke script
#: sets them to 0 before the training steps and reads them after).  A
#: training step launches the forward once and the backward twice, once per
#: gradient.
correlation_forward_cuda.launches = 0
correlation_backward_cuda.launches = 0


class CorrelationFunction(torch.autograd.Function):
    """The CUDA kernels under autograd: forward kernel forward, one backward
    kernel launch per input that needs its gradient."""

    @staticmethod
    def forward(ctx, f1, f2, max_disp, stride):
        ctx.save_for_backward(f1, f2)
        ctx.window = (max_disp, stride)
        return correlation_forward_cuda(f1, f2, max_disp, stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        f1, f2 = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        gf1 = gf2 = None
        if ctx.needs_input_grad[0]:
            gf1 = correlation_backward_cuda(grad_out, f2, "f1", *ctx.window)
        if ctx.needs_input_grad[1]:
            gf2 = correlation_backward_cuda(grad_out, f1, "f2", *ctx.window)
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
