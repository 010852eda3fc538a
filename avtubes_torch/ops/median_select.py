"""Exact k-th-order-statistic threshold + mask: kernel, plain version, oracle.

The heatmap postprocess binarizes each upsampled 224x224 map at its median
pixel — the value at sorted index H*W/2.  Only the k-th smallest VALUE is
needed, and for non-negative IEEE-754 floats the int32 view of the bit
pattern orders like the floats, so the search can run on integers, where
counting has no rounding: the answer is bit-identical to `sort(x)[k]`, ties
and all.  Two searches over the bit space are written here:

  * bisection (`kth_value_bits`, the plain version `median_mask_plain`): 31
    compare-and-count steps converge to the smallest pattern m with
    count(x <= m) >= k+1 — what the TPU kernel does;
  * radix select (`kth_value_radix`): the 31 value bits as digits of
    11 + 10 + 10, most significant first; per digit a histogram of the
    elements that still match the prefix, a cumulative sum, the bin that
    holds rank k, and k reduced by the count below it — what the CUDA kernel
    does, written out on tensors for the tests.

Replaces the TPU kernel `_median_mask_kernel` of
`avtubes/ops/median_select.py` (launched by `median_mask_pallas`).  The
kernel is `csrc/median_select.cu`, written by hand for sm_90a and bound
through `ctypes`.  On paper it is bound by bytes (one read, one write of the
map); at a serving batch those take about a microsecond, so what counts is
how many SMs work and how many grid-wide steps are serial.  A map is split
over a cluster of 8 blocks that keep it in registers (read from device
memory once), and the three digit passes each cost one cluster barrier, the
blocks' histograms summed through distributed shared memory.  See the note
at the head of `csrc/median_select.cu`.

Inputs must be non-negative finite floats (any magnitude up to the largest
finite f32).  NaN and negative values are outside the contract; nothing
here clamps or checks them, the caller guarantees it.

`median_mask` takes the plain version only for a tensor that lies on the
CPU.  For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

_MAX_BITS = 0x7F7FFFFF  # bit pattern of the largest finite f32: the search
#                          covers ALL finite non-negative inputs, not just
#                          [0, 1] (an un-normalized map must get the exact
#                          answer, not a silent clamp at 1.0)
_ITERS = 31             # ceil(log2(_MAX_BITS + 1)) = 31 exactly
#: the radix select's digits as (shift, bits), most significant first; the
#: same split as `digit_shift` / `digit_bits` of csrc/median_select.cu
RADIX_DIGITS = ((20, 11), (10, 10), (0, 10))
#: names of the kernel's variants, by the code `avt_median_mask_variant` gives
VARIANTS = ("streaming_scalar", "streaming_vec4", "resident_scalar", "resident_vec4")


def kth_value_bits(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) non-negative f32 -> (B,) exact k-th smallest value per row, by
    bisection on `x.view(torch.int32)`; every step is one compare-and-count
    pass over the whole batch."""
    bits = x.contiguous().view(torch.int32)
    b = x.shape[0]
    lo = torch.zeros((b,), dtype=torch.int32, device=x.device)
    hi = torch.full((b,), _MAX_BITS, dtype=torch.int32, device=x.device)
    for _ in range(_ITERS):
        mid = lo + ((hi - lo) >> 1)  # lo + hi could overflow int32
        cnt = (bits <= mid[:, None]).sum(dim=1)
        take_lo = cnt >= k + 1
        lo, hi = torch.where(take_lo, lo, mid + 1), torch.where(take_lo, mid, hi)
    return lo.view(torch.float32)


def kth_value_radix(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) non-negative f32 -> (B,) exact k-th smallest value per row, by
    the kernel's radix select written out on tensors (tests only)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    b = x.shape[0]
    prefix = torch.zeros((b,), dtype=torch.int64, device=x.device)
    rank_left = torch.full((b,), k, dtype=torch.int64, device=x.device)
    matching = bits >= 0                      # pass 0: every value in the contract
    for shift, nbits in RADIX_DIGITS:
        digit = (bits >> shift) & ((1 << nbits) - 1)
        hist = torch.zeros((b, 1 << nbits), dtype=torch.int64, device=x.device)
        hist.scatter_add_(1, digit, matching.to(torch.int64))
        upto = hist.cumsum(dim=1)
        # the first bin whose cumulative count exceeds the rank holds it
        chosen = (upto <= rank_left[:, None]).sum(dim=1).clamp_(max=(1 << nbits) - 1)
        below = (upto - hist).gather(1, chosen[:, None])[:, 0]
        rank_left = rank_left - below
        prefix = (prefix << nbits) | chosen
        matching = matching & (digit == chosen[:, None])
    return prefix.to(torch.int32).view(torch.float32)


def median_mask_plain(pred: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W) -> {0,1} float32 mask of the pixels
    strictly above the exact k-th smallest value of each map."""
    b, h, w = pred.shape
    flat = pred.reshape(b, -1)
    thr = kth_value_bits(flat, k)
    return (flat > thr[:, None]).to(torch.float32).reshape(b, h, w)


def median_mask_sort(pred: torch.Tensor, k: int) -> torch.Tensor:
    """The sort oracle (tests and the smoke script only; the port's paths
    never call it)."""
    b, h, w = pred.shape
    flat = pred.reshape(b, -1)
    thr = torch.sort(flat, dim=1).values[:, k]
    return (flat > thr[:, None]).to(torch.float32).reshape(b, h, w)


def _bind():
    """The kernel's library with both entry points declared."""
    from avtubes_torch.ops._build import load_library

    lib = load_library("median_select")
    if lib.avt_median_mask.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.avt_median_mask.argtypes = [p, p, i, i, i, i, p]
        lib.avt_median_mask.restype = ctypes.c_int
        lib.avt_median_mask_variant.argtypes = [p, p, i]
        lib.avt_median_mask_variant.restype = ctypes.c_int
    return lib


def median_mask_variant(pred: torch.Tensor, out: torch.Tensor) -> str:
    """Which variant of the kernel maps of this size at these addresses take
    (one of `VARIANTS`): decided from the size and the alignment alone."""
    code = _bind().avt_median_mask_variant(pred.data_ptr(), out.data_ptr(),
                                           pred.shape[1] * pred.shape[2])
    return VARIANTS[code]


def median_mask_cuda(pred: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the CUDA kernel: (B, H, W) non-negative finite float32 on the
    card -> (B, H, W) {0,1} float32.  Launches on the current stream and
    does not synchronise.  Raises on anything the kernel does not take and
    on a refused launch; it never takes another implementation."""
    if not pred.is_cuda:
        raise ValueError(f"median_mask_cuda needs a CUDA tensor, got {pred.device}")
    if pred.dtype != torch.float32:
        raise TypeError(f"maps must be float32, got {pred.dtype}")
    if pred.ndim != 3:
        raise ValueError(f"expected (B, H, W), got {tuple(pred.shape)}")
    if not pred.is_contiguous():
        raise ValueError("maps must be contiguous")
    b, h, w = pred.shape
    n = h * w
    if not 0 <= k < n:
        raise ValueError(f"k={k} outside [0, {n})")
    if n >= 2 ** 31:
        raise ValueError(f"map of {n} elements exceeds the kernel's int32 index")
    if b >= 2 ** 28:
        raise ValueError(f"batch {b} exceeds the kernel's grid (8 blocks a map)")
    out = torch.empty_like(pred)
    if b == 0:
        return out
    err = _bind().avt_median_mask(
        pred.data_ptr(), out.data_ptr(), b, n, int(k), pred.device.index,
        torch.cuda.current_stream(pred.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"avt_median_mask launch failed: CUDA error {err}")
    median_mask_cuda.launches += 1
    return out


#: launches of the CUDA kernel by this process (a plain int; the smoke
#: script sets it to 0 before the served requests and reads it after)
median_mask_cuda.launches = 0


def median_mask(pred: torch.Tensor, k: int, impl: str = "kernel") -> torch.Tensor:
    """(B, H, W) -> {0,1} mask above the exact k-th smallest per map.

    impl: 'kernel' — the CUDA kernel when `pred` is on the card (or an
          error), the plain version only because `pred` lies on the CPU;
          'plain' — the bisection as tensor operations, on any device;
          'sort' — the reference oracle, kept for tests.
    """
    if impl == "sort":
        return median_mask_sort(pred, k)
    if impl == "plain" or (impl == "kernel" and not pred.is_cuda):
        return median_mask_plain(pred, k)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel', 'plain' or 'sort', got {impl!r}")
    return median_mask_cuda(pred.contiguous(), k)
