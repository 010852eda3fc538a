"""Int8 inference convolution: per-channel weights, per-sample activations.

The arithmetic of `avtubes/models/resnet2d.py::QuantConv.__call__`
(:118-141), in the same order of operations, so that on the CPU one
convolution is bit-equal to the JAX package's:

  weight      sw = max(max |W| over (kh, kw, Cin), 1e-12) / 127, one scale
              an output channel; wq = round(W / sw) as int8 (a division, not
              a product with the reciprocal of sw)
  activation  x cast to float32; sx = max(max |x| over (H, W, C), 1e-12) /
              127, one scale a SAMPLE; xq = round(x / sx) as int8
  product     int8 x int8 -> int32, zero padding (exact: 0 quantizes to 0)
  rescale     y as float32 * (sx * sw), the product of the scales formed
              first, then cast to the compute dtype

The activation scale never crosses the batch axis: the server coalesces
unrelated requests into one batch and zero-pads it to a bucket, so a scale
over the whole batch would make each answer depend on its neighbours.
Rounding is half to even in both frameworks.  "/ 127" is a product with
float32(1 / 127): XLA's simplifier compiles the JAX package's division by
the constant 127 into that product (one ulp apart from a true division for
about 5 % of float32 values), and the JAX package runs its models compiled.

The product is an im2col of the NHWC int8 activation (the backbones'
channels-last storage is NHWC already) times the packed weight, through
`torch._int_mm` (M x K int8 @ K x O int8 -> int32): cuBLASLt's int8
tensor-core GEMM on the card, a plain integer product on the CPU.  The JAX
package leaves this product to XLA's convolution, outside any Pallas
kernel, so no TPU kernel is replaced here.  cuBLASLt's int8 GEMM wants more
than 16 rows and K and O multiples of 8 (`_int_mm` raises on any other
shape on the card), and takes its second operand column-major at every
shape (row-major it refuses some): the packed weight is (O, K) row-major,
passed transposed.  K is zero-padded to a multiple of
8 (the vision stem's 7*7*3 = 147 to 152, the audio stem's 49 to 56) and M
to at least 17 rows, on every device, so the CPU runs the code the card
runs.  Nothing falls back to a float convolution.

`int8_conv2d_plain` is the same product in float64 by `F.conv2d`: exact,
since |sum| <= K * 127^2 <= 4608 * 127^2 < 2^53.  The tests and
`chip_smoke.py` hold the product against it; nothing on the served path
calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: 1 / the activation and weight levels (symmetric, +-127), in float32, as
#: XLA folds the JAX package's "/ 127.0"
INV_LEVELS = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
#: a scale's floor (an all-zero sample or channel): the JAX package's 1e-12
SCALE_FLOOR = 1e-12
#: cuBLASLt's int8 GEMM: rows > 16; K and the output width multiples of 8
MIN_ROWS = 17
K_MULTIPLE = 8


def padded_k(k: int) -> int:
    """K rounded up to a multiple of 8."""
    return -(-k // K_MULTIPLE) * K_MULTIPLE


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(O, C, kh, kw) float weight -> (wq (O, C, kh, kw) int8, wq packed
    (O, Kp) int8 with K in (kh, kw, C) order and zero columns up to Kp,
    sw (O,) float32)."""
    w = w.float()
    sw = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), SCALE_FLOOR) * INV_LEVELS
    wq = torch.round(w / sw.view(-1, 1, 1, 1)).to(torch.int8)
    o = wq.shape[0]
    k = wq[0].numel()
    packed = wq.new_zeros((o, padded_k(k)))
    packed[:, :k] = wq.permute(0, 2, 3, 1).reshape(o, k)
    return wq, packed, sw


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) activation in any float dtype -> (xq (B, C, H, W) int8
    in `x`'s memory format, sx (B,) float32)."""
    x = x.float()
    sx = torch.clamp_min(x.abs().amax(dim=(1, 2, 3)), SCALE_FLOOR) * INV_LEVELS
    xq = torch.round(x / sx.view(-1, 1, 1, 1)).to(torch.int8)
    return xq, sx


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def im2col_nhwc(xq: torch.Tensor, kernel_size, stride, padding
                ) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """(B, C, H, W) int8 -> (the (M, Kp) int8 patch matrix, K in (kh, kw, C)
    order, zero-padded to M >= 17 rows and Kp columns; (B, Ho, Wo))."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
    b, c = xq.shape[:2]
    x = xq.permute(0, 2, 3, 1)                                   # NHWC
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    patches = x.unfold(1, kh, sh).unfold(2, kw, sw)              # (B, Ho, Wo, C, kh, kw)
    ho, wo = patches.shape[1:3]
    m, k = b * ho * wo, kh * kw * c
    kp = padded_k(k)
    if kp == k and m >= MIN_ROWS:
        return patches.permute(0, 1, 2, 4, 5, 3).reshape(m, k), (b, ho, wo)
    a = xq.new_zeros((max(m, MIN_ROWS), kp))
    a[:m, :k].view(b, ho, wo, kh, kw, c).copy_(patches.permute(0, 1, 2, 4, 5, 3))
    return a, (b, ho, wo)


def int8_conv2d(xq: torch.Tensor, w_packed: torch.Tensor, kernel_size, stride, padding
                ) -> torch.Tensor:
    """The int32 product: (B, C, H, W) int8 activation, (O, Kp) packed int8
    weight -> (B, Ho, Wo, O) int32, by im2col and `torch._int_mm`."""
    a, (b, ho, wo) = im2col_nhwc(xq, kernel_size, stride, padding)
    if a.shape[1] != w_packed.shape[1]:
        raise ValueError(f"patch width {a.shape[1]} != packed weight width {w_packed.shape[1]}")
    y = torch._int_mm(a, w_packed.t())
    return y[: b * ho * wo].view(b, ho, wo, -1)


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, stride, padding) -> torch.Tensor:
    """The same product in float64 by `F.conv2d` (exact): (B, C, H, W) int8,
    (O, C, kh, kw) int8 -> (B, Ho, Wo, O) int32."""
    y = F.conv2d(xq.double(), wq.double(), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def rescale(y: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    """(B, Ho, Wo, O) int32 -> (B, O, Ho, Wo) in `dtype`, a channels-last
    view: y * (sx * sw) in float32, then the cast."""
    scale = sx.view(-1, 1, 1, 1) * sw
    return (y.float() * scale).to(dtype).permute(0, 3, 1, 2)


def quant_conv2d(x: torch.Tensor, w_packed: torch.Tensor, sw: torch.Tensor,
                 kernel_size, stride, padding) -> torch.Tensor:
    """The whole int8 convolution of (B, C, H, W) `x`, returned in `x`'s
    dtype as a channels-last (B, O, Ho, Wo) view."""
    xq, sx = quantize_activation(x)
    return rescale(int8_conv2d(xq, w_packed, kernel_size, stride, padding), sx, sw, x.dtype)
