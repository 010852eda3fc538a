"""How the reference computes its convolutions and matrix products.

`Arith()` is plain float32.  `Arith(precision="fp8")` is the step below a
bfloat16 backbone, the lower-precision control of the training cells:
where the program keeps a backbone tensor in bfloat16, the control keeps it
in float8.  The backbones compute in bfloat16 (`dtype`), and every tensor a
backbone stores (each convolution's input, weight and output, each
normalisation, activation, pooling and residual sum) is rounded to float8
e4m3 (one scale a tensor, its largest magnitude at 448), and its gradient
in the backward pass to float8 e5m2.  Products accumulate in float32.
`Arith(count=True)` adds up the FLOPs of every convolution and product it is
asked for, at 2 FLOPs a multiply-add; run on meta tensors it counts without
computing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "fp8")
#: the largest finite float8 e4m3 value
E4M3_MAX = 448.0


#: the largest finite float8 e5m2 value
E5M2_MAX = 57344.0


def round_fp8(x: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """`x` rounded to a float8 `dtype` at one scale for the tensor, back in
    `x`'s dtype."""
    scale = x.abs().amax().float().clamp_min(1e-30) / largest
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


def fake_e4m3(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3; the gradient passes through unchanged."""
    return x + (round_fp8(x.detach(), torch.float8_e4m3fn, E4M3_MAX) - x.detach())


class _StoreFP8(torch.autograd.Function):
    """A tensor stored in float8: e4m3 forward, its gradient e5m2."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2, E5M2_MAX)


def exact_float32() -> None:
    """Float32 products and convolutions in full float32 on the card (TF32
    off), as the reference computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Arith:
    def __init__(self, precision: str = "float32", count: bool = False):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision
        self.count = count
        self.flops = 0
        #: the backbones' compute dtype
        self.dtype = torch.bfloat16 if precision == "fp8" else torch.float32

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """A backbone tensor as this precision keeps it."""
        if self.precision == "fp8" and x.device.type != "meta":
            return _StoreFP8.apply(x)
        return x

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
        """A 2-D or 3-D convolution without bias (NC... layout), in the
        input's dtype, its output stored."""
        conv = F.conv2d if w.ndim == 4 else F.conv3d
        w = w.to(x.dtype)
        if self.precision == "fp8" and x.device.type != "meta":
            w = fake_e4m3(w)
        y = self.store(conv(self.store(x), w, stride=stride, padding=padding))
        if self.count:
            cout, cin = w.shape[:2]
            self.flops += 2 * y.shape[0] * cout * math.prod(y.shape[2:]) * cin * math.prod(
                w.shape[2:])
        return y

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """`a @ b` (batched over leading axes), in float32 always: the head
        runs in float32 whatever the backbones' precision."""
        y = torch.matmul(a, b)
        if self.count:
            self.flops += 2 * math.prod(y.shape) * a.shape[-1]
        return y
