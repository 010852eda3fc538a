"""Training-mode BatchNorm with its ReLU and residual add: the CUDA kernels,
the plain version, the wrapper.

Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which fuses
it with the ReLU and the add around it.  On the H100 PyTorch trains a bf16
`channels_last_3d` `nn.BatchNorm3d` on generic kernels (a TensorIterator
Welford reduction, an elementwise transform that cannot vectorise) and runs
the ReLU, the residual add and the ReLU's backward as passes of their own.
The kernels in `csrc/batchnorm.cu`, written by hand for sm_90a and bound
through `ctypes`, do the whole of

    y = relu(batch_norm(x) [+ residual])     (or without the relu)

in four launches a training step, two forward and two backward, each
reading every tensor once (the note at the head of the source).  The
statistics are float32 (float64 where the blocks' partials meet), the
running variance takes n/(n-1), the running statistics are updated in
place with the factor the caller passes (momentum, or 0 to leave them as
they are), and the output is rounded to bf16 once where PyTorch rounds
after the BatchNorm and again after the add.

`batchnorm_act_plain` is the function in plain PyTorch (`F.batch_norm`,
the add, `torch.relu`).  `batchnorm_act` takes it only for a tensor that
lies on the CPU; for a CUDA tensor it launches the kernels or raises.
`fused_batchnorm_engages` is the rule by which `models/norm.py::
BatchNorm3d` sends a call here at all.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

CL3D = torch.channels_last_3d
#: channels a thread of the kernels loads at once (16 bytes of bf16)
VEC = 8
#: the widths the kernels take: R3D-18's, each C / 8 lanes dividing a block
WIDTHS = (64, 128, 256, 512)
#: blocks a streaming multiprocessor holds of each kernel (`BLOCKS_PER_SM`
#: in the source, whose launch bounds keep them resident): the grid
BLOCKS_PER_SM = 4
#: threads a block (`NT` in the source)
THREADS = 256
#: the most blocks a launch takes (`GROUP * MAX_GROUPS` in the source)
MAX_GRID = 1008
#: the mask modes of the backward kernels
NO_RELU, RELU_FROM_X, RELU_FROM_Y = 0, 1, 2


def fused_batchnorm_engages(device: torch.device | str, dtype: torch.dtype,
                            shape: tuple[int, ...], channels_last: bool, training: bool,
                            grouped: bool) -> bool:
    """Whether a BatchNorm call on an input of this `device`, `dtype`,
    `shape` and layout (`channels_last`: `channels_last_3d`-contiguous) runs
    on the kernels: CUDA, bf16, 5-D, channels-last, 64, 128, 256 or 512
    channels (R3D-18's), in training mode, and with no process group up
    (the group path is `models/norm.py::_GlobalBatchNorm`).  Everything
    else keeps PyTorch's BatchNorm."""
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and len(shape) == 5 and channels_last and training and not grouped
            and shape[1] in WIDTHS)


def batchnorm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        running_mean: torch.Tensor | None, running_var: torch.Tensor | None,
                        momentum: float, eps: float, residual: torch.Tensor | None = None,
                        relu: bool = False) -> torch.Tensor:
    """The function in plain PyTorch, in training mode: `F.batch_norm` with
    the batch's statistics (running statistics advanced by `momentum`), then
    `+ residual`, then the ReLU.  The CPU's path and the kernels' yardstick
    in the tests; no yardstick of speed."""
    y = F.batch_norm(x, running_mean, running_var, weight, bias, True, momentum, eps)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _bind(name: str):
    """The library's `avt_bn_<name>`, its arguments declared (`_SIGNATURES`)."""
    from avtubes_torch.ops._build import load_library

    fn = getattr(load_library("batchnorm"), f"avt_bn_{name}")
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, rows, channels, grid, part, gpart, counters, mean, invstd, running_mean,
    # running_var, momentum, eps, device, stream
    "stats": [_P, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _P],
    # x, residual, y, rows, channels, grid, relu, mean, invstd, weight, bias, device, stream
    "apply": [_P, _P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    # dy, x, y, g, rows, channels, grid, mask, mean, invstd, weight, bias, part, gpart,
    # counters, grad_weight, grad_bias, device, stream
    "backward_reduce": [_P, _P, _P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _P],
    # g, x, dx, rows, channels, grid, mask, mean, invstd, weight, bias, grad_weight,
    # grad_bias, device, stream
    "backward_elemt": [_P, _P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P],
}

#: per (device index, stream): the kernels' 64 integer tickets, zero between
#: launches (each launch leaves them so); launches on one stream never overlap
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"avt_bn_{name} launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _Launch:
    """What every kernel of one BatchNorm call shares: the (rows, C) view,
    the grid, the stream and, for the two reductions, the partials'
    scratch and the tickets."""

    def __init__(self, x: torch.Tensor):
        self.device = x.device
        self.channels = x.shape[1]
        self.rows = x.numel() // self.channels
        rows_a_pass = THREADS // (self.channels // VEC)
        self.grid = max(1, min(-(-self.rows // rows_a_pass), BLOCKS_PER_SM * _sms(x.device),
                               MAX_GRID))
        self.stream = torch.cuda.current_stream(x.device).cuda_stream

    def scratch(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        key = (self.device.index, self.stream)
        counters = _counters.get(key)
        if counters is None:
            counters = _counters[key] = torch.zeros(64, dtype=torch.int32, device=self.device)
        # a partial a block, and room for as many groups' (fewer)
        part = torch.empty((self.grid, 2, self.channels), dtype=torch.float32,
                           device=self.device)
        gpart = torch.empty_like(part, dtype=torch.float64)
        return part, gpart, counters


def _taken(t: torch.Tensor, like: torch.Tensor, what: str) -> None:
    """Raise unless `t` is a bf16 CUDA tensor of `like`'s shape,
    `channels_last_3d`-contiguous, on a 16-byte boundary."""
    if not t.is_cuda or t.dtype != torch.bfloat16 or t.shape != like.shape:
        raise ValueError(f"{what}: expected a bf16 CUDA tensor of shape {tuple(like.shape)}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous(memory_format=CL3D) or t.data_ptr() % 16:
        raise ValueError(f"{what} must be channels_last_3d-contiguous on a 16-byte boundary")


def _vector(t: torch.Tensor | None, c: int, what: str) -> None:
    if t is not None and (t.dtype != torch.float32 or t.shape != (c,) or not t.is_cuda
                          or not t.is_contiguous()):
        raise ValueError(f"{what}: expected a contiguous float32 CUDA vector of {c}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def bn_stats_cuda(x: torch.Tensor, running_mean: torch.Tensor | None,
                  running_var: torch.Tensor | None, momentum: float, eps: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch: the float32 mean and invstd of each channel of `x`, the
    running statistics advanced in place by `momentum` (the variance's with
    n/(n-1)), where given."""
    run = _Launch(x)
    if run.rows < 2:
        raise ValueError(f"BatchNorm needs more than one value a channel, got {run.rows}")
    part, gpart, counters = run.scratch()
    mean = torch.empty(run.channels, dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    _check(_bind("stats")(x.data_ptr(), run.rows, run.channels, run.grid, part.data_ptr(),
                             gpart.data_ptr(), counters.data_ptr(), mean.data_ptr(),
                             invstd.data_ptr(), _ptr(running_mean), _ptr(running_var),
                             float(momentum), float(eps), x.device.index, run.stream), "stats")
    bn_stats_cuda.launches += 1
    return mean, invstd


def bn_apply_cuda(x: torch.Tensor, residual: torch.Tensor | None, relu: bool,
                  mean: torch.Tensor, invstd: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """One launch: relu((x - mean) * invstd * weight + bias [+ residual])
    (or without the relu), rounded once to bf16, `channels_last_3d`."""
    run = _Launch(x)
    y = torch.empty_like(x, memory_format=CL3D)
    _check(_bind("apply")(x.data_ptr(), _ptr(residual), y.data_ptr(), run.rows,
                             run.channels, run.grid, int(relu), mean.data_ptr(),
                             invstd.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                             x.device.index, run.stream), "apply")
    bn_apply_cuda.launches += 1
    return y


def bn_backward_reduce_cuda(dy: torch.Tensor, x: torch.Tensor, y: torch.Tensor | None,
                            mask: int, mean: torch.Tensor, invstd: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor
                            ) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """One launch: with g = dy masked by the ReLU (`mask`: NO_RELU,
    RELU_FROM_X recomputed from x, RELU_FROM_Y read from the output `y`),
    the weight's gradient sum g * x^ and the bias' sum g; with RELU_FROM_Y
    also g itself (the residual's gradient), else None."""
    run = _Launch(x)
    part, gpart, counters = run.scratch()
    g = torch.empty_like(dy, memory_format=CL3D) if mask == RELU_FROM_Y else None
    grad_weight = torch.empty(run.channels, dtype=torch.float32, device=x.device)
    grad_bias = torch.empty_like(grad_weight)
    _check(_bind("backward_reduce")(
        dy.data_ptr(), x.data_ptr(), _ptr(y), _ptr(g), run.rows, run.channels, run.grid, mask,
        mean.data_ptr(), invstd.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        part.data_ptr(), gpart.data_ptr(), counters.data_ptr(), grad_weight.data_ptr(),
        grad_bias.data_ptr(), x.device.index, run.stream), "backward_reduce")
    bn_backward_reduce_cuda.launches += 1
    return g, grad_weight, grad_bias


def bn_backward_elemt_cuda(g: torch.Tensor, x: torch.Tensor, mask: int, mean: torch.Tensor,
                           invstd: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           grad_weight: torch.Tensor, grad_bias: torch.Tensor) -> torch.Tensor:
    """One launch: dx = weight * invstd * (g - sum g / n - x^ * sum g x^ / n),
    g = `g` masked by the ReLU recomputed from x where `mask` is RELU_FROM_X
    (as given otherwise: dy, or the reduce's g)."""
    run = _Launch(x)
    dx = torch.empty_like(x, memory_format=CL3D)
    _check(_bind("backward_elemt")(
        g.data_ptr(), x.data_ptr(), dx.data_ptr(), run.rows, run.channels, run.grid, mask,
        mean.data_ptr(), invstd.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        grad_weight.data_ptr(), grad_bias.data_ptr(), x.device.index, run.stream),
        "backward_elemt")
    bn_backward_elemt_cuda.launches += 1
    return dx


#: launches of each kernel by this process (plain ints; the card tests set
#: them to 0 before a step and read them after).  `dy_copies` counts the
#: backward calls whose incoming gradient had to be made channels-last first.
bn_stats_cuda.launches = 0
bn_apply_cuda.launches = 0
bn_backward_reduce_cuda.launches = 0
bn_backward_elemt_cuda.launches = 0


class BatchNormAct(torch.autograd.Function):
    """`batchnorm_act_plain` on the kernels, forward and backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var, momentum, eps,
                relu):
        mean, invstd = bn_stats_cuda(x, running_mean, running_var, momentum, eps)
        y = bn_apply_cuda(x, residual, relu, mean, invstd, weight, bias)
        ctx.mask = (RELU_FROM_Y if relu and residual is not None
                    else RELU_FROM_X if relu else NO_RELU)
        ctx.has_residual = residual is not None
        ctx.save_for_backward(x, weight, bias, mean, invstd,
                              y if ctx.mask == RELU_FROM_Y else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, invstd, y = ctx.saved_tensors
        if not dy.is_contiguous(memory_format=CL3D) or dy.data_ptr() % 16:
            dy = dy.clone(memory_format=CL3D)
            BatchNormAct.dy_copies += 1
        g, grad_weight, grad_bias = bn_backward_reduce_cuda(dy, x, y, ctx.mask, mean, invstd,
                                                            weight, bias)
        dx = bn_backward_elemt_cuda(dy if g is None else g, x, ctx.mask, mean, invstd,
                                    weight, bias, grad_weight, grad_bias)
        grad_residual = (dy if g is None else g) if ctx.has_residual else None
        return dx, grad_weight, grad_bias, grad_residual, None, None, None, None, None


BatchNormAct.dy_copies = 0


def batchnorm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  running_mean: torch.Tensor | None, running_var: torch.Tensor | None,
                  momentum: float, eps: float, residual: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """relu(batch_norm(x) [+ residual]) (or without the relu) in training
    mode, the running statistics advanced by `momentum` in place.

    A CPU tensor takes `batchnorm_act_plain`.  A CUDA tensor takes the
    kernels, or raises where they do not take it: bf16 (N, C, T, H, W) in
    `channels_last_3d` with C one of `WIDTHS`, a residual alike,
    float32 weight, bias and statistics."""
    if not x.is_cuda:
        return batchnorm_act_plain(x, weight, bias, running_mean, running_var, momentum, eps,
                                   residual, relu)
    if x.ndim != 5:
        raise ValueError(f"expected (N, C, T, H, W), got {tuple(x.shape)}")
    _taken(x, x, "input")
    c = x.shape[1]
    if c not in WIDTHS:
        raise ValueError(f"the kernels take {WIDTHS} channels, got {c}")
    if residual is not None:
        _taken(residual, x, "residual")
    if weight is None or bias is None:
        raise ValueError("the kernels need the BatchNorm's weight and bias")
    for t, what in ((weight, "weight"), (bias, "bias"), (running_mean, "running_mean"),
                    (running_var, "running_var")):
        _vector(t, c, what)
    return BatchNormAct.apply(x, weight, bias, residual, running_mean, running_var,
                              float(momentum), float(eps), bool(relu))
