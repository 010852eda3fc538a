"""Attention over short sequences (TimeSformer's 16 frames), heads of 64:
the CUDA kernels, the plain version, the wrapper.

Replaces no TPU kernel: the JAX package has no TimeSformer.  On the H100
PyTorch ran this attention as its memory-efficient SDPA kernels, whose
64-row tiles a 16-token sequence fills a quarter of, at 4.8 times the
bytes' floor.  The kernels in `csrc/temporal_attention.cu`, written by hand
for sm_90a and bound through `ctypes`, compute

    o = softmax(q k^T / sqrt(64)) v       per head, over (S, L, D) tensors

forward in one launch and its three gradients in one more, q, k, v, o and
the gradients all token-major (S, L, D) with D = heads * 64, as the
products around the attention give and take them.  Scores, softmax and
sums are float32; p is rounded to bf16 for p v, o once at the end; the
float32 log-sum-exp of each row (S, heads, L) is kept for the backward
(the note at the head of the source).

`temporal_attention_plain` is the function in plain PyTorch with a float32
softmax.  `temporal_attention` takes it only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernels or raises.
`temporal_attention_engages` is the rule by which `models/timesformer.py::
attend` sends a call here at all.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: a head's width, the only one the kernels take
HEAD_DIM = 64
#: the longest sequence the kernels take: one 16-row tile a head
MAX_LEN = 16


def temporal_attention_engages(device: torch.device | str, dtype: torch.dtype,
                               shape: tuple[int, ...]) -> bool:
    """Whether attention over q of this `device`, `dtype` and `shape` (S,
    heads, L, dh) runs on the kernels: CUDA, bf16, dh 64 and 1 <= L <= 16.
    Everything else (longer sequences, float32, the CPU) keeps PyTorch's
    `scaled_dot_product_attention`."""
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and len(shape) == 4 and shape[-1] == HEAD_DIM and 1 <= shape[-2] <= MAX_LEN)


def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v per head over (S, L, D) tensors, D =
    heads * dh, with the scores and the softmax in float32 (float64 for
    float64 input), the result in the input's dtype.  The CPU's path and
    the kernels' yardstick in the tests; no yardstick of speed."""
    s, n, d = q.shape
    work = torch.promote_types(q.dtype, torch.float32)
    qh, kh, vh = (t.view(s, n, heads, d // heads).transpose(1, 2).to(work) for t in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-1, -2) * (d // heads) ** -0.5, dim=-1)
    return (p @ vh).transpose(1, 2).reshape(s, n, d).to(q.dtype)


def _bind(name: str):
    """The library's `avt_ta_<name>`, its arguments declared (`_SIGNATURES`)."""
    from avtubes_torch.ops._build import load_library

    fn = getattr(load_library("temporal_attention"), f"avt_ta_{name}")
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, o, lse, seqs, len, heads, sms, device, stream
    "forward": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, dq, dk, dv, seqs, len, heads, sms, device, stream
    "backward": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"avt_ta_{name} launch failed: CUDA error {err}")


def _taken(t: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype, what: str) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this `shape` and
    `dtype` on a 16-byte boundary."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected a {dtype} CUDA tensor of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous on a 16-byte boundary")


def _inputs_taken(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> None:
    """Raise unless q, k and v are bf16 (S, L, heads * 64) CUDA tensors
    the kernels take, all on q's device."""
    if q.ndim != 3 or heads < 1 or q.shape[-1] != heads * HEAD_DIM:
        raise ValueError(f"expected (S, L, {heads} * {HEAD_DIM}), got {tuple(q.shape)}")
    if not 1 <= q.shape[1] <= MAX_LEN:
        raise ValueError(f"the kernels take 1 to {MAX_LEN} tokens, got {q.shape[1]}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _taken(t, q.shape, torch.bfloat16, what)
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, q on {q.device}")


def temporal_attention_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch: o (S, L, D) bf16 and the float32 log-sum-exp of each
    row's scaled scores, (S, heads, L)."""
    _inputs_taken(q, k, v, heads)
    s, n, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((s, heads, n), dtype=torch.float32, device=q.device)
    _check(_bind("forward")(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            lse.data_ptr(), s, n, heads, _sms(q.device), q.device.index,
                            torch.cuda.current_stream(q.device).cuda_stream), "forward")
    temporal_attention_forward_cuda.launches += 1
    return o, lse


def temporal_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     dout: torch.Tensor, lse: torch.Tensor, heads: int
                                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch: dq, dk, dv (S, L, D) bf16 from the forward's inputs, the
    output's gradient and the forward's log-sum-exp."""
    _inputs_taken(q, k, v, heads)
    s, n, _ = q.shape
    for t, shape, dtype, what in ((dout, q.shape, torch.bfloat16, "dout"),
                                  (lse, (s, heads, n), torch.float32, "lse")):
        _taken(t, shape, dtype, what)
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, q on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _check(_bind("backward")(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                             lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), s, n,
                             heads, _sms(q.device), q.device.index,
                             torch.cuda.current_stream(q.device).cuda_stream), "backward")
    temporal_attention_backward_cuda.launches += 1
    return dq, dk, dv


#: launches of each kernel by this process (plain ints; the card tests set
#: them to 0 before a step and read them after)
temporal_attention_forward_cuda.launches = 0
temporal_attention_backward_cuda.launches = 0


class TemporalAttention(torch.autograd.Function):
    """`temporal_attention_plain` on the kernels, forward and backward.  Keeps
    q, k, v and the log-sum-exp for the backward, which needs no o."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        o, lse = temporal_attention_forward_cuda(q, k, v, heads)
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, lse)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        if not dout.is_contiguous() or dout.data_ptr() % 16:
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = temporal_attention_backward_cuda(q, k, v, dout, lse, ctx.heads)
        return dq, dk, dv, None


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """softmax(q k^T / 8) v per head over (S, L, D) tensors, D = heads * 64.

    A CPU tensor takes `temporal_attention_plain`.  A CUDA tensor takes the
    kernels, or raises where they do not take it: q, k and v bf16,
    contiguous, of one shape, heads of 64 and 1 <= L <= 16."""
    if not q.is_cuda:
        return temporal_attention_plain(q, k, v, heads)
    return TemporalAttention.apply(q, k, v, heads)
