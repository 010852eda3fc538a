"""`ops/temporal_attention.py` and `models/timesformer.py::attend` on the CPU.

The temporal-attention kernels run only on the card (their tests are in
`test_torch_port_temporal_attention_card.py`).  Here: the plain version
against `scaled_dot_product_attention`; the backward's algorithm as the
kernel runs it (p from the forward's log-sum-exp, the row term from p and
dp, no o) against autograd; `attend`, which now takes and returns (S, L, D),
bit-equal to the view, transpose, SDPA and reshape it replaced, for the
temporal and the spatial lengths; the rule that sends a call to the kernels;
and the launchers refusing what the kernels do not take, before any build."""

import pytest
import torch
import torch.nn.functional as F

from avtubes_torch.models import timesformer
from avtubes_torch.ops import temporal_attention as ops

torch.set_num_threads(2)
HEADS, DH = 12, 64
D = HEADS * DH
#: float32 / float64 against SDPA: the same sums in another order, so a few
#: units of the format's last place of the largest entry
PLAIN_ATOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _tensors(seqs, n, dtype, seed, count=3):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(seqs, n, D, generator=g) * 1.5).to(dtype) for _ in range(count)]


def _heads(t):
    s, n, _ = t.shape
    return t.view(s, n, HEADS, DH).transpose(1, 2)


def _close(got, want, atol_of_max, what):
    got, want = got.detach(), want.detach()
    err = float((got - want).abs().max())
    assert err <= atol_of_max * float(want.abs().max()), (what, err)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_the_plain_version_is_sdpa_forward_and_backward(dtype, n):
    q, k, v, dout = _tensors(300, n, dtype, seed=n, count=4)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    got = ops.temporal_attention_plain(q, k, v, HEADS)
    got_grads = torch.autograd.grad(got, leaves, dout)
    want = F.scaled_dot_product_attention(_heads(q), _heads(k), _heads(v))
    want = want.transpose(1, 2).reshape(q.shape)
    want_grads = torch.autograd.grad(want, leaves, dout)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, PLAIN_ATOL[dtype], "o")
    for name, g, w in zip("qkv", got_grads, want_grads):
        _close(g, w, PLAIN_ATOL[dtype], f"d{name}")


@pytest.mark.parametrize("n", [5, 16])
def test_the_kernels_backward_algorithm_is_the_gradient(n):
    """What `csrc/temporal_attention.cu` computes, in float64 PyTorch: p
    recomputed as exp(s / 8 - lse) from the forward's log-sum-exp, the row
    term rowsum(p * dp) in place of rowsum(dO * o), ds = p (dp - D) / 8,
    dv = p^T dO, dk = ds^T q, dq = ds k."""
    q, k, v, dout = _tensors(40, n, torch.float64, seed=7 + n, count=4)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.temporal_attention_plain(q, k, v, HEADS), leaves, dout)
    qh, kh, vh, doh = (_heads(t.detach()) for t in (q, k, v, dout))
    scores = qh @ kh.transpose(-1, -2)
    lse = torch.logsumexp(scores / 8, dim=-1, keepdim=True)
    p = torch.exp(scores / 8 - lse)
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) / 8
    got = [(ds @ kh), (ds.transpose(-1, -2) @ qh), (p.transpose(-1, -2) @ doh)]
    for name, g, w in zip("qkv", got, want):
        _close(g.transpose(1, 2).reshape(w.shape), w, 1e-12, f"d{name}")


def _parent_attention(attn, x):
    """`Attention.forward` as it was: the head view and transpose of each
    product, SDPA, the transpose back and a reshape."""
    s, n, d = x.shape
    w, b = attn.qkv.weight.to(x.dtype), attn.qkv.bias.to(x.dtype)
    q, k, v = (F.linear(x, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
               .view(s, n, attn.heads, d // attn.heads).transpose(1, 2) for i in range(3))
    o = F.scaled_dot_product_attention(q, k, v)
    return timesformer._linear(o.transpose(1, 2).reshape(s, n, d), attn.proj)


@pytest.mark.parametrize("n, seqs", [(16, 40), (197, 6)], ids=["temporal_16", "spatial_197"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_attend_is_the_parent_s_path_bit_for_bit_on_the_cpu(dtype, n, seqs):
    torch.manual_seed(n)
    attn = timesformer.Attention(D, HEADS)
    for p in attn.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    (x,) = _tensors(seqs, n, dtype, seed=3, count=1)
    dy = _tensors(seqs, n, dtype, seed=4, count=1)[0]
    results = []
    for forward in (attn, lambda t: _parent_attention(attn, t)):
        xi = x.clone().requires_grad_()
        y = forward(xi)
        grads = torch.autograd.grad(y, [xi, *attn.parameters()], dy)
        results.append((y, grads))
    (y, grads), (y0, grads0) = results
    assert torch.equal(y, y0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)


# (device, dtype, shape (S, heads, L, dh)): the cases the kernels take, then
# each property changed alone
TAKEN = {"temporal_16": ("cuda", torch.bfloat16, (3920, 12, 16, 64)),
         "len_1": ("cuda", torch.bfloat16, (8, 12, 1, 64)),
         "len_8_heads_3": ("cuda:0", torch.bfloat16, (8, 3, 8, 64))}
NOT_TAKEN = {"spatial_197": {"shape": (320, 12, 197, 64)},
             "len_17": {"shape": (3920, 12, 17, 64)},
             "float32": {"dtype": torch.float32},
             "float16": {"dtype": torch.float16},
             "cpu": {"device": "cpu"},
             "dh_32": {"shape": (3920, 24, 16, 32)},
             "dh_128": {"shape": (3920, 6, 16, 128)},
             "three_dims": {"shape": (3920, 16, 768)}}


@pytest.mark.parametrize("case", [*TAKEN, *NOT_TAKEN])
def test_the_kernels_engage_on_bf16_cuda_heads_of_64_up_to_16_tokens(case):
    args = dict(zip(("device", "dtype", "shape"), TAKEN.get(case, TAKEN["temporal_16"])))
    args.update(NOT_TAKEN.get(case, {}))
    assert ops.temporal_attention_engages(**args) == (case in TAKEN)


def _no_library(name):
    raise AssertionError(f"a CPU call bound the kernel {name}")


REFUSED = {"cpu_tensors": {}, "float32": {"dtype": torch.float32},
           "len_17": {"n": 17}, "width_not_heads_x_64": {"heads": 11},
           "k_of_another_shape": {"k_seqs": 3}}


@pytest.mark.parametrize("launcher", ["forward", "backward"])
@pytest.mark.parametrize("case", REFUSED)
def test_the_cuda_launchers_refuse_what_the_kernels_do_not_take(monkeypatch, case, launcher):
    """Off the card (and on it, for a shape the kernels do not take) a
    launcher raises ValueError before it builds or binds a library."""
    monkeypatch.setattr(ops, "_bind", _no_library)
    c = {"dtype": torch.bfloat16, "n": 16, "heads": HEADS, "k_seqs": 4, **REFUSED[case]}
    q, v, dout = _tensors(4, c["n"], c["dtype"], seed=1)
    (k,) = _tensors(c["k_seqs"], c["n"], c["dtype"], seed=2, count=1)
    lse = torch.zeros(4, HEADS, c["n"])
    with pytest.raises(ValueError):
        if launcher == "forward":
            ops.temporal_attention_forward_cuda(q, k, v, c["heads"])
        else:
            ops.temporal_attention_backward_cuda(q, k, v, dout, lse, c["heads"])


def test_on_the_cpu_the_wrapper_is_the_plain_version_and_builds_nothing(monkeypatch):
    monkeypatch.setattr(ops, "_bind", _no_library)
    q, k, v = _tensors(30, 16, torch.bfloat16, seed=5)
    got = ops.temporal_attention(q, k, v, HEADS)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ops.temporal_attention_plain(q, k, v, HEADS))
