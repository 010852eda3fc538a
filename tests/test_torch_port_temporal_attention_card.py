"""The temporal-attention kernels (`ops/temporal_attention.py`,
`csrc/temporal_attention.cu`) on the card, against the plain version in
float32 on the same bf16 inputs.  Needs a CUDA card and skips without one.
This file imports no JAX, so it runs on a machine that has none:
`python -m pytest --noconftest tests/test_torch_port_temporal_attention_card.py`
(the tests' `conftest.py` sets JAX up).

Tolerances, each from where the kernels round to bf16, whose unit roundoff
u = 2^-8 bounds one rounding's relative error; 1 % room on top covers the
second-order term (u^2) and the float32 arithmetic (~1e-6 relative, the
reference's own error too):
  o    p v with p rounded (u of each term p_j |v_j|), then o rounded once
       (u of |o|): within 1.01 u (p |v| + |o|);
  dv   p^T dO with p rounded: within 1.01 u (p^T |dO| + |dv|);
  dq   ds k / 8 with ds = p (dp - D) rounded, after float32 sums whose error
       scales with p (|dp| + |D|) and not with the difference: within
       1.01 u (p (|dp| + |D|) |k| / 8 + |dq|); dk the same with q;
  lse  float32 exp2 and log2 of float32 scores: within 1e-5 + 1e-6 |lse|.
On an H100 the largest error at the recipe shape read 0.87-0.92 of the
bound without the room."""

import pytest
import torch

from avtubes_torch.ops import temporal_attention as ops

#: the recipe: 20 clips x 196 patches, 16 frames, 12 heads of 64
RECIPE = (3920, 16, 768)
HEADS = 12
#: bf16's unit roundoff, and the room on top of it (module docstring)
ROUND, ROOM = 2.0 ** -8, 1.01


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(card, shape, seed):
    gen = torch.Generator(card).manual_seed(seed)
    return [(torch.randn(shape, device=card, generator=gen) * 1.5).to(torch.bfloat16)
            for _ in range(4)]


def _kernels(q, k, v, dout, heads):
    o, lse = ops.temporal_attention_forward_cuda(q, k, v, heads)
    dq, dk, dv = ops.temporal_attention_backward_cuda(q, k, v, dout, lse, heads)
    return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def _reference(q, k, v, dout, heads):
    """The plain version in float32 (autograd for the gradients), its
    log-sum-exp, and the magnitudes of the terms each result sums."""
    s, n, d = q.shape
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o = ops.temporal_attention_plain(*leaves, heads)
    dq, dk, dv = torch.autograd.grad(o, leaves, dout.float())
    qh, kh, vh, doh = (t.float().view(s, n, heads, d // heads).transpose(1, 2)
                       for t in (q, k, v, dout))
    scores = qh @ kh.transpose(-1, -2) / 8
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.softmax(scores, dim=-1)
    dp = doh @ vh.transpose(-1, -2)
    row = (p * dp).sum(-1, keepdim=True)
    spread = p * (dp.abs() + row.abs())

    def tokens(t):
        return t.transpose(1, 2).reshape(s, n, d)

    terms = {"o": tokens(p @ vh.abs()), "dv": tokens(p.transpose(-1, -2) @ doh.abs()),
             "dq": tokens(spread @ kh.abs() / 8),
             "dk": tokens(spread.transpose(-1, -2) @ qh.abs() / 8)}
    return {"o": o.detach(), "lse": lse, "dq": dq, "dk": dk, "dv": dv}, terms


def _check(got, want, terms):
    for name in ("o", "dq", "dk", "dv"):
        g, w = got[name], want[name]
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and g.is_contiguous(), name
        err = (g.float() - w).abs()
        bound = ROOM * ROUND * (terms[name] + w.abs())
        bad = err > bound
        assert not bool(bad.any()), (f"{name}: {int(bad.sum())} of {bad.numel()} values off, "
                                     f"worst {float((err / bound).max())} of the bound")
    err = (got["lse"] - want["lse"]).abs()
    assert float((err - 1e-6 * want["lse"].abs()).max()) <= 1e-5, float(err.max())


@pytest.mark.card
def test_the_kernels_are_the_plain_version_in_float32_at_the_recipe(card):
    q, k, v, dout = _inputs(card, RECIPE, seed=1)
    got = _kernels(q, k, v, dout, HEADS)
    want, terms = _reference(q, k, v, dout, HEADS)
    _check(got, want, terms)


@pytest.mark.card
@pytest.mark.parametrize("seqs, n, heads", [(300, 8, 12), (200, 1, 12), (500, 5, 3),
                                            (97, 16, 1), (64, 13, 7)])
def test_shorter_sequences_and_other_head_counts(card, seqs, n, heads):
    q, k, v, dout = _inputs(card, (seqs, n, heads * 64), seed=n + heads)
    got = _kernels(q, k, v, dout, heads)
    want, terms = _reference(q, k, v, dout, heads)
    _check(got, want, terms)


@pytest.mark.card
def test_two_runs_are_bit_equal(card):
    q, k, v, dout = _inputs(card, RECIPE, seed=2)
    first, second = _kernels(q, k, v, dout, HEADS), _kernels(q, k, v, dout, HEADS)
    for name, t in first.items():
        assert torch.equal(t, second[name]), name


def _counts():
    return (ops.temporal_attention_forward_cuda.launches,
            ops.temporal_attention_backward_cuda.launches)


def _timesformer_state(card, remat=False):
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.fullmodel import FullModel
    from avtubes_torch.train.state import create_train_state

    model = FullModel(generator=torch.Generator().manual_seed(0), compute_dtype="bfloat16",
                      remat=remat, video_arch="timesformer_b16", image_size=224, frames=16)
    return create_train_state(model.to(card), OptimConfig())


def _clips(card, b):
    gen = torch.Generator(card).manual_seed(11)
    video = torch.randn(b, 16, 224, 224, 3, device=card, generator=gen)
    spec = torch.randn(b, 257, 62, 1, device=card, generator=gen)
    return video, spec


@pytest.mark.card
def test_a_recipe_timesformer_step_launches_12_forward_and_12_backward(card):
    """20 clips x 16 frames at 224^2: each of the 12 blocks' temporal
    attention is one forward and one backward launch; the spatial one (197
    tokens) takes none."""
    from avtubes_torch.train.steps import train3d_step

    state = _timesformer_state(card)
    video, spec = _clips(card, 20)
    before = _counts()
    metrics = train3d_step(state, video, spec)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.as_tensor(float(metrics["loss"])))
    assert tuple(a - b for a, b in zip(_counts(), before)) == (12, 12)


@pytest.mark.card
def test_a_bf16_remat_timesformer_step_is_the_plain_step(card):
    """Under `--remat` the backward recomputes each block's forward, the
    kernels' among it (24 forward launches, 12 backward), and the kernels
    give the same bits each time.  So the loss is the plain step's and each
    gradient lies within what two plain steps differ by (the spatial
    attention's flash backward sums in another order from run to run) or
    within bf16's rounding step of the leaf's norm, whichever is larger."""
    from avtubes_torch.losses.losses import hardway_loss

    video, spec = _clips(card, 2)
    results = []
    for remat in (False, False, True):
        state = _timesformer_state(card, remat=remat)
        state.model.train()
        before = _counts()
        loss = hardway_loss(state.model.forward_shared_audio(spec, video).logits)
        loss.backward()
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(_counts(), before))
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
                 if p.grad is not None}
        results.append((float(loss.detach()), grads, launches))
        del state
    (loss, grads, launches), (_, grads2, _), (rloss, rgrads, rlaunches) = results
    assert launches == (12, 12) and rlaunches == (24, 12)
    assert rloss == loss
    assert rgrads.keys() == grads.keys()
    for name, g in grads.items():
        spread = float(torch.linalg.vector_norm((grads2[name] - g).float()))
        gap = float(torch.linalg.vector_norm((rgrads[name] - g).float()))
        assert gap <= max(2 * spread, ROUND * float(torch.linalg.vector_norm(g.float()))), name


@pytest.mark.card
def test_the_flagship_and_tube_steps_launch_none(card):
    """Neither builds a TimeSformer, so neither reaches the kernels."""
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.avenet import AVENet
    from avtubes_torch.models.fullmodel import FullModel
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import train3d_step

    before = _counts()
    model = FullModel(generator=torch.Generator().manual_seed(0), compute_dtype="bfloat16",
                      image_size=112, frames=4)
    state = create_train_state(model.to(card), OptimConfig())
    gen = torch.Generator(card).manual_seed(5)
    train3d_step(state, torch.randn(2, 4, 112, 112, 3, device=card, generator=gen),
                 torch.randn(2, 257, 62, 1, device=card, generator=gen))
    del state
    model = AVENet(generator=torch.Generator().manual_seed(0), compute_dtype="bfloat16")
    model.to(card).train()
    out = model(torch.randn(4, 112, 112, 3, device=card, generator=gen),
                torch.randn(4, 257, 62, 1, device=card, generator=gen))
    out.logits.float().sum().backward()
    torch.cuda.synchronize()
    assert _counts() == before
