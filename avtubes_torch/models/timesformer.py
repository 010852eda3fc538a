"""TimeSformer-B/16 with divided space-time attention: a tube encoder for
FullModel (PyTorch).

Bertasius, Wang and Torresani, "Is Space-Time Attention All You Need for
Video Understanding?" (ICML 2021, arXiv:2102.05095); the equations of the
official `timesformer/models/vit.py` (`VisionTransformer`, `Block` with
`attention_type='divided_space_time'`), at its published widths: embedding
768, 12 blocks, 12 heads of 64, MLP 3,072 with exact GELU, patch 16, a
`qkv` bias, LayerNorm eps 1e-6.

With N = (H/16)(W/16) patches a frame the token stream is x = [cls; patch
tokens in (n t) order], (B, 1 + N T, D):

  embedding   each frame's 16x16/16 patches through one linear map (the
              3 -> 768 convolution as a product over 768-long patch vectors),
              cls prepended and `pos_embed` (1, N + 1, D) added per frame;
              the patch tokens as (B N, T, D) get `time_embed` (1, T, D);
  temporal    xt = x[:, 1:] as (B N, T, D);
              xt = x[:, 1:] + temporal_fc(TA(temporal_norm1(xt)));
  spatial     xs = [cls repeated T times; xt as (B T, N, D)], (B T, 1 + N, D);
              r = SA(norm1(xs)); x = [cls; xt] + [mean over T of r[:, 0]; r[:, 1:]];
  MLP         x = x + fc2(GELU(fc1(norm2(x))));
  attention   qkv with a bias, softmax(q k^T / 8) v over 12 heads, then proj;
  output      `norm` after the last block; the patch tokens out as
              (B, T, H/16, W/16, 768).

Departures from the official model: no dropout and no stochastic depth; the
classification head is dropped; with `proj_dim` a bias-free Linear `proj`
and a ReLU map the output to that width (FullModel's 512, the hard-way
head's). The ReLU makes the features non-negative, as both ResNet towers'
are: the head's mask penalty (-99 times a frame's similarity to its own
audio, over a temperature of 0.07) assumes similarities of at least 0, and
on zero-mean features the frames whose similarity lies near 0 weigh in the
gradient by exp(1414 x similarity), so that bf16 rounding alone moved the
median parameter's gradient by 31 % on one seed of the benchmark. The
parameters start as N(0, 0.02) for every Linear (`temporal_fc` too), the
patch embedding and the cls, position and time embeddings, with zero biases
and LayerNorm (1, 0): the official code zeroes `temporal_fc` after its first
block, which would leave the temporal branch out of a first forward.
`pos_embed` and `time_embed` are sized from `image_size` and `frames` at
construction, and a clip of another size or frame count raises (the
official code interpolates the embeddings instead).

Inside, the cls tokens (B, 1, D) and the patch tokens (B, N T, D) are two
tensors, so that the temporal sub-block's (B N, T, D) is a view; the
spatial one gathers (B T, 1 + N, D) in one copy and scatters its residual
back in its add. Compute dtype as in `models/resnet2d.py`: the input is cast to
it, every Linear and LayerNorm casts its float32 parameters per call, and
attention runs in that dtype (`attend`: the hand-written kernels for the
16-frame attention in bf16 on a card, `scaled_dot_product_attention`
otherwise); the parameters and their gradients stay float32. Each block's
three sub-blocks are the spans `vid.temporal`, `vid.spatial` and `vid.mlp`
(`utils/debug.py::span`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from avtubes_torch.models.resnet2d import compute_dtype_of
from avtubes_torch.ops.temporal_attention import temporal_attention, temporal_attention_engages
from avtubes_torch.utils.debug import span

#: the published widths of TimeSformer-B/16
EMBED_DIM, DEPTH, HEADS, MLP_RATIO, PATCH, LN_EPS = 768, 12, 12, 4, 16, 1e-6
INIT_STD = 0.02


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def _norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, layer.normalized_shape, layer.weight.to(x.dtype),
                        layer.bias.to(x.dtype), layer.eps)


#: sequences that SDPA takes (`attend`) and shorter than this attend through
#: the memory-efficient kernel, longer ones through flash: flash's 128-row
#: tiles waste most of a short sequence (on an H100, 16 frames over 47,040
#: heads: 6.19 ms forward and backward by flash, 2.16 memory-efficient; 197
#: tokens over 3,840: 2.03 flash, 2.83 memory-efficient)
FLASH_FROM = 64


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v per head over (S, L, D) tensors, D =
    heads * dh, returned as (S, L, D).  On a card: sequences of at most 16
    tokens in bf16 with heads of 64 (the 16-frame temporal attention) on
    the hand-written kernels of `ops/temporal_attention.py`, token-major in
    and out; other sequences through SDPA, flash or memory-efficient by the
    length, no attention matrix stored.  Off a card, torch's own choice."""
    s, n, d = q.shape
    if temporal_attention_engages(q.device, q.dtype, (s, heads, n, d // heads)):
        return temporal_attention(q, k, v, heads)
    q, k, v = (t.view(s, n, heads, d // heads).transpose(1, 2) for t in (q, k, v))
    if not q.is_cuda:
        o = F.scaled_dot_product_attention(q, k, v)
    else:
        backend = (SDPBackend.FLASH_ATTENTION if n >= FLASH_FROM
                   else SDPBackend.EFFICIENT_ATTENTION)
        with sdpa_kernel(backend):
            o = F.scaled_dot_product_attention(q, k, v)
    return o.transpose(1, 2).reshape(s, n, d)


class Attention(nn.Module):
    """Multi-head self-attention over (S, L, D) sequences.  q, k and v are
    three products over the row blocks of the one `qkv` weight, so that
    their gradients need no stacking, each a contiguous (S, L, D) tensor."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        w, b = self.qkv.weight.to(x.dtype), self.qkv.bias.to(x.dtype)
        q, k, v = (F.linear(x, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d]) for i in range(3))
        return _linear(attend(q, k, v, self.heads), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    """One divided space-time block over cls (B, 1, D) and patch tokens
    (B, N T, D) in (n t) order."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads)
        self.temporal_norm1 = nn.LayerNorm(dim, eps=eps)
        self.temporal_attn = Attention(dim, heads)
        self.temporal_fc = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def temporal(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        """Each patch's attention over its T frames, through `temporal_fc`,
        added to x."""
        b, nt, d = x.shape
        r = self.temporal_attn(_norm(x.view(b * nt // frames, frames, d), self.temporal_norm1))
        return x + _linear(r, self.temporal_fc).view(b, nt, d)

    def spatial(self, cls: torch.Tensor, x: torch.Tensor, frames: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Each frame's attention over its N patches and the cls token; the
        cls token takes the mean over the frames of its residuals."""
        b, nt, d = x.shape
        n, t = nt // frames, frames
        xs = torch.cat([cls[:, None].expand(b, t, 1, d),
                        x.view(b, n, t, d).transpose(1, 2).contiguous()], dim=2)  # (B, T, 1 + N, D)
        r_cls, r = self.attn(_norm(xs.view(b * t, 1 + n, d), self.norm1)).split([1, n], dim=1)
        cls = cls + r_cls.reshape(b, t, d).mean(dim=1, keepdim=True)
        # the residual's (t n) -> (n t) copy is the add's own
        return cls, (x.view(b, n, t, d) + r.unflatten(0, (b, t)).transpose(1, 2)).reshape(b, nt, d)

    def forward(self, cls: torch.Tensor, x: torch.Tensor, frames: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        with span("vid.temporal"):
            x = self.temporal(x, frames)
        with span("vid.spatial"):
            cls, x = self.spatial(cls, x, frames)
        with span("vid.mlp"):
            cls = cls + self.mlp(_norm(cls, self.norm2))
            x = x + self.mlp(_norm(x, self.norm2))
        return cls, x


class PatchEmbed(nn.Module):
    """The 16x16/16 convolution 3 -> D, kept as the official `proj`."""

    def __init__(self, patch: int, channels: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(channels, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(F, H, W, C) frames -> (F, N, D): each patch's (c, kh, kw) vector
        through the convolution's weight, one product over all patches."""
        f, h, w, c = x.shape
        p = self.patch
        patches = (x.reshape(f, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
                   .reshape(f * (h // p) * (w // p), c * p * p))
        weight = self.proj.weight.to(x.dtype).view(self.proj.out_channels, c * p * p)
        out = F.linear(patches, weight, self.proj.bias.to(x.dtype))
        return out.view(f, (h // p) * (w // p), self.proj.out_channels)


class TimeSformer(nn.Module):
    """Headless TimeSformer-B/16 (divided space-time): (B, T, H, W, 3) ->
    (B, T, H/16, W/16, 768), or `proj_dim` wide, in `compute_dtype`.
    `generator` seeds the init; None uses torch's global generator."""

    def __init__(self, image_size: int = 224, frames: int = 8, dim: int = EMBED_DIM,
                 depth: int = DEPTH, heads: int = HEADS, mlp_ratio: int = MLP_RATIO,
                 patch: int = PATCH, proj_dim: int | None = None,
                 generator: torch.Generator | None = None,
                 compute_dtype: str | torch.dtype = torch.float32):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image_size {image_size} is not a multiple of the patch {patch}")
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.image_size, self.frames, self.patch = image_size, frames, patch
        self.grid = image_size // patch
        self.patch_embed = PatchEmbed(patch, 3, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid ** 2 + 1, dim))
        self.time_embed = nn.Parameter(torch.zeros(1, frames, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_ratio, LN_EPS) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.proj = None if proj_dim is None else nn.Linear(dim, proj_dim, bias=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, INIT_STD, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for p in (self.cls_token, self.pos_embed, self.time_embed):
            p.normal_(0.0, INIT_STD, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        want = (self.frames, self.image_size, self.image_size, 3)
        if x.ndim != 5 or tuple(x.shape[1:]) != want:
            raise ValueError(f"TimeSformer takes clips (B, {', '.join(map(str, want))}), the "
                             f"frames and size its time and position embeddings were built "
                             f"for; got {tuple(x.shape)}")
        b, t = x.shape[:2]
        g, dt = self.grid, self.compute_dtype
        n, d = g * g, self.pos_embed.shape[-1]
        tokens = self.patch_embed(x.to(dt).flatten(0, 1))                 # (B T, N, D)
        pos = self.pos_embed.to(dt)
        cls = (self.cls_token.to(dt) + pos[:, :1]).expand(b, 1, d)
        tokens = (tokens + pos[:, 1:]).view(b, t, n, d).transpose(1, 2)   # (B, N, T, D)
        x = (tokens + self.time_embed.to(dt)[:, None]).reshape(b, n * t, d)
        for block in self.blocks:
            cls, x = block(cls, x, t)
        x = _norm(x, self.norm)
        if self.proj is not None:
            x = torch.relu(_linear(x, self.proj))
        return x.view(b, g, g, t, -1).permute(0, 3, 1, 2, 4)               # (B, T, g, g, C)
