"""TimeSformer-B/16 with divided space-time attention, plain, as FullModel's
tube encoder, and the 3D tube step with it.

Bertasius, Wang and Torresani, "Is Space-Time Attention All You Need for
Video Understanding?" (ICML 2021, arXiv:2102.05095), written from the
official `timesformer/models/vit.py` (`VisionTransformer.forward_features`,
`Block` with `attention_type='divided_space_time'`), with its rearranges as
they are there: x is (B, 1 + N T, D), the patch tokens in (n t) order.

  embedding  patches by the 16x16/16 convolution (with its bias) over the
             B T frames; [cls; patches] + pos_embed per frame; the patch
             tokens '(b t) n m -> (b n) t m' + time_embed, back to
             'b (n t) m', the cls token of the first frame prepended;
  block      xt = x[:, 1:] + temporal_fc(TA(temporal_norm1(xt as (b n) t m)));
             xs = [cls repeated over T; xt as (b t) n m]; r = SA(norm1(xs));
             x = [cls; xt] + [mean over T of r[:, 0]; r[:, 1:] as b (n t) m];
             x = x + fc2(GELU(fc1(norm2(x))));
  attention  qkv (with its bias), softmax(q k^T * dh^-0.5) v written out as
             an explicit exponential over its sum, then proj;
  output     `norm`, the patch tokens as (B, T, H/16, W/16, D), then the
             bias-free `proj` to the head's width and a ReLU.

Departures from the official model, as in the configuration's file: no
dropout, no stochastic depth, no classification head, `proj` and its ReLU
added (the head takes non-negative features, as the ResNets give it).
Every product and stored tensor goes through `Arith` (the float8 control,
and `Arith(count=True)`'s FLOP count on the meta device).  `spec` lists
every parameter with its initialisation.  The tower holds no batch
statistics, so `tower` may run a few clips at a time, each group
recomputed in the backward pass (`chunk`): the same mathematics in less
memory.  The step (`run_steps`) is `training.run_steps` with this tower in
R3D-18's place: the audio ResNet-18 and its BatchNorm statistics, the
hard-way head, the CE over the B T frames and Adam are `nets` and
`training`'s own.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import augment, flops, nets, training
from perfbench.reference.arith import Arith, fake_e4m3


def _tokens(net: dict) -> int:
    return (net["img_size"] // net["patch_size"]) ** 2


def spec(net: dict, prefix: str) -> list[tuple[str, tuple[int, ...], tuple]]:
    """[(name, shape, init)] as `nets.spec` gives them: N(0, 0.02) for every
    Linear, the patch embedding and the cls, position and time embeddings,
    zero biases, LayerNorm (1, 0)."""
    d, p, c = net["embed_dim"], net["patch_size"], net["in_chans"]
    hidden = int(d * net["mlp_ratio"])
    normal, zero, one = ("normal", 0.0, net["init_std"]), ("const", 0.0), ("const", 1.0)
    out = [(f"{prefix}.cls_token", (1, 1, d), normal),
           (f"{prefix}.pos_embed", (1, _tokens(net) + 1, d), normal),
           (f"{prefix}.time_embed", (1, net["num_frames"], d), normal),
           (f"{prefix}.patch_embed.proj.weight", (d, c, p, p), normal),
           (f"{prefix}.patch_embed.proj.bias", (d,), zero)]

    def linear(name, cin, cout, bias=True):
        out.append((f"{name}.weight", (cout, cin), normal))
        if bias:
            out.append((f"{name}.bias", (cout,), zero))

    def norm(name):
        out.extend([(f"{name}.weight", (d,), one), (f"{name}.bias", (d,), zero)])

    for i in range(net["depth"]):
        b = f"{prefix}.blocks.{i}"
        norm(f"{b}.norm1")
        linear(f"{b}.attn.qkv", d, 3 * d, net["qkv_bias"])
        linear(f"{b}.attn.proj", d, d)
        norm(f"{b}.temporal_norm1")
        linear(f"{b}.temporal_attn.qkv", d, 3 * d, net["qkv_bias"])
        linear(f"{b}.temporal_attn.proj", d, d)
        linear(f"{b}.temporal_fc", d, d)
        norm(f"{b}.norm2")
        linear(f"{b}.mlp.fc1", d, hidden)
        linear(f"{b}.mlp.fc2", hidden, d)
    norm(f"{prefix}.norm")
    linear(f"{prefix}.proj", d, net["out_proj_dim"], bias=False)
    return out


def linear(arith: Arith, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
           ) -> torch.Tensor:
    """x @ w^T + b in `x`'s dtype, operands and output stored."""
    w = w.to(x.dtype)
    if arith.precision == "fp8" and x.device.type != "meta":
        w = fake_e4m3(w)
    y = F.linear(arith.store(x), w, None if b is None else b.to(x.dtype))
    if arith.count:
        arith.flops += 2 * y.numel() * w.shape[1]
    return arith.store(y)


def product(arith: Arith, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, batched, operands and output stored."""
    y = torch.matmul(arith.store(a), arith.store(b))
    if arith.count:
        arith.flops += 2 * y.numel() * a.shape[-1]
    return arith.store(y)


def layer_norm(arith: Arith, x: torch.Tensor, p: dict, name: str, eps: float) -> torch.Tensor:
    return arith.store(F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"].to(x.dtype),
                                    p[f"{name}.bias"].to(x.dtype), eps))


def attention(arith: Arith, x: torch.Tensor, p: dict, name: str, heads: int) -> torch.Tensor:
    s, n, d = x.shape
    qkv = linear(arith, x, p[f"{name}.qkv.weight"], p.get(f"{name}.qkv.bias"))
    q, k, v = qkv.reshape(s, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    scores = product(arith, q, k.transpose(-2, -1)) * (d // heads) ** -0.5
    e = torch.exp(scores.float() - scores.float().amax(dim=-1, keepdim=True))
    a = arith.store((e / e.sum(dim=-1, keepdim=True)).to(x.dtype))
    o = product(arith, a, v).transpose(1, 2).reshape(s, n, d)
    return linear(arith, o, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"])


def block(arith: Arith, x: torch.Tensor, p: dict, name: str, net: dict, b: int, t: int
          ) -> torch.Tensor:
    n, d = _tokens(net), net["embed_dim"]
    heads, eps = net["num_heads"], net["layer_norm_eps"]
    # temporal: 'b (n t) m -> (b n) t m'
    xt = x[:, 1:].reshape(b * n, t, d)
    r = attention(arith, layer_norm(arith, xt, p, f"{name}.temporal_norm1", eps), p,
                  f"{name}.temporal_attn", heads).reshape(b, n * t, d)
    xt = arith.store(x[:, 1:] + linear(arith, r, p[f"{name}.temporal_fc.weight"],
                                       p[f"{name}.temporal_fc.bias"]))
    # spatial: 'b (n t) m -> (b t) n m', each frame with the cls token
    cls0 = x[:, :1]
    cls = cls0.repeat(1, t, 1).reshape(b * t, 1, d)
    xs = xt.reshape(b, n, t, d).permute(0, 2, 1, 3).reshape(b * t, n, d)
    r = attention(arith, layer_norm(arith, torch.cat([cls, xs], dim=1), p, f"{name}.norm1",
                                    eps), p, f"{name}.attn", heads)
    cls_r = r[:, 0].reshape(b, t, d).mean(dim=1, keepdim=True)
    res = r[:, 1:].reshape(b, t, n, d).permute(0, 2, 1, 3).reshape(b, n * t, d)
    x = arith.store(torch.cat([cls0, xt], dim=1) + torch.cat([cls_r, res], dim=1))
    # MLP
    h = linear(arith, layer_norm(arith, x, p, f"{name}.norm2", eps), p[f"{name}.mlp.fc1.weight"],
               p[f"{name}.mlp.fc1.bias"])
    h = arith.store(F.gelu(h))
    return arith.store(x + linear(arith, h, p[f"{name}.mlp.fc2.weight"],
                                  p[f"{name}.mlp.fc2.bias"]))


def _tower(x: torch.Tensor, p: dict, net: dict, prefix: str, arith: Arith) -> torch.Tensor:
    b, t, s, _, c = x.shape
    d, pt = net["embed_dim"], net["patch_size"]
    g, n = s // pt, _tokens(net)
    if (t, s) != (net["num_frames"], net["img_size"]):
        raise ValueError(f"clips of {t} frames at {s}^2 against embeddings of "
                         f"{net['num_frames']} at {net['img_size']}^2")
    frames = x.to(arith.dtype).reshape(b * t, s, s, c).permute(0, 3, 1, 2)
    tok = arith.conv(frames, p[f"{prefix}.patch_embed.proj.weight"], pt, 0)     # (BT, D, g, g)
    tok = tok + p[f"{prefix}.patch_embed.proj.bias"].to(tok.dtype)[None, :, None, None]
    tok = tok.flatten(2).transpose(1, 2)                                          # (BT, N, D)
    cls = p[f"{prefix}.cls_token"].to(tok.dtype).expand(b * t, -1, -1)
    x = arith.store(torch.cat([cls, tok], dim=1) + p[f"{prefix}.pos_embed"].to(tok.dtype))
    cls = x[:b, :1]
    # '(b t) n m -> (b n) t m', + time_embed, -> 'b (n t) m'
    xt = x[:, 1:].reshape(b, t, n, d).permute(0, 2, 1, 3).reshape(b * n, t, d)
    xt = arith.store(xt + p[f"{prefix}.time_embed"].to(xt.dtype))
    x = torch.cat([cls, xt.reshape(b, n * t, d)], dim=1)
    for i in range(net["depth"]):
        x = block(arith, x, p, f"{prefix}.blocks.{i}", net, b, t)
    x = layer_norm(arith, x, p, f"{prefix}.norm", net["layer_norm_eps"])
    y = x[:, 1:].reshape(b, g, g, t, d).permute(0, 3, 1, 2, 4)
    return arith.store(torch.relu(linear(arith, y, p[f"{prefix}.proj.weight"])))


def tower(x: torch.Tensor, p: dict, net: dict, prefix: str, arith: Arith,
          chunk: int | None = None) -> torch.Tensor:
    """Normalised channels-last clips (B, T, S, S, 3) -> (B, T, S/16, S/16,
    out) in `arith.dtype`; with `chunk`, `chunk` clips at a time, each group
    recomputed in the backward pass."""
    if chunk is None or chunk >= x.shape[0]:
        return _tower(x, p, net, prefix, arith)
    return torch.cat([checkpoint(_tower, part, p, net, prefix, arith, use_reentrant=False)
                      for part in x.split(chunk)])


def tube_loss(p: dict, cfg: dict, batch: dict, arith: Arith, chunk: int | None = None) -> dict:
    """`training.tube3d_loss` with this tower: CE over the B T frames."""
    clips = batch["clips"]
    b, t = clips.shape[:2]
    video = augment.normalize01(augment.view1(clips, batch["flip1"]))
    vid = cfg["nets"]["video"]
    feats = tower(video, p, vid, vid["prefix"], arith, chunk)
    feats = feats.reshape(b * t, *feats.shape[2:])
    aud = training.audio_features(p, cfg, training.spectrograms(batch["waves"], cfg), True,
                                  arith)
    out = nets.hardway_head(feats, aud.repeat_interleave(t, dim=0), cfg["head"], arith)
    return {"loss": training.hardway_ce(out["logits"])}


def all_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """Every leaf of the configuration: the tower's, then the audio tower's."""
    vid, aud = cfg["nets"]["video"], cfg["nets"]["audio"]
    return spec(vid, vid["prefix"]) + nets.spec(aud, aud["prefix"])


def run_steps(weights: dict, cfg: dict, batches: list[dict], arith: Arith,
              chunk: int | None = None) -> dict:
    """`training.run_steps` with `tube_loss`: steps from `weights` (copied)
    over `batches`, one Adam update each; the losses, the raw gradients and
    those the first update took, each leaf's change, and each BatchNorm
    running statistic's change, as float32 norms a leaf; and `grads`, the
    gradients the first update took, whole."""
    stats = {k for k in weights if k.endswith(("running_mean", "running_var"))}
    learn = {k for k, v in weights.items() if v.is_floating_point() and k not in stats}
    p = {k: v.detach().clone().to(torch.float32) if v.is_floating_point() else v.clone()
         for k, v in weights.items()}
    params = {k: p[k].requires_grad_(True) for k in sorted(learn)}
    o = cfg["optim"]
    opt = training.Adam(params, o["learning_rate"], tuple(o["betas"]), o["eps"],
                        o["weight_decay"])
    start = {k: v.detach().clone() for k, v in params.items()}
    losses, raw, seen, first = [], {}, {}, {}
    for i, batch in enumerate(batches):
        terms = tube_loss(p, cfg, batch, arith, chunk)
        grads = torch.autograd.grad(terms["loss"], list(params.values()))
        named = dict(zip(params, grads))
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        took = opt.step(named)
        if i == 0:
            raw = {k: float(torch.linalg.vector_norm(g)) for k, g in named.items()}
            seen = {k: float(torch.linalg.vector_norm(g)) for k, g in took.items()}
            first = took
        del grads, named, took, terms
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - start[k]))
              for k in params}
    stats_change = {k: float(torch.linalg.vector_norm(p[k] - weights[k].to(torch.float32)))
                    for k in sorted(stats)}
    return {"losses": losses, "raw_grad_norm": raw, "grad_norm": seen,
            "change_norm": change, "stats_change_norm": stats_change, "grads": first}


def tower_flops(net: dict, batch: int) -> int:
    """FLOPs of the tower's forward over `batch` clips: every product,
    the patch embedding, q k^T and the attention-weighted sum included."""
    arith = Arith(count=True)
    p = {name: torch.empty(shape, device="meta") for name, shape, _ in spec(net, net["prefix"])}
    s = net["img_size"]
    _tower(torch.empty((batch, net["num_frames"], s, s, net["in_chans"]), device="meta"), p,
           net, net["prefix"], arith)
    return arith.flops


def train_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one training step at `batch` clips: the tower, the audio
    tower and the head, forward and twice that for the backward."""
    vid = cfg["nets"]["video"]
    f, t = flops.spectrogram_shape(cfg)
    side = vid["img_size"] // vid["patch_size"]
    n = batch * vid["num_frames"]
    fwd = (tower_flops(vid, batch) + flops.tower_flops(cfg["nets"]["audio"], (batch, f, t, 1))
           + flops.head_flops(n, side, side, vid["out_proj_dim"]))
    return 3 * fwd


def parameter_count(net: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in spec(net, net["prefix"]))
