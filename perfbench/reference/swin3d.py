"""Video Swin-B with 3-D shifted-window attention, plain, as FullModel's
tube encoder, and the 3D tube step with it.

Liu et al., "Video Swin Transformer" (CVPR 2022, arXiv:2106.13230), written
from the official `mmaction/models/backbones/swin_transformer.py` with its
rearranges as they are there:

  embedding  `PatchEmbed3D`: the (1, 4, 4) convolution (with its bias) over
             (B, 3, T, H, W), then LayerNorm over the channels;
  layer      `BasicLayer`: 'b c d h w -> b d h w c'; `get_window_size`
             clips the window to the grid (and drops the shift there);
             `compute_mask` over the grid; the blocks; the merge;
             'b d h w c -> b c d h w';
  block      `SwinTransformerBlock3D`: shortcut; norm1; in an odd block
             `torch.roll` by -shift; `window_partition` to (B nW, N, C);
             the window attention, with the mask in an odd block;
             `window_reverse`; the roll back; + shortcut; then
             x + fc2(GELU(fc1(norm2(x))));
  attention  `WindowAttention3D`: qkv (with its bias) as (3, B_, heads, N,
             dh); q * dh^-0.5 @ k^T; + the table's rows gathered by
             `relative_position_index[:N, :N]`; in an odd block + the mask
             (-100 across regions) through the (B_/nW, nW, heads, N, N) view;
             the softmax written out as an exponential over its sum; @ v;
             proj;
  merging    `PatchMerging`: x0..x3 = x[:, :, 0::2, 0::2], [1::2, 0::2],
             [0::2, 1::2], [1::2, 1::2], concatenated, LayerNorm(4C), a
             bias-free 4C -> 2C map; at stride 1 (after stage 3) LayerNorm(C)
             and C -> 2C on each token;
  output     `norm`, (B, T, H/16, W/16, 1024), the bias-free `proj` to the
             head's width and a ReLU.

Departures from the official model, as in the configuration's file: the
tubelet (1, 4, 4), the last merge at stride 1, no dropout, no stochastic
depth, no classification head, `proj` and its ReLU added; a grid the
windows do not divide raises (the official code pads it).  Every product
and stored tensor goes through `Arith` (the float8 control, and
`Arith(count=True)`'s FLOP count on the meta device).  `spec` lists every
parameter with its initialisation.  The tower holds no batch statistics, so
`tower` may run a few clips at a time, each group recomputed in the
backward pass (`chunk`).  The step (`run_steps`) is `training.run_steps`
with this tower in R3D-18's place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import augment, flops, nets, training
from perfbench.reference.arith import Arith
from perfbench.reference.timesformer import layer_norm, linear, product


def _stages(net: dict) -> list[dict]:
    """Each stage's width, depth, heads and merge stride (None: no merge)."""
    d, strides = net["embed_dim"], net["merge_strides"]
    return [{"dim": d * 2 ** i, "depth": depth, "heads": net["num_heads"][i],
             "merge": strides[i] if i < len(strides) else None}
            for i, depth in enumerate(net["depths"])]


def spec(net: dict, prefix: str) -> list[tuple[str, tuple[int, ...], tuple]]:
    """[(name, shape, init)] as `nets.spec` gives them: N(0, 0.02) for every
    Linear, the patch embedding and the bias tables, zero biases, LayerNorm
    (1, 0)."""
    d, c = net["embed_dim"], net["in_chans"]
    pt, ps, _ = net["patch_size"]
    rows = math.prod(2 * w - 1 for w in net["window_size"])
    hidden = net["mlp_ratio"]
    normal, zero, one = ("normal", 0.0, net["init_std"]), ("const", 0.0), ("const", 1.0)
    out = [(f"{prefix}.patch_embed.proj.weight", (d, c, pt, ps, ps), normal),
           (f"{prefix}.patch_embed.proj.bias", (d,), zero)]

    def linear_(name, cin, cout, bias=True):
        out.append((f"{name}.weight", (cout, cin), normal))
        if bias:
            out.append((f"{name}.bias", (cout,), zero))

    def norm(name, width):
        out.extend([(f"{name}.weight", (width,), one), (f"{name}.bias", (width,), zero)])

    norm(f"{prefix}.patch_embed.norm", d)
    for i, st in enumerate(_stages(net)):
        w = st["dim"]
        for j in range(st["depth"]):
            b = f"{prefix}.layers.{i}.blocks.{j}"
            norm(f"{b}.norm1", w)
            out.append((f"{b}.attn.relative_position_bias_table", (rows, st["heads"]), normal))
            linear_(f"{b}.attn.qkv", w, 3 * w, net["qkv_bias"])
            linear_(f"{b}.attn.proj", w, w)
            norm(f"{b}.norm2", w)
            linear_(f"{b}.mlp.fc1", w, int(w * hidden))
            linear_(f"{b}.mlp.fc2", int(w * hidden), w)
        if st["merge"] is not None:
            cin = st["merge"] ** 2 * w
            norm(f"{prefix}.layers.{i}.downsample.norm", cin)
            linear_(f"{prefix}.layers.{i}.downsample.reduction", cin, 2 * w, bias=False)
    last = _stages(net)[-1]["dim"]
    norm(f"{prefix}.norm", last)
    linear_(f"{prefix}.proj", last, net["out_proj_dim"], bias=False)
    return out


def get_window_size(x_size, window_size, shift_size):
    use_window_size, use_shift_size = list(window_size), list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            use_shift_size[i] = 0
    return tuple(use_window_size), tuple(use_shift_size)


def window_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """(B, D, H, W, C) -> (B nW, Wd Wh Ww, C)."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // window_size[0], window_size[0], h // window_size[1], window_size[1],
               w // window_size[2], window_size[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, math.prod(window_size), c)


def window_reverse(windows: torch.Tensor, window_size, b: int, d: int, h: int, w: int
                   ) -> torch.Tensor:
    x = windows.view(b, d // window_size[0], h // window_size[1], w // window_size[2],
                     window_size[0], window_size[1], window_size[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def relative_position_index(window_size) -> torch.Tensor:
    coords_d = torch.arange(window_size[0])
    coords_h = torch.arange(window_size[1])
    coords_w = torch.arange(window_size[2])
    coords = torch.stack(torch.meshgrid(coords_d, coords_h, coords_w, indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += window_size[0] - 1
    relative_coords[:, :, 1] += window_size[1] - 1
    relative_coords[:, :, 2] += window_size[2] - 1
    relative_coords[:, :, 0] *= (2 * window_size[1] - 1) * (2 * window_size[2] - 1)
    relative_coords[:, :, 1] *= (2 * window_size[2] - 1)
    return relative_coords.sum(-1)


def compute_mask(d: int, h: int, w: int, window_size, shift_size, device) -> torch.Tensor:
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    for dd in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
               slice(-shift_size[0], None)):
        for hh in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                   slice(-shift_size[1], None)):
            for ww in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                       slice(-shift_size[2], None)):
                img_mask[:, dd, hh, ww, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0,
                                                                             float(0.0))


def window_attention(arith: Arith, x: torch.Tensor, p: dict, name: str, heads: int,
                     index: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    b_, n, c = x.shape
    qkv = linear(arith, x, p[f"{name}.qkv.weight"], p.get(f"{name}.qkv.bias"))
    q, k, v = qkv.reshape(b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q = q * (c // heads) ** -0.5
    attn = product(arith, q, k.transpose(-2, -1))
    table = p[f"{name}.relative_position_bias_table"]
    bias = table[index[:n, :n].reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.to(attn.dtype).unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.to(attn.dtype).unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    e = torch.exp(attn.float() - attn.float().amax(dim=-1, keepdim=True))
    a = arith.store((e / e.sum(dim=-1, keepdim=True)).to(x.dtype))
    o = product(arith, a, v).transpose(1, 2).reshape(b_, n, c)
    return linear(arith, o, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"])


def block(arith: Arith, x: torch.Tensor, p: dict, name: str, net: dict, heads: int,
          shifted: bool, mask: torch.Tensor | None) -> torch.Tensor:
    b, d, h, w, c = x.shape
    eps = net["layer_norm_eps"]
    window_size, shift_size = get_window_size(
        (d, h, w), net["window_size"], [s if shifted else 0 for s in net["shift_size"]])
    if any(t % s for t, s in zip((d, h, w), window_size)):
        raise ValueError(f"a grid of {(d, h, w)} against windows of {window_size}")
    shortcut = x
    x = layer_norm(arith, x, p, f"{name}.norm1", eps)
    if any(i > 0 for i in shift_size):
        shifted_x = torch.roll(x, shifts=(-shift_size[0], -shift_size[1], -shift_size[2]),
                               dims=(1, 2, 3))
        attn_mask = mask
    else:
        shifted_x = x
        attn_mask = None
    x_windows = window_partition(shifted_x, window_size)
    index = relative_position_index(net["window_size"]).to(x.device)
    attn_windows = window_attention(arith, x_windows, p, f"{name}.attn", heads, index,
                                    attn_mask)
    shifted_x = window_reverse(attn_windows.view(-1, *window_size, c), window_size, b, d, h, w)
    if any(i > 0 for i in shift_size):
        x = torch.roll(shifted_x, shifts=shift_size, dims=(1, 2, 3))
    else:
        x = shifted_x
    x = arith.store(shortcut + x)
    hid = linear(arith, layer_norm(arith, x, p, f"{name}.norm2", eps), p[f"{name}.mlp.fc1.weight"],
                 p[f"{name}.mlp.fc1.bias"])
    hid = arith.store(F.gelu(hid))
    return arith.store(x + linear(arith, hid, p[f"{name}.mlp.fc2.weight"],
                                  p[f"{name}.mlp.fc2.bias"]))


def merge(arith: Arith, x: torch.Tensor, p: dict, name: str, stride: int, eps: float
          ) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D, H/stride, W/stride, 2C)."""
    if stride == 2:
        x0 = x[:, :, 0::2, 0::2, :]
        x1 = x[:, :, 1::2, 0::2, :]
        x2 = x[:, :, 0::2, 1::2, :]
        x3 = x[:, :, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3], -1)
    x = layer_norm(arith, x, p, f"{name}.norm", eps)
    return linear(arith, x, p[f"{name}.reduction.weight"])


def _tower(x: torch.Tensor, p: dict, net: dict, prefix: str, arith: Arith) -> torch.Tensor:
    b, t, s, _, c = x.shape
    if (t, s) != (net["num_frames"], net["img_size"]):
        raise ValueError(f"clips of {t} frames at {s}^2 against a tower laid out for "
                         f"{net['num_frames']} at {net['img_size']}^2")
    eps = net["layer_norm_eps"]
    pt, ps, _ = net["patch_size"]
    # PatchEmbed3D on (B, C, D, H, W)
    x = x.to(arith.dtype).permute(0, 4, 1, 2, 3)
    x = arith.conv(x, p[f"{prefix}.patch_embed.proj.weight"], (pt, ps, ps), 0)
    x = x + p[f"{prefix}.patch_embed.proj.bias"].to(x.dtype)[None, :, None, None, None]
    dd, wh, ww = x.shape[2:]
    x = x.flatten(2).transpose(1, 2)
    x = layer_norm(arith, x, p, f"{prefix}.patch_embed.norm", eps)
    x = x.transpose(1, 2).reshape(b, -1, dd, wh, ww)
    for i, st in enumerate(_stages(net)):
        name = f"{prefix}.layers.{i}"
        # BasicLayer
        x = x.permute(0, 2, 3, 4, 1)                                   # b c d h w -> b d h w c
        d, h, w = x.shape[1:4]
        window_size, shift_size = get_window_size((d, h, w), net["window_size"],
                                                  net["shift_size"])
        dp, hp, wp = (math.ceil(n / k) * k for n, k in zip((d, h, w), window_size))
        attn_mask = compute_mask(dp, hp, wp, window_size, shift_size, x.device)
        for j in range(st["depth"]):
            x = block(arith, x, p, f"{name}.blocks.{j}", net, st["heads"], j % 2 == 1,
                      attn_mask)
        if st["merge"] is not None:
            x = merge(arith, x, p, f"{name}.downsample", st["merge"], eps)
        x = x.permute(0, 4, 1, 2, 3)                                   # b d h w c -> b c d h w
    x = layer_norm(arith, x.permute(0, 2, 3, 4, 1), p, f"{prefix}.norm", eps)
    return arith.store(torch.relu(linear(arith, x, p[f"{prefix}.proj.weight"])))


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
    """FLOPs of the tower's forward over `batch` clips: every product, the
    patch embedding, q k^T and the attention-weighted sum included."""
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
    side = vid["img_size"] // 16
    n = batch * vid["num_frames"]
    fwd = (tower_flops(vid, batch) + flops.tower_flops(cfg["nets"]["audio"], (batch, f, t, 1))
           + flops.head_flops(n, side, side, vid["out_proj_dim"]))
    return 3 * fwd


def parameter_count(net: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in spec(net, net["prefix"]))
