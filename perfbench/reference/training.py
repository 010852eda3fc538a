"""The training steps, plain: the flagship two-view hard-way step and the
3D tube step, each with its loss and an Adam update (L2 weight decay added
to the gradient before the moments, as `torch.optim.Adam(weight_decay=)`).

flagship:  hardway = CE(logits(view 1), 0) * w      aug = CE(logits(view 2), 0) * w
           l2 = MSE(weighted(view 1), weighted(view 2)) * (100 - w)
           prop = mean |d/dt weighted(view 1)| + mean |d/dt weighted(view 2)|
           loss = (hardway + aug) / 2 + l2 + prop
tube 3D:   loss = CE(logits, 0) over the B*T frames against the B*T keys
Each clip's audio features are repeated over its T frames.  The flagship
forwards the model once a view, as the original trainer does: the image
tower's BatchNorm statistics advance with the clean view and then with the
augmented one, and the audio tower encodes the same spectrograms in each
forward, so its statistics advance twice a step (its two encodings are
equal in training, and so is their gradient to one encoding's used twice).
The tube 3D step encodes the audio once: one advance of each tower.
"""

from __future__ import annotations

import torch

from perfbench.reference import augment, nets
from perfbench.reference.arith import Arith
from perfbench.reference.spectrogram import log_spectrogram


def hardway_ce(logits: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()


def propagation(maps: torch.Tensor) -> torch.Tensor:
    """Mean absolute temporal difference of (B, T, H, W) maps."""
    return torch.diff(maps, dim=1).abs().mean(dim=(2, 3)).mean(dim=1).mean()


def spectrograms(waves: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, num_samples) -> (B, F, T, 1)."""
    a = cfg["audio"]
    return log_spectrogram(waves, a["samplerate"], a["seconds"], a["nperseg"],
                           a["noverlap"])[..., None]


def audio_features(p: dict, cfg: dict, spec: torch.Tensor, train: bool,
                   arith: Arith) -> torch.Tensor:
    """(B, F, T, 1) -> (B, C): the audio tower, globally max-pooled."""
    return nets.resnet(spec, p, cfg["nets"]["audio"], cfg["nets"]["audio"]["prefix"],
                       train, arith).amax(dim=(1, 2))


def flagship_loss(p: dict, cfg: dict, batch: dict, arith: Arith) -> dict:
    clips = batch["clips"]
    b, t = clips.shape[:2]
    s = cfg["image_size"]
    v1, v2 = augment.two_views(clips, batch["draws"], s)
    spec = spectrograms(batch["waves"], cfg)
    img_net = cfg["nets"]["image"]
    outs = [nets.hardway_head(nets.resnet(v.reshape(b * t, s, s, 3), p, img_net,
                                          img_net["prefix"], True, arith),
                              audio_features(p, cfg, spec, True, arith).repeat_interleave(
                                  t, dim=0), cfg["head"], arith) for v in (v1, v2)]
    w = cfg["optim"]["loss_weight"]
    hw = hardway_ce(outs[0]["logits"]) * w
    aug = hardway_ce(outs[1]["logits"]) * w
    l2 = ((outs[0]["weighted_map"] - outs[1]["weighted_map"]) ** 2).mean() * (100.0 - w)
    prop = sum(propagation(o["weighted_map"].reshape(b, t, *o["weighted_map"].shape[1:]))
               for o in outs)
    return {"loss": (hw + aug) / 2.0 + l2 + prop, "hardway_loss": hw, "aug_loss": aug,
            "l2_loss": l2, "consistency_loss": prop}


def tube3d_loss(p: dict, cfg: dict, batch: dict, arith: Arith) -> dict:
    clips = batch["clips"]
    b, t = clips.shape[:2]
    video = augment.normalize01(augment.view1(clips, batch["flip1"]))
    vid_net = cfg["nets"]["video"]
    feats = nets.resnet(video, p, vid_net, vid_net["prefix"], True, arith)
    feats = feats.reshape(b * t, *feats.shape[2:])
    aud = audio_features(p, cfg, spectrograms(batch["waves"], cfg), True, arith)
    out = nets.hardway_head(feats, aud.repeat_interleave(t, dim=0), cfg["head"], arith)
    return {"loss": hardway_ce(out["logits"])}


LOSSES = {"flagship": flagship_loss, "tube3d": tube3d_loss}


class Adam:
    """torch.optim.Adam's update with L2 weight decay, over a dict of
    float32 leaves; `gradient_seen[name]` is the gradient the first update
    was given (weight decay included)."""

    def __init__(self, params: dict, lr: float, betas: tuple[float, float], eps: float,
                 weight_decay: float):
        self.params, self.lr, self.betas = params, lr, betas
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Update in place; returns the gradients as the update took them."""
        self.t += 1
        b1, b2 = self.betas
        seen = {}
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            seen[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / (1 - b2 ** self.t) ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))
        return seen


def run_steps(kind: str, weights: dict, cfg: dict, batches: list[dict],
              arith: Arith) -> dict:
    """Steps from `weights` (copied) over `batches`, one update each.
    Returns the losses of every step, the raw gradients and the gradients
    as the first update took them, each leaf's change over the steps, and
    each BatchNorm running statistic's change, as float32 norms a leaf."""
    stats = {k for k in weights if k.endswith(("running_mean", "running_var"))}
    learn = {k for k, v in weights.items() if v.is_floating_point() and k not in stats}
    p = {k: v.detach().clone().to(torch.float32) if v.is_floating_point() else v.clone()
         for k, v in weights.items()}
    params = {k: p[k].requires_grad_(True) for k in sorted(learn)}
    o = cfg["optim"]
    opt = Adam(params, o["learning_rate"], tuple(o["betas"]), o["eps"], o["weight_decay"])
    start = {k: v.detach().clone() for k, v in params.items()}
    losses, raw, seen = [], {}, {}
    for i, batch in enumerate(batches):
        terms = LOSSES[kind](p, cfg, batch, arith)
        grads = torch.autograd.grad(terms["loss"], list(params.values()))
        named = dict(zip(params, grads))
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        took = opt.step(named)
        if i == 0:
            raw = {k: float(torch.linalg.vector_norm(g)) for k, g in named.items()}
            seen = {k: float(torch.linalg.vector_norm(g)) for k, g in took.items()}
        del grads, named, took, terms
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - start[k]))
              for k in params}
    stats_change = {k: float(torch.linalg.vector_norm(p[k] - weights[k].to(torch.float32)))
                    for k in sorted(stats)}
    return {"losses": losses, "raw_grad_norm": raw, "grad_norm": seen,
            "change_norm": change, "stats_change_norm": stats_change}
