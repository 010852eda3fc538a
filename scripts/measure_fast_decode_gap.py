#!/usr/bin/env python3
"""How far `serve --fast_decode` moves the served answers, in both packages,
on the same weights and the same requests, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/measure_fast_decode_gap.py \
        [--checkpoint PARAMS.pt | --seeded] [--compute_dtype bfloat16]

The weights: `--checkpoint` is a `torch.save`d state_dict of the port's
AVENet in any float dtype (read as float32), e.g. the `params` of a
`hardway16_ep<N>`; `--seeded` takes `chip_smoke.py` phase serve's seeded
weights (BatchNorm statistics perturbed); otherwise the script makes a
checkpoint like phase train's: the port's flagship trainer from seed 0,
four bf16 steps on the synthetic set's uniform-noise frames, at a reduced
batch of TRAIN_BATCH = 2 clips x TRAIN_FRAMES = 4 frames x 2 views (phase
train: 20 x 16 x 2) and otherwise the recipe's geometry (224x224 frames,
10 s of 22.05 kHz audio).  The JAX package gets the same weights through
the original checkpoint format.

The requests are phase native's: REQUESTS = 24 JPEG frames of a tree of
photo-like 480x640 clips with 10 s WAVs (`chip_smoke.py::write_photo_tree`,
`jpeg_requests`).  Each package decodes every JPEG with its own
`eval_frame_from_bytes`, exactly and with `fast=True` (libjpeg's DCT-domain
scaling through its native core), and runs its own served pipeline
(normalization, log-spectrogram, AVENet in `--compute_dtype` in eval mode,
the median mask) on both, in batches of BATCH = 2.  Prints one JSON line:
for each package the mean and least mask IoU and heatmap Pearson of the
fast decode against the exact one, and the two packages' exact answers
against each other.  This is what
`chip_smoke.py` phase native holds the card's `--fast_decode` answers on
phase train's checkpoint to.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import resource
import sys
import tempfile
import time
import types

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from avtubes.core.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from avtubes.core.export import _pipeline_fn  # noqa: E402
from avtubes.core.torch_import import avenet_from_torch  # noqa: E402
from avtubes.data.spectrogram import SpectrogramConfig as JaxSpectrogramConfig  # noqa: E402
from avtubes.data.transforms import eval_frame_from_bytes as jax_eval_frame  # noqa: E402
from avtubes.models import AVENet as JaxAVENet  # noqa: E402
from avtubes_torch.cli.serve import _prepare_audio  # noqa: E402
from avtubes_torch.core.config import ExperimentConfig  # noqa: E402
from avtubes_torch.core.export import LocalizerPipeline  # noqa: E402
from avtubes_torch.core.reference_checkpoint import save_reference_checkpoint  # noqa: E402
from avtubes_torch.data.spectrogram import SpectrogramConfig  # noqa: E402
from avtubes_torch.data.transforms import eval_frame_from_bytes  # noqa: E402
from avtubes_torch.models.avenet import AVENet  # noqa: E402
from avtubes_torch.train import hardway  # noqa: E402

IMAGE_SIZE = 224
TRAIN_BATCH = 2     # clips a training step
TRAIN_FRAMES = 4    # frames a clip; two views each
REQUESTS = 24
BATCH = 2           # requests a served batch


def train_checkpoint(summaries_dir: str, batch: int, frames: int, image_size: int = IMAGE_SIZE,
                     samplerate: int = 22050, seconds: int = 10,
                     compute_dtype: str = "bfloat16") -> dict[str, torch.Tensor]:
    """The state_dict after the port's flagship trainer's first four steps
    from seed 0 on the synthetic set (uniform-noise frames), as phase train
    takes them, at `batch` clips of `frames` frames."""
    cfg = ExperimentConfig.from_args(
        ["--synthetic", "--device", "cpu", "--batch_size", str(batch), "--frame_density",
         str(frames), "--image_size", str(image_size), "--samplerate", str(samplerate),
         "--audio_seconds", str(seconds), "--compute_dtype", compute_dtype, "--epochs", "1",
         "--steps", "4", "--seed", "0", "--n_threads", "2", "--summaries_dir", summaries_dir])
    hardway.run(cfg, steps_cap=4, do_eval=False)
    path = os.path.join(summaries_dir, "hardway16_ep0")
    params = torch.load(path, map_location="cpu", weights_only=True)["params"]
    os.remove(path)
    return params


def _answers(pipeline, frames: np.ndarray, waves: np.ndarray, batch: int):
    """(masks, heatmaps) of `pipeline(frames uint8, waves) -> (masks, heat)`
    over the requests in batches."""
    masks, heat = [], []
    for i in range(0, len(frames), batch):
        m, h = pipeline(frames[i:i + batch], waves[i:i + batch])
        masks.append(np.asarray(m))
        heat.append(np.asarray(h))
    return np.concatenate(masks), np.concatenate(heat)


def drift(exact, fast) -> dict:
    """Mask IoU and heatmap Pearson of the fast decode's answers against the
    exact decode's, per request: their means and least values."""
    (m0, h0), (m1, h1) = exact, fast
    iou = (m0 * m1).sum(axis=(1, 2)) / np.maximum(((m0 + m1) > 0).sum(axis=(1, 2)), 1)
    pearson = np.array([np.corrcoef(a.ravel(), b.ravel())[0, 1] for a, b in zip(h0, h1)])
    return {"mask_iou_mean": float(iou.mean()), "mask_iou_min": float(iou.min()),
            "heatmap_pearson_mean": float(pearson.mean()),
            "heatmap_pearson_min": float(pearson.min())}


def measure(params: dict[str, torch.Tensor], bodies: list[dict], image_size: int,
            cfg: SpectrogramConfig, compute_dtype: str = "bfloat16", batch: int = 2) -> dict:
    """Both packages' fast-decode drift on `bodies` (`cli/serve` request
    dicts) with the weights `params`; see the module docstring."""
    model = AVENet(compute_dtype=compute_dtype)
    model.load_state_dict(params, strict=True)
    with tempfile.TemporaryDirectory() as tmp:
        float32 = AVENet()
        float32.load_state_dict(params, strict=True)
        variables = avenet_from_torch(save_reference_checkpoint(
            os.path.join(tmp, "avenet.pth.tar"), float32))
    waves = np.stack([_prepare_audio(b, cfg.samplerate, cfg.num_samples)
                      for b in bodies]).astype(np.float32)
    images = [base64.b64decode(b["image"]) for b in bodies]

    port = LocalizerPipeline(model, cfg, image_size=image_size)

    def port_pipeline(f, w):
        with torch.inference_mode():
            return tuple(t.numpy() for t in port(torch.from_numpy(f), torch.from_numpy(w)))

    jcfg = JaxSpectrogramConfig(samplerate=cfg.samplerate, seconds=cfg.seconds)
    net = JaxAVENet(hardway=JaxExperimentConfig().hardway, dtype=getattr(jnp, compute_dtype))
    jax_pipeline = jax.jit(_pipeline_fn(types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        apply_fn=net.apply), jcfg))
    answers = {}
    for name, decode, pipeline in (("port", eval_frame_from_bytes, port_pipeline),
                                   ("jax", jax_eval_frame, jax_pipeline)):
        answers[name] = {
            way: _answers(pipeline, np.stack([decode(im, image_size, fast=fast)
                                              for im in images]), waves, batch)
            for way, fast in (("exact", False), ("fast", True))}
    (pm, ph), (jm, jh) = answers["port"]["exact"], answers["jax"]["exact"]
    return {"port": drift(answers["port"]["exact"], answers["port"]["fast"]),
            "jax": drift(answers["jax"]["exact"], answers["jax"]["fast"]),
            "port_vs_jax_exact": {**drift((jm, jh), (pm, ph)),
                                  "mask_flips_max": int(np.abs(pm - jm).sum(axis=(1, 2)).max())}}


def main(argv=None) -> int:
    from chip_smoke import (
        SEED,
        jpeg_requests,
        perturb_running_stats,
        write_photo_tree,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--seeded", action="store_true")
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    a = p.parse_args(argv)
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        if a.checkpoint:
            params = {k: (v.float() if v.is_floating_point() else v)
                      for k, v in torch.load(a.checkpoint, map_location="cpu",
                                             weights_only=True).items()}
            weights = a.checkpoint
        elif a.seeded:
            gen = torch.Generator().manual_seed(SEED)
            params = perturb_running_stats(AVENet(generator=gen), gen).state_dict()
            weights = "chip_smoke.py serve phase (seeded)"
        else:
            params = train_checkpoint(tmp, TRAIN_BATCH, TRAIN_FRAMES)
            weights = (f"4 bf16 steps from seed 0 on uniform-noise frames, {TRAIN_BATCH} "
                       f"clips x {TRAIN_FRAMES} frames x 2 views, 224x224, 257x431")
        ids = write_photo_tree(tmp)
        bodies = jpeg_requests(tmp, ids, REQUESTS)
        result = measure(params, bodies, IMAGE_SIZE, SpectrogramConfig(), a.compute_dtype,
                         BATCH)
    print(json.dumps({
        "weights": weights, "compute_dtype": a.compute_dtype, "requests": len(bodies),
        "image_size": IMAGE_SIZE, "jpeg_hw": [480, 640], **result,
        "seconds": round(time.monotonic() - t0, 1), "host": "CPU",
        "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
