#!/usr/bin/env python3
"""How far the int8 localizer lies from the plain one, in both packages, on
the CPU at full width.

    JAX_PLATFORMS=cpu python3 scripts/measure_int8_gap.py \
        [--checkpoint PARAMS.pt] [--requests 24] [--batch 2]

`--checkpoint` is a `torch.save`d state_dict of the port's AVENet in any
float dtype (read as float32), e.g. the `params` of a `hardway16_ep<N>`;
without it the weights are `chip_smoke.py`'s serve phase's (seeded, the
BatchNorm statistics perturbed).  The JAX package gets the same weights
through the original checkpoint format (`avtubes_torch/core/
reference_checkpoint.py` writes it, `avtubes/core/torch_import.py` reads
it).  The inputs are `chip_smoke.py`'s requests: 224x224 frames and 10 s
of 22.05 kHz audio (257x431 spectrograms).  Each package runs its own
spectrogram, normalization and AVENet in eval mode three ways: int8
convolutions with bf16 backbones (what `export_model --quant int8` serves),
plain bf16 and plain float32.  Prints one JSON line: for each package the
heatmaps' int8-vs-bf16, int8-vs-float32 and bf16-vs-float32 gaps (max
abs, Pearson over all maps, the least Pearson of one map), and the two
packages' int8 heatmaps against each other.  This is what `chip_smoke.py`
phase `int8` holds the port's int8 answers on the card to.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from avtubes.core.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from avtubes.core.torch_import import avenet_from_torch  # noqa: E402
from avtubes.data.spectrogram import SpectrogramConfig as JaxSpectrogramConfig  # noqa: E402
from avtubes.data.spectrogram import log_spectrogram as jax_log_spectrogram  # noqa: E402
from avtubes.data.transforms import normalize_imagenet as jax_normalize_imagenet  # noqa: E402
from avtubes.models import AVENet as JaxAVENet  # noqa: E402
from avtubes_torch.core.reference_checkpoint import save_reference_checkpoint  # noqa: E402
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram  # noqa: E402
from avtubes_torch.data.transforms import normalize_imagenet  # noqa: E402
from avtubes_torch.models.avenet import AVENet  # noqa: E402
from chip_smoke import SEED, make_requests, perturb_running_stats  # noqa: E402

#: (name, backbone dtype, int8 convolutions)
WAYS = (("int8", "bfloat16", True), ("bf16", "bfloat16", False), ("fp32", "float32", False))


def gap(a: np.ndarray, b: np.ndarray) -> dict:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return {"max_abs": float(np.abs(a - b).max()),
            "pearson": float(np.corrcoef(a.ravel(), b.ravel())[0, 1]),
            "pearson_min_per_map": min(float(np.corrcoef(a[i].ravel(), b[i].ravel())[0, 1])
                                       for i in range(len(a)))}


def gaps(heat: dict) -> dict:
    return {"int8_vs_bf16": gap(heat["int8"], heat["bf16"]),
            "int8_vs_fp32": gap(heat["int8"], heat["fp32"]),
            "bf16_vs_fp32": gap(heat["bf16"], heat["fp32"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--batch", type=int, default=2)
    a = p.parse_args(argv)
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))

    if a.checkpoint:
        params = {k: (v.float() if v.is_floating_point() else v)
                  for k, v in torch.load(a.checkpoint, map_location="cpu",
                                         weights_only=True).items()}
    else:
        gen = torch.Generator().manual_seed(SEED)
        params = perturb_running_stats(AVENet(generator=gen), gen).state_dict()
    model = AVENet()
    model.load_state_dict(params, strict=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_reference_checkpoint(os.path.join(tmp, "avenet.pth.tar"), model)
        variables = avenet_from_torch(path)

    cfg, jcfg = SpectrogramConfig(), JaxSpectrogramConfig()
    frames, waves = make_requests(cfg)
    frames, waves = frames[:a.requests], waves[:a.requests]
    batches = [(frames[i:i + a.batch], waves[i:i + a.batch])
               for i in range(0, len(frames), a.batch)]
    t0 = time.monotonic()
    heat = {"jax": {}, "port": {}}
    hardway = JaxExperimentConfig().hardway
    for name, dtype, quant in WAYS:
        net = JaxAVENet(hardway=hardway, dtype=getattr(jnp, dtype), quant_int8=quant)
        apply = jax.jit(lambda v, f, w, net=net: net.apply(
            v, jax_normalize_imagenet(f), jax_log_spectrogram(w, jcfg)[..., None],
            train=False).heatmap)
        heat["jax"][name] = np.concatenate([np.asarray(apply(variables, f, w))
                                            for f, w in batches])
        port = AVENet(compute_dtype=dtype, quant_int8=quant)
        port.load_state_dict(params, strict=True)
        port.eval()
        with torch.inference_mode():
            heat["port"][name] = np.concatenate([
                port(normalize_imagenet(torch.from_numpy(f)),
                     log_spectrogram(torch.from_numpy(w), cfg)[..., None]).heatmap.numpy()
                for f, w in batches])
    print(json.dumps({
        "weights": a.checkpoint or "chip_smoke.py serve phase (seeded)",
        "requests": len(frames), "image_size": 224, "spectrogram": list(cfg.shape),
        "jax": gaps(heat["jax"]), "port": gaps(heat["port"]),
        "port_vs_jax": {name: gap(heat["port"][name], heat["jax"][name]) for name, _, _ in WAYS},
        "heatmap_std": {k: float(v["fp32"].std()) for k, v in heat.items()},
        "seconds": round(time.monotonic() - t0, 1), "host": "CPU",
        "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
