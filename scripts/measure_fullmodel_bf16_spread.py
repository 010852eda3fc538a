#!/usr/bin/env python3
"""How far a bfloat16 FullModel forward lies from the float32 one, in both
packages, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/measure_fullmodel_bf16_spread.py \
        [--batch 2] [--frames 4] [--image_size 224] [--seed 0]

Makes the JAX package's FullModel weights with numpy from `--seed` (He
fan-out kernels, BatchNorm biases and running statistics perturbed, as
`tests/torch_port_util.py::jax_fullmodel_state` does), loads them into the
port through `avtubes_torch/core/convert.py::fullmodel_from_flax`, runs one
clip batch of `--frames` frames at `--image_size` with 257x431
spectrograms through `forward_shared_audio` in eval mode in both dtypes of
both packages, and prints one JSON line with the measures of
`tests/test_bf16.py` (heatmap Pearson per frame, mask IoU, live logits) for
JAX bf16 vs JAX float32, port bf16 vs port float32 and port bf16 vs JAX
bf16: whether the bars of `tests/test_bf16.py` hold for the 3D model in
each package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from avtubes.core.config import ExperimentConfig  # noqa: E402
from avtubes.models import FullModel as JaxFullModel  # noqa: E402
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch  # noqa: E402
from torch_port_util import jax_fullmodel_state, numpy_variables, port_fullmodel  # noqa: E402


def measures(got, want) -> dict:
    hg, hw = np.asarray(got.heatmap, np.float64), np.asarray(want.heatmap, np.float64)
    pearson = [float(np.corrcoef(hg[i].ravel(), hw[i].ravel())[0, 1]) for i in range(len(hg))]
    mg = heatmap_to_mask_batch(torch.from_numpy(hg.astype(np.float32))).numpy()
    mw = heatmap_to_mask_batch(torch.from_numpy(hw.astype(np.float32))).numpy()
    iou = (mg * mw).sum(axis=(1, 2)) / ((mg + mw) > 0).sum(axis=(1, 2))
    lg, lw = np.asarray(got.logits), np.asarray(want.logits)
    live = lw > -100
    return {"heatmap_pearson_min": min(pearson), "heatmap_pearson_median": float(np.median(pearson)),
            "mask_iou_min": float(iou.min()),
            "live_logit_max_abs_diff": float(np.abs(lg[live] - lw[live]).max())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)

    t0 = time.monotonic()
    js = jax_fullmodel_state(a.seed)
    rng = np.random.RandomState(a.seed + 1)
    video = rng.randn(a.batch, a.frames, a.image_size, a.image_size, 3).astype(np.float32)
    spec = (rng.randn(a.batch, 257, 431, 1) * 0.5).astype(np.float32)
    out = {}
    for name, dtype in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        model = JaxFullModel(hardway=ExperimentConfig().hardway, dtype=dtype)
        out[f"jax_{name}"] = jax.device_get(jax.jit(
            lambda v, s, x, m=model: m.apply(v, s, x, train=False,
                                             method="forward_shared_audio"))(
            numpy_variables(js), jnp.asarray(spec), jnp.asarray(video)))
        with torch.no_grad():
            out[f"port_{name}"] = port_fullmodel(js, name).forward_shared_audio(
                torch.from_numpy(spec), torch.from_numpy(video))
    print(json.dumps({
        "device": "cpu", "batch": a.batch, "frames": a.frames, "image_size": a.image_size,
        "spectrogram": [257, 431], "seed": a.seed,
        "jax_bf16_vs_jax_f32": measures(out["jax_bfloat16"], out["jax_float32"]),
        "port_bf16_vs_port_f32": measures(out["port_bfloat16"], out["port_float32"]),
        "port_bf16_vs_jax_bf16": measures(out["port_bfloat16"], out["jax_bfloat16"]),
        "port_f32_vs_jax_f32": measures(out["port_float32"], out["jax_float32"]),
        "seconds": round(time.monotonic() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
