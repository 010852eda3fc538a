"""CLI: qualitative visualization + overfit-one-sample harness (visualize.py).

Counterpart of `avtubes/cli/visualize.py`, with the modes of the
reference's `visualize.py`:
  * default: run the model over the hard-way test samples and dump
    heatmap/GT overlay JPEGs (save_image compositing) to --out_dir, one
    `<id>.jpg` a sample;
  * --whole_video: per-frame overlays over the decoded test videos,
    `<out_dir>/<id>/<j>.jpg` (the reference's PerFrameLabels path,
    visualize.py:119-158);
  * --overfit: repeatedly train on one sample (tiled to a batch of 2: the
    hard-way loss needs a negative) and print per-step loss + cIoU — the
    classic can-it-learn-at-all debug loop (`visualize.py:91-118`).

The model is the trainer's AVENet (`--compute_dtype`, bfloat16 by
default), restored from the newest `hardway16_ep<N>` of `--summaries_dir`
or `--pretrained_path` (not in --overfit, which starts from the seeded
init as the JAX package's does).  It runs on `--device` (default: the card,
or an error): K1 for each spectrogram and K2 for each batch of masks.

Smoke:  python -m avtubes_torch.cli.visualize --synthetic --overfit --steps 20
"""

import sys
from pathlib import Path

import numpy as np
import torch

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import disable_tf32, resolve_device
from avtubes_torch.data.index import load_split
from avtubes_torch.data.pipeline import HardwayTestSource, PerFrameEvalSource, SyntheticSource
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
from avtubes_torch.data.transforms import normalize_imagenet
from avtubes_torch.evaluation.metrics import ciou_single
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.train.evaluate import _pad_rows, bucket_len, make_gt_lookup_auto
from avtubes_torch.train.hardway import _synthetic_gt_lookup, build_model
from avtubes_torch.train.state import create_train_state, restore_for_tag
from avtubes_torch.train.steps import (
    eval_heatmap_shared_step,
    eval_heatmap_step,
    hardway_1frame_train_step,
)
from avtubes_torch.utils.visual import overlay_heatmap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    overfit = "--overfit" in argv
    if overfit:
        argv.remove("--overfit")
    whole_video = "--whole_video" in argv
    if whole_video:
        argv.remove("--whole_video")
    out_dir = "visualizations"
    if "--out_dir" in argv:
        i = argv.index("--out_dir")
        out_dir = argv[i + 1]
        del argv[i : i + 2]
    cfg = ExperimentConfig.from_args(argv)
    disable_tf32()
    d = cfg.data
    spec_cfg = SpectrogramConfig(samplerate=d.samplerate, seconds=d.audio_seconds)
    device = resolve_device(cfg.train.device)

    if d.synthetic:
        src = SyntheticSource(d, n=4, clip=False, seed=1)
        gt_lookup = _synthetic_gt_lookup()
    else:
        ids = load_split(d.metadata_dir, d.testset, "test_hardway")
        src = HardwayTestSource(d.og_data_path or d.data_path, ids, d)
        gt_lookup = make_gt_lookup_auto(d)

    def spectrogram(waveforms: np.ndarray) -> torch.Tensor:
        return log_spectrogram(torch.from_numpy(waveforms).to(device), spec_cfg)[..., None]

    if overfit:
        state = create_train_state(build_model(cfg, torch.Generator().manual_seed(0)).to(device),
                                   cfg.optim)
        sample = src.load(0)
        frames = normalize_imagenet(torch.from_numpy(sample["frame"][None]).to(device))
        frames = frames.repeat(2, 1, 1, 1)  # B=2: hard-way needs a pair
        spec = spectrogram(sample["waveform"][None]).repeat(2, 1, 1, 1)
        gt = gt_lookup(sample["id"], None)
        losses = []
        for step in range(cfg.train.steps_cap or 20):
            metrics = hardway_1frame_train_step(state, frames, spec)
            heat = eval_heatmap_step(state.model, frames, spec)
            mask = heatmap_to_mask_batch(heat)[0].cpu().numpy()
            losses.append(float(metrics["loss"]))
            print(f"step {step}: loss {losses[-1]:.4f} ciou {ciou_single(mask, gt, 0.5):.4f}")
        return losses

    model = restore_for_tag(cfg, "hardway16", device)[0].model
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    from PIL import Image

    written = []
    if whole_video:
        # per-frame overlays over the decoded test videos, one dir a video
        pf = PerFrameEvalSource(d.data_path, load_split(d.metadata_dir, d.testset, "test"), d)
        for i in range(len(pf)):
            sample = pf.load(i)
            clip = sample["clip"]
            idxs = list(range(d.sampling_rate, clip.shape[0] - 1, d.sampling_rate))
            if not idxs:
                continue
            # the frames padded to a bucket, as the JAX package pads them
            k = len(idxs)
            frames = normalize_imagenet(
                torch.from_numpy(_pad_rows(clip[idxs], bucket_len(k))).to(device))
            heat = eval_heatmap_shared_step(model, frames, spectrogram(sample["waveform"][None]))
            masks = heatmap_to_mask_batch(heat[:k]).cpu().numpy()
            vdir = out / sample["id"]
            vdir.mkdir(exist_ok=True)
            for j, fi in enumerate(idxs):
                Image.fromarray(overlay_heatmap(clip[fi], masks[j])).save(vdir / f"{j}.jpg")
                written.append(vdir / f"{j}.jpg")
        print(f"wrote per-frame overlays for {len(pf)} videos to {out}/")
        return written

    for i in range(len(src)):
        sample = src.load(i)
        frames = normalize_imagenet(torch.from_numpy(sample["frame"][None]).to(device))
        heat = eval_heatmap_step(model, frames, spectrogram(sample["waveform"][None]))
        mask = heatmap_to_mask_batch(heat)[0].cpu().numpy()
        img = overlay_heatmap(sample["frame"], mask, gt_lookup(sample["id"], None))
        Image.fromarray(img).save(out / f"{sample['id']}.jpg")
        written.append(out / f"{sample['id']}.jpg")
    print(f"wrote {len(src)} overlays to {out}/")
    return written


if __name__ == "__main__":
    main()
