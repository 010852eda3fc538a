"""CLI: quantitative eval — cIoU@0.5 + AUC on the hard-way test set.

Counterpart of `avtubes/cli/test_quantitative.py`, the reference's
`test.py` + `run_quantitative.sh` path: load a checkpoint, run the hard-way
test loader (flickr 249-image set or VGGSS 5158-clip set), print cIoU/AUC.
`--use_activation` additionally scores the layer4 channel-mean activation
map as an alternative predictor and keeps the per-sample max
(test.py:102-140 semantics).  Every run also prints the center-Gaussian
comparison column (test.py:93,106-107) — the gkern(14,5) prior scored
through the identical postprocess.

    python -m avtubes_torch.cli.test_quantitative --testset flickr \
        --og_data_path ... --og_gt_path ... --summaries_dir ckpts/
    python -m avtubes_torch.cli.test_quantitative --synthetic   # smoke

`--tag` names the trainer whose newest `<tag>_ep<N>` checkpoint is read
(default `hardway16`), unless `--pretrained_path` names one; a tag starting
with `tube` scores the 3D FullModel, any other AVENet, in `--compute_dtype`
(bfloat16 by default).  The tag is taken literally, as the JAX package
takes it: the 1-frame trainer writes `hardway1frm_ep<N>`.

It runs on one card (`--device cuda`, the default, raises without one;
`--device cpu` must be asked for), K1 and K2 once a batch (K2 twice with
`--use_activation`).  The JAX package shards the eval batches over a mesh of
chips; one card needs none, so there is no mesh here.
"""

import sys

import numpy as np
import torch

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import disable_tf32, resolve_device
from avtubes_torch.data.index import load_split
from avtubes_torch.data.pipeline import (
    BatchLoader,
    HardwayTestSource,
    SyntheticSource,
    make_hardway_loader,
)
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
from avtubes_torch.data.transforms import normalize_imagenet
from avtubes_torch.evaluation.metrics import auc_from_ciou, ciou_single
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.train import hardway
from avtubes_torch.train.evaluate import _pad_rows, evaluate_hardway, make_gt_lookup_auto
from avtubes_torch.train.state import restore_for_tag
from avtubes_torch.train.steps import eval_mode


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    use_activation = "--use_activation" in argv
    if use_activation:
        argv.remove("--use_activation")
    tag = "hardway16"  # trainer tags: hardway16 | hardway1frm | tube3d | flow
    if "--tag" in argv:
        i = argv.index("--tag")
        tag = argv[i + 1]
        del argv[i:i + 2]
    cfg = ExperimentConfig.from_args(argv)
    disable_tf32()
    d = cfg.data
    spec_cfg = SpectrogramConfig(samplerate=d.samplerate, seconds=d.audio_seconds)
    model_kind = "3d" if tag.startswith("tube") else "2d"
    if model_kind == "3d" and use_activation:
        raise ValueError("--use_activation is a 2D (AVENet) predictor")
    state, _ = restore_for_tag(cfg, tag, resolve_device(cfg.train.device),
                               missing="evaluating a random-init model")

    if d.synthetic:
        src = SyntheticSource(d, n=8, clip=False, seed=1)
        gt_lookup = hardway._synthetic_gt_lookup()
        loader = BatchLoader(src, batch_size=min(d.eval_batch_size, len(src)),
                             num_workers=d.n_threads, shuffle=False, drop_last=False)
    else:
        ids = load_split(d.metadata_dir, d.testset, "test_hardway")
        src = HardwayTestSource(d.og_data_path or d.data_path, ids, d)
        gt_lookup = make_gt_lookup_auto(d)
        loader = make_hardway_loader(src.root, src.ids, d, batch_size=d.eval_batch_size,
                                     num_workers=d.n_threads)
    evaluated_ids: list = []
    if use_activation:
        metrics = _evaluate_with_activation(state.model, loader, spec_cfg, gt_lookup,
                                            evaluated_ids=evaluated_ids)
    else:
        metrics = evaluate_hardway(state.model, loader, d, spec_cfg, gt_lookup,
                                   model_kind=model_kind, evaluated_ids=evaluated_ids)
    metrics.update(_gaussian_column(evaluated_ids, gt_lookup))
    print(f"Hardway Test cIoU  {metrics['hardway_ciou']}")
    print(f"Hardway Test auc   {metrics['hardway_auc']}")
    print(f"Center-gaussian comparison: cIoU {metrics['gaussian_ciou']:.4f}  "
          f"auc {metrics['gaussian_auc']:.4f}")
    return metrics


def _gaussian_column(evaluated_ids, gt_lookup):
    """Center-Gaussian comparison column (`test.py:93,106-107,144-148`):
    a gkern(14, std=5) prior, upsampled/normalized/median-binarized exactly
    like a model heatmap, scored against the same GT.  Scored over the ids
    the model eval actually decoded (not the whole split) so the two columns
    share a denominator — the reference scores the gaussian inside the same
    loader loop."""
    from avtubes_torch.cli.baseline_gaussian import score_gaussian

    ciou, auc = score_gaussian(5.0, evaluated_ids, gt_lookup)
    return {"gaussian_ciou": ciou, "gaussian_auc": auc}


def heatmap_and_activation_maps(model, frames_uint8: torch.Tensor, waveforms: torch.Tensor,
                                spec_cfg: SpectrogramConfig, impl: str = "kernel"
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw frames (N, S, S, 3) + waveforms -> AVENet's (N, 14, 14) hard-way
    heatmap and its layer4 channel-mean activation map, from ONE encoding of
    the image in eval mode (K1 once; `impl='plain'`: its plain version)."""
    with eval_mode(model):
        img = model.encode_image(normalize_imagenet(frames_uint8))
        aud = model.encode_audio(log_spectrogram(waveforms, spec_cfg, impl=impl)[..., None])
        return model.head(img, aud).heatmap, img.mean(dim=-1)


def _evaluate_with_activation(model, loader, spec_cfg, gt_lookup,
                              evaluated_ids: list | None = None):
    """Score both the similarity heatmap and the image-feature channel-mean
    activation map; keep max(ciou) per sample (test.py:102-140)."""
    device = next(model.parameters()).device
    cious = []
    full_bsz = getattr(loader, "batch_size", 0)
    for batch in loader.epoch(0):
        n = batch["frame"].shape[0]
        pad_to = full_bsz if 0 < n < full_bsz else n  # the last partial batch
        # keeps the steady-state shape
        maps = heatmap_and_activation_maps(
            model, torch.from_numpy(_pad_rows(batch["frame"], pad_to)).to(device),
            torch.from_numpy(_pad_rows(batch["waveform"], pad_to)).to(device), spec_cfg)
        masks_h, masks_a = (heatmap_to_mask_batch(m).cpu().numpy()[:n] for m in maps)
        for i, vid in enumerate(batch["id"]):
            gt = gt_lookup(vid, None)
            cious.append(max(ciou_single(masks_h[i], gt, 0.5),
                             ciou_single(masks_a[i], gt, 0.5)))
            if evaluated_ids is not None:
                evaluated_ids.append(vid)
    cious = np.asarray(cious)
    return {"hardway_ciou": float(np.mean(cious >= 0.5)),
            "hardway_auc": auc_from_ciou(cious), "hardway_n": int(cious.size)}


if __name__ == "__main__":
    main()
