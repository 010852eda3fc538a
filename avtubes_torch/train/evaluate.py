"""Evaluation loops: hard-way test (cIoU/AUC) and per-frame test (cIoU/AUC/mTC).

Counterpart of `avtubes/train/evaluate.py`, with the original protocol:
  * heatmaps come from AVENet in eval mode, are upsampled 14->224 bilinear,
    min-max normalized and binarized at the median pixel on the device in
    batch (`heatmap_to_mask_batch`, which launches the hand-written K2
    kernel on the card; the spectrogram before it launches K1), then
    compared with rasterized ground truth on the host;
  * hard-way test: one frame per video, cIoU@0.5 fraction + 21-point AUC;
  * per-frame test: every sampling_rate-th frame of each test video, per-video
    cIoU@0.5/AUC averaged over videos, plus mTC between consecutive masks.

The overlay images of `record_qualitative` are not ported (they need the
JAX package's `utils/visual.py`): asking for them raises.
"""

from __future__ import annotations

from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch
from torch import nn

from avtubes_torch.core.config import DataConfig
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
from avtubes_torch.data.transforms import normalize_imagenet
from avtubes_torch.evaluation.gt import flickr_gt_from_xml, vggss_gt_from_bboxes
from avtubes_torch.evaluation.metrics import auc_from_ciou, ciou_single, mtc
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.train.steps import eval_mode

RECORD_NOT_PORTED = (
    "record_qualitative (overlay images of the evaluated frames) needs utils/visual.py, "
    "which is not ported to avtubes_torch yet (ROADMAP.md Queue 1 item 11)")


def make_gt_lookup(data_cfg: DataConfig, per_frame: bool = False,
                   vggss_index: dict | None = None) -> Callable[[str, int | None], np.ndarray]:
    """Returns gt(video_id, frame_or_None) -> 224x224 map."""
    gt_dir = Path(data_cfg.gt_path if per_frame else data_cfg.og_gt_path)

    def lookup(vid: str, frame: int | None = None) -> np.ndarray:
        if data_cfg.testset == "vggss":
            if vggss_index is None:
                raise ValueError("vggss eval requires the vggss.json index")
            return vggss_gt_from_bboxes(vggss_index[vid])
        name = f"{vid}_{frame}.xml" if frame is not None else f"{vid}.xml"
        return flickr_gt_from_xml(gt_dir / name, per_frame=frame is not None)

    return lookup


def make_gt_lookup_auto(data_cfg: DataConfig, per_frame: bool = False):
    """make_gt_lookup with the vggss.json index loaded for testset='vggss'."""
    vggss_index = None
    if data_cfg.testset == "vggss":
        from avtubes_torch.data.index import resolve_metadata_dir
        from avtubes_torch.evaluation.gt import load_vggss_index

        vggss_index = load_vggss_index(
            resolve_metadata_dir(data_cfg.metadata_dir) / "vggss.json")
    return make_gt_lookup(data_cfg, per_frame=per_frame, vggss_index=vggss_index)


def _hardway_eval_masks(model: nn.Module, frames_uint8: torch.Tensor,
                        waveforms: torch.Tensor, spec_cfg: SpectrogramConfig,
                        impl: str = "kernel") -> torch.Tensor:
    """Raw frames + waveforms -> binary masks: normalize, K1, both encoders
    in eval mode, K2 (`impl='plain'`: the kernels' plain versions)."""
    with eval_mode(model):
        frames = normalize_imagenet(frames_uint8)
        spec = log_spectrogram(waveforms, spec_cfg, impl=impl)[..., None]
        return heatmap_to_mask_batch(model(frames, spec).heatmap, impl=impl)


def _perframe_masks(model: nn.Module, frames_uint8: torch.Tensor, waveform: torch.Tensor,
                    spec_cfg: SpectrogramConfig) -> torch.Tensor:
    """Per-frame eval of one video: every frame against the clip's audio,
    encoded once."""
    with eval_mode(model):
        frames = normalize_imagenet(frames_uint8)
        spec = log_spectrogram(waveform[None], spec_cfg)[..., None]
        return heatmap_to_mask_batch(model.forward_shared_audio(frames, spec).heatmap)


def _pad_rows(arr: np.ndarray, to: int) -> np.ndarray:
    """Pad axis 0 to `to` rows by repeating row 0 (sliced off after the
    call; eval has no cross-sample coupling, so this is exact)."""
    if arr.shape[0] >= to:
        return arr
    reps = np.repeat(arr[:1], to - arr.shape[0], axis=0)
    return np.concatenate([arr, reps], axis=0)


def bucket_len(n: int, buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)) -> int:
    """Smallest bucket >= n (multiples of 32 past the table): variable-length
    eval runs a small set of batch shapes."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 32) * 32


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def evaluate_hardway(model: nn.Module, loader, data_cfg: DataConfig,
                     spec_cfg: SpectrogramConfig, gt_lookup, epoch: int = 0,
                     record: int = 0, evaluated_ids: list | None = None) -> dict[str, float]:
    """Hard-way test: cIoU@0.5 + AUC over the loader's samples, on the
    model's device.  One K1 and one K2 launch a batch on the card; the last
    partial batch is padded to the steady-state shape.

    evaluated_ids, when given, collects the id of every sample scored (the
    loader skips and counts decode failures, so this can be a subset of the
    split)."""
    if record:
        raise NotImplementedError(RECORD_NOT_PORTED)
    device = _device_of(model)
    cious = []
    full_bsz = getattr(loader, "batch_size", 0)
    for batch in loader.epoch(epoch):
        n = batch["frame"].shape[0]
        pad_to = full_bsz if 0 < n < full_bsz else n
        masks = _hardway_eval_masks(
            model, torch.from_numpy(_pad_rows(batch["frame"], pad_to)).to(device),
            torch.from_numpy(_pad_rows(batch["waveform"], pad_to)).to(device),
            spec_cfg).cpu().numpy()[:n]
        for i, vid in enumerate(batch["id"]):
            cious.append(ciou_single(masks[i], gt_lookup(vid, None), 0.5))
            if evaluated_ids is not None:
                evaluated_ids.append(vid)
    cious = np.asarray(cious)
    return {
        "hardway_ciou": float(np.mean(cious >= 0.5)),
        "hardway_auc": auc_from_ciou(cious),
        "hardway_n": int(cious.size),
    }


def evaluate_perframe(model: nn.Module, source, data_cfg: DataConfig,
                      spec_cfg: SpectrogramConfig, gt_lookup, record: int = 0,
                      epoch: int = 0) -> dict[str, float]:
    """Whole-video per-frame eval with mTC.

    `source.load(i)` gives {"clip": (T, S, S, 3) uint8, "waveform", "id"} per
    video.  Frames i = sampling_rate, 2 sampling_rate, ... < T-1 are scored,
    padded to a bucket of frames; a video shorter than one stride is skipped.
    """
    if record:
        raise NotImplementedError(RECORD_NOT_PORTED)
    device = _device_of(model)
    ious, aucs, mtcs = [], [], []
    stride = data_cfg.sampling_rate
    for vi in range(len(source)):
        try:
            sample = source.load(vi)
        except Exception as e:  # noqa: BLE001 — skip-and-count decode policy
            print(f"[eval] skipping {vi}: {e}")
            continue
        clip = sample["clip"]
        idxs = list(range(stride, clip.shape[0] - 1, stride))
        if not idxs:
            continue
        k = len(idxs)
        masks = _perframe_masks(
            model, torch.from_numpy(_pad_rows(clip[idxs], bucket_len(k))).to(device),
            torch.from_numpy(np.asarray(sample["waveform"])).to(device),
            spec_cfg).cpu().numpy()[:k]
        iou = [ciou_single(masks[j], gt_lookup(sample["id"], fi), 0.5)
               for j, fi in enumerate(idxs)]
        ious.append(float(np.mean(np.asarray(iou) >= 0.5)))
        aucs.append(auc_from_ciou(np.asarray(iou)))
        mtcs.append(mtc([masks[j] for j in range(k)]))
    if not ious:
        return {"test_ciou": float("nan"), "test_auc": float("nan"), "test_mtc": float("nan")}
    return {
        "test_ciou": float(np.mean(ious)),
        "test_auc": float(np.mean(aucs)),
        "test_mtc": float(np.nanmean(mtcs)),
    }
