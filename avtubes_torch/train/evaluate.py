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

`model_kind` "2d" scores AVENet; "3d" scores the tube model FullModel: in
the hard-way test each frame as a clip of one frame, in the per-frame test
the sampled frames of a video as ONE clip at their natural length.
`record` > 0 with a `logger` writes the overlay images of
`--record_qualitative` (`utils/visual.py::overlay_heatmap`, under the JAX
package's names) for the first `record` samples or videos.
"""

from __future__ import annotations

from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch
from torch import nn

from avtubes_torch.core.config import DataConfig
from avtubes_torch.core.distributed import (
    gather_rows_to_primary,
    is_primary,
    rows_of,
    world_size,
)
from avtubes_torch.data.spectrogram import SpectrogramConfig, log_spectrogram
from avtubes_torch.data.transforms import normalize_imagenet
from avtubes_torch.evaluation.gt import flickr_gt_from_xml, vggss_gt_from_bboxes
from avtubes_torch.evaluation.metrics import auc_from_ciou, ciou_single, mtc
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.train.steps import eval_mode
from avtubes_torch.utils.visual import overlay_heatmap

MODEL_KINDS = ("2d", "3d")


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


def _check_kind(model_kind: str) -> None:
    if model_kind not in MODEL_KINDS:
        raise ValueError(f"model_kind must be one of {MODEL_KINDS}, got {model_kind!r}")


def _hardway_eval_masks(model: nn.Module, frames_uint8: torch.Tensor,
                        waveforms: torch.Tensor, spec_cfg: SpectrogramConfig,
                        impl: str = "kernel", model_kind: str = "2d") -> torch.Tensor:
    """Raw frames (N, S, S, 3) + waveforms -> binary masks: normalize, K1,
    both encoders in eval mode, K2 (`impl='plain'`: the kernels' plain
    versions).  "3d": each frame a clip of one frame through FullModel."""
    with eval_mode(model):
        frames = normalize_imagenet(frames_uint8)
        spec = log_spectrogram(waveforms, spec_cfg, impl=impl)[..., None]
        if model_kind == "3d":
            heat = model.forward_shared_audio(spec, frames[:, None]).heatmap
        else:
            heat = model(frames, spec).heatmap
        return heatmap_to_mask_batch(heat, impl=impl)


def _perframe_masks(model: nn.Module, frames_uint8: torch.Tensor, waveform: torch.Tensor,
                    spec_cfg: SpectrogramConfig, model_kind: str = "2d",
                    impl: str = "kernel") -> torch.Tensor:
    """Per-frame eval of one video: its frames (K, S, S, 3) against the
    clip's audio, encoded once.  "3d": the K frames as one clip."""
    with eval_mode(model):
        frames = normalize_imagenet(frames_uint8)
        spec = log_spectrogram(waveform[None], spec_cfg, impl=impl)[..., None]
        if model_kind == "3d":
            heat = model.forward_shared_audio(spec, frames[None]).heatmap
        else:
            heat = model.forward_shared_audio(frames, spec).heatmap
        return heatmap_to_mask_batch(heat, impl=impl)


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
                     logger=None, record: int = 0, model_kind: str = "2d",
                     evaluated_ids: list | None = None,
                     sharded: bool = False) -> dict[str, float]:
    """Hard-way test: cIoU@0.5 + AUC over the loader's samples, on the
    model's device.  One K1 and one K2 launch a batch on the card; the last
    partial batch is padded to the steady-state shape.

    record > 0 writes the overlay of the first `record` samples through
    `logger.log_image` as `<id>_hardway` (step = epoch).  evaluated_ids,
    when given, collects the id of every sample scored (the loader skips and
    counts decode failures, so this can be a subset of the split).

    `sharded`, under a process group, is the JAX package's evaluation over
    a data mesh: EVERY rank calls it with the same loader.  Each batch is
    padded to a multiple of the world (`_pad_rows`, the divisor rule), each
    rank runs K1, the towers and K2 on its contiguous rows, and the masks
    are gathered to the primary, which drops the padding and scores them in
    the loader's order; the primary returns the metrics (and fills
    `evaluated_ids`), the others an empty dict.  Without a group, or not
    `sharded`, every row runs here."""
    _check_kind(model_kind)
    device = _device_of(model)
    world = world_size() if sharded else 1
    primary = is_primary() or not sharded
    cious = []
    recorded = 0
    full_bsz = getattr(loader, "batch_size", 0)
    for batch in loader.epoch(epoch):
        n = batch["frame"].shape[0]
        pad_to = full_bsz if 0 < n < full_bsz else n
        pad_to = -(-pad_to // world) * world
        rows = rows_of(pad_to) if sharded else slice(0, pad_to)
        masks = _hardway_eval_masks(
            model, torch.from_numpy(_pad_rows(batch["frame"], pad_to)[rows]).to(device),
            torch.from_numpy(_pad_rows(batch["waveform"], pad_to)[rows]).to(device),
            spec_cfg, model_kind=model_kind)
        if sharded:
            masks = gather_rows_to_primary(masks)
        if not primary:
            continue
        masks = masks.cpu().numpy()[:n]
        for i, vid in enumerate(batch["id"]):
            gt = gt_lookup(vid, None)
            cious.append(ciou_single(masks[i], gt, 0.5))
            if evaluated_ids is not None:
                evaluated_ids.append(vid)
            if logger is not None and recorded < record:
                logger.log_image(f"{vid}_hardway",
                                 overlay_heatmap(batch["frame"][i], masks[i], gt),
                                 step=epoch)
                recorded += 1
    if not primary:
        return {}
    cious = np.asarray(cious)
    return {
        "hardway_ciou": float(np.mean(cious >= 0.5)),
        "hardway_auc": auc_from_ciou(cious),
        "hardway_n": int(cious.size),
    }


def evaluate_perframe(model: nn.Module, source, data_cfg: DataConfig,
                      spec_cfg: SpectrogramConfig, gt_lookup, model_kind: str = "2d",
                      logger=None, record: int = 0, epoch: int = 0) -> dict[str, float]:
    """Whole-video per-frame eval with mTC.

    `source.load(i)` gives {"clip": (T, S, S, 3) uint8, "waveform", "id"} per
    video.  Frames i = sampling_rate, 2 sampling_rate, ... < T-1 are scored; a
    video shorter than one stride is skipped.  "2d" scores them padded to a
    bucket of frames (each frame alone); "3d" as one clip at its natural
    length, since 3D convolutions couple neighbouring frames and padding
    would change the features near its end.  One K1 and one K2 launch a
    video on the card.  record > 0 writes the overlay of every scored frame
    of the first `record` videos as `<id>_test_frame_<frame>` (step = epoch).
    """
    _check_kind(model_kind)
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
        frames = clip[idxs] if model_kind == "3d" else _pad_rows(clip[idxs], bucket_len(k))
        masks = _perframe_masks(
            model, torch.from_numpy(frames).to(device),
            torch.from_numpy(np.asarray(sample["waveform"])).to(device),
            spec_cfg, model_kind).cpu().numpy()[:k]
        iou = [ciou_single(masks[j], gt_lookup(sample["id"], fi), 0.5)
               for j, fi in enumerate(idxs)]
        ious.append(float(np.mean(np.asarray(iou) >= 0.5)))
        aucs.append(auc_from_ciou(np.asarray(iou)))
        mtcs.append(mtc([masks[j] for j in range(k)]))
        if logger is not None and vi < record:
            for j, fi in enumerate(idxs):
                logger.log_image(
                    f"{sample['id']}_test_frame_{fi}",
                    overlay_heatmap(clip[fi], masks[j], gt_lookup(sample["id"], fi)),
                    step=epoch)
    if not ious:
        return {"test_ciou": float("nan"), "test_auc": float("nan"), "test_mtc": float("nan")}
    return {
        "test_ciou": float(np.mean(ious)),
        "test_auc": float(np.mean(aucs)),
        "test_mtc": float(np.nanmean(mtcs)),
    }
