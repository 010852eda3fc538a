"""Localization metrics: cIoU, AUC (success curve), mTC.

The port's own copy of `avtubes/evaluation/metrics.py` (numpy only).

Semantics match the reference evaluator (the original `utils.py:203-232`,
`utils.py:311-318`):

  * cIoU(infer, gt, thres) binarizes the inferred map at `thres` and computes
      sum(pred & gt) / (sum(gt) + sum(pred & ~gt))
    on 224x224 maps.
  * AUC is the trapezoidal integral of the 21-point success curve: for
    i in 0..20, the fraction of samples with cIoU >= 0.05*i, over x = 0..1.
  * cIoU@0.5 ("final") is the fraction of samples with cIoU >= 0.5.
  * mTC (mean temporal consistency) is the mean cIoU between *consecutive
    binarized predictions* of a video (threshold 0.5); the ground truth is
    not consulted (`utils.py:311-318`).

These are host-side (numpy) by design: they run on small per-sample maps in
the eval loop; the expensive part (heatmap upsampling/binarization) is done
on the device in `postprocess.py`.
"""

from __future__ import annotations

import numpy as np


def ciou_single(infer: np.ndarray, gtmap: np.ndarray, thres: float = 0.01) -> float:
    """Consensus IoU of one inferred map against a (possibly soft) GT map.

    `infer` is binarized at `thres`; `gtmap` may contain fractional values
    (Flickr multi-annotator maps are averaged), matching `utils.py:209-214`.
    """
    infer = np.asarray(infer)
    gtmap = np.asarray(gtmap)
    pred = (infer >= thres).astype(gtmap.dtype)
    inter = np.float64(np.sum(pred * gtmap))
    union = np.float64(np.sum(gtmap) + np.sum(pred * (gtmap == 0)))
    # numpy-scalar division: an empty GT with an empty prediction yields nan
    # (the reference's np.sum()/np.sum() semantics, `utils.py:209-214`) and
    # the eval loop continues — Python-float 0.0/0.0 would raise instead
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(inter / union)


def success_curve(cious: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """21-point success-rate curve: x = 0, 0.05, ..., 1.0."""
    cious = np.asarray(cious, dtype=np.float64)
    x = 0.05 * np.arange(21)
    y = np.array([np.mean(cious >= xi) for xi in x])
    return x, y


def auc_from_ciou(cious: np.ndarray) -> float:
    """Trapezoidal AUC of the success curve (sklearn.metrics.auc equivalent)."""
    x, y = success_curve(cious)
    return float(np.trapezoid(y, x))


def mtc(predictions: list[np.ndarray]) -> float:
    """Mean temporal consistency: mean cIoU between consecutive predictions.

    `predictions` are already-binarized 224x224 maps for consecutive sampled
    frames of one video (`utils.py:311-318` — note the reference ignores its
    gt_maps argument; the live definition is prediction self-consistency).
    """
    n = len(predictions)
    if n < 2:
        return float("nan")
    vals = [ciou_single(predictions[i], predictions[i + 1], 0.5) for i in range(n - 1)]
    return float(np.mean(vals))


class Evaluator:
    """Accumulating evaluator with the reference's API shape (`utils.py:203-232`)."""

    def __init__(self) -> None:
        self.ciou: list[float] = []

    def cal_CIOU(self, infer: np.ndarray, gtmap: np.ndarray, thres: float = 0.01):
        # one binarize/inter/union pass shared with the ratio (ciou_single's
        # math, inlined so the returned triple can never desynchronize)
        pred = (np.asarray(infer) >= thres).astype(np.float64)
        gt = np.asarray(gtmap)
        inter = np.float64(np.sum(pred * gt))
        union = np.float64(np.sum(gt) + np.sum(pred * (gt == 0)))
        with np.errstate(invalid="ignore", divide="ignore"):
            c = float(inter / union)  # nan on 0/0, like the reference
        self.ciou.append(c)
        return c, inter, union

    def cal_AUC(self) -> float:
        return auc_from_ciou(np.asarray(self.ciou))

    def final(self) -> float:
        """cIoU@0.5 — fraction of accumulated samples with cIoU >= 0.5."""
        return float(np.mean(np.asarray(self.ciou) >= 0.5))

    def clear(self) -> None:
        self.ciou = []
