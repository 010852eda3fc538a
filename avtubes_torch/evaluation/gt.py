"""Ground-truth rasterizers for Flickr-SoundNet (XML bboxes) and VGGSS (JSON).

The port's own copy of `avtubes/evaluation/gt.py` (numpy only).

Behavioral parity with the original `utils.py:241-309`:

  * Flickr annotations are per-video (or per-frame `<id>_<frame>.xml`) XML
    files whose second-level children include `<bbox>` elements; each bbox's
    children after the first are [xmin, ymin, xmax, ymax] in 256-space and
    are scaled into 224-space with int(224 * v / 256).
  * Whole-video Flickr GT averages the (two-annotator) box maps: sum of box
    masks / 2, clipped at 1.  Per-frame Flickr GT is the raw sum (no clip) —
    the reference's per-frame variant comments out the /2 + clip.
  * VGGSS GT comes from vggss.json entries {file, class, bbox: [[x0,y0,x1,y1],
    ...]} with normalized coords; each is scaled by int(224 * max(v, 0)),
    boxes are unioned and binarized.
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

IMG = 224
ANNOT_SPACE = 256  # Flickr boxes are annotated in 256x256 space


def _flickr_boxes_from_xml(xml_path: str | Path) -> list[tuple[int, int, int, int]]:
    root = ET.parse(str(xml_path)).getroot()
    boxes = []
    for child in root:
        for sub in child:
            if sub.tag != "bbox":
                continue
            vals = []
            for index, ch in enumerate(sub):
                if index == 0:  # first child is an annotation id, skipped by the reference
                    continue
                vals.append(int(IMG * int(ch.text) / ANNOT_SPACE))
            if len(vals) >= 4:
                boxes.append((vals[0], vals[1], vals[2], vals[3]))
    return boxes


def _rasterize_boxes(boxes, accumulate: bool = True) -> np.ndarray:
    gt = np.zeros((IMG, IMG), dtype=np.float64)
    for (xmin, ymin, xmax, ymax) in boxes:
        tmp = np.zeros((IMG, IMG), dtype=np.float64)
        tmp[ymin:ymax, xmin:xmax] = 1.0
        gt += tmp
    if not accumulate:
        gt[gt > 0] = 1.0
    return gt


def flickr_gt_from_xml(xml_path: str | Path, per_frame: bool = False) -> np.ndarray:
    """Rasterize one Flickr annotation XML to a 224x224 GT map.

    per_frame=False: soft multi-annotator map (sum/2, clip at 1)
                     — `utils.py:241-262` semantics.
    per_frame=True:  raw summed map (values may exceed 1)
                     — `utils.py:276-297` semantics.
    """
    boxes = _flickr_boxes_from_xml(xml_path)
    gt = _rasterize_boxes(boxes, accumulate=True)
    if not per_frame:
        gt = gt / 2.0
        gt[gt > 1] = 1.0
    return gt


def vggss_gt_from_bboxes(bboxes) -> np.ndarray:
    """Rasterize VGGSS normalized bboxes [[x0,y0,x1,y1], ...] to a binary map."""
    scaled = [tuple(int(IMG * max(float(v), 0.0)) for v in box) for box in bboxes]
    return _rasterize_boxes(scaled, accumulate=False)


def load_vggss_index(json_path: str | Path) -> dict[str, list]:
    """Load vggss.json into {file_id: bbox_list} (preload mirror of test.py:78-83)."""
    with open(json_path) as f:
        entries = json.load(f)
    return {e["file"]: e["bbox"] for e in entries}
