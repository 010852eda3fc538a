"""CLI: center-Gaussian prior baseline sweep (test_hardway_dataset.py parity).

Counterpart of `avtubes/cli/baseline_gaussian.py`, the reference's
metric-pipeline sanity harness (`test_hardway_dataset.py`): score a centered
2D Gaussian prior (std 1..10 over a 14x14 grid, upsampled like a model
heatmap) against the hard-way test GT, and print the numbers next to the
quoted SOTA (cIoU 0.7349, AUC 0.5778 for the LVS checkpoint).

    python -m avtubes_torch.cli.baseline_gaussian --testset flickr \
        --og_data_path ... --og_gt_path ...
    python -m avtubes_torch.cli.baseline_gaussian --synthetic    # smoke

It scores through the host's numpy postprocess (`evaluation/postprocess.py::
heatmap_to_mask`): host work that launches no kernel, so it takes no
device.
"""

import numpy as np

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.data.index import load_split
from avtubes_torch.evaluation.metrics import auc_from_ciou, ciou_single
from avtubes_torch.evaluation.postprocess import heatmap_to_mask
from avtubes_torch.train.evaluate import make_gt_lookup_auto
from avtubes_torch.train.hardway import _synthetic_gt_lookup
from avtubes_torch.utils.misc import gkern

SOTA_CIOU = 0.7349397590361446  # test_hardway_dataset.py:88
SOTA_AUC = 0.5778112449799198   # test_hardway_dataset.py:89


def gaussian_heatmap(std: float, size: int = 14) -> np.ndarray:
    """Centered Gaussian prior heatmap — gkern with the baseline's shape."""
    return gkern(size, std)


def score_gaussian(std: float, ids, gt_lookup) -> tuple[float, float]:
    """cIoU@0.5 + AUC of the centered-Gaussian prior over `ids` — the
    sample-independent mask every learned predictor must beat
    (`test_hardway_dataset.py:70-87`; also the comparison column of
    `test.py:93,106-107`)."""
    mask = heatmap_to_mask(gaussian_heatmap(std))
    cious = np.asarray([ciou_single(mask, gt_lookup(v, None), 0.5) for v in ids])
    return float(np.mean(cious >= 0.5)), auc_from_ciou(cious)


def main(argv=None):
    cfg = ExperimentConfig.from_args(argv)
    d = cfg.data
    if d.synthetic:
        ids = [f"synthetic_{i}" for i in range(8)]
        gt_lookup = _synthetic_gt_lookup()
    else:
        ids = load_split(d.metadata_dir, d.testset, "test_hardway")
        gt_lookup = make_gt_lookup_auto(d)

    print(f"quoted SOTA (LVS): cIoU {SOTA_CIOU}  AUC {SOTA_AUC}")
    best = (0.0, 0.0, 0)
    for std in range(1, 11):
        ciou, auc = score_gaussian(std, ids, gt_lookup)
        print(f"std {std:2d}: cIoU@0.5 {ciou:.4f}  AUC {auc:.4f}")
        if ciou > best[0]:
            best = (ciou, auc, std)
    print(f"best: std={best[2]} cIoU {best[0]:.4f} AUC {best[1]:.4f}")
    return best


if __name__ == "__main__":
    main()
