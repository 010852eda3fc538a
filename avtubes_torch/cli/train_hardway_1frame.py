"""CLI: single-frame hard-way training (the original
`train_hardway_1frame.py` flags).

    python -m avtubes_torch.cli.train_hardway_1frame \
        --data_path ... --og_data_path ... --og_gt_path ... --summaries_dir ckpts/

Smoke:  python -m avtubes_torch.cli.train_hardway_1frame --synthetic --steps 2 \
            --epochs 1 --batch_size 2

It runs on the card (`--device cuda`, the default, raises without one;
`--device cpu` must be asked for), the backbones in `--compute_dtype`
(bfloat16 by default, or float32; see `cli/train_hardway.py`), TF32 off.
Prints `final: {...}`, the last step's and the last evaluation's metrics.
"""

import sys

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import disable_tf32
from avtubes_torch.core.distributed import require_single_process
from avtubes_torch.train.hardway_1frame import run


def main(argv=None):
    require_single_process()
    cfg = ExperimentConfig.from_args(list(sys.argv[1:] if argv is None else argv))
    disable_tf32()
    metrics = run(cfg, steps_cap=cfg.train.steps_cap)
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
