"""CLI: 3D tube training (the original `train_3D.py` flags).

    python -m avtubes_torch.cli.train_3d \
        --data_path ... --gt_path ... --summaries_dir ckpts/ --batch_size 20

Smoke:  python -m avtubes_torch.cli.train_3d --synthetic --steps 2 --epochs 1 \
            --batch_size 2 --frame_density 2

It runs on the card (`--device cuda`, the default, raises without one;
`--device cpu` must be asked for), the backbones in `--compute_dtype`
(bfloat16 by default, as in the JAX package, or float32; see
`cli/train_hardway.py`), TF32 off.  Prints `final: {...}`, the last step's
and the last per-frame test's metrics.
"""

import sys

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import disable_tf32
from avtubes_torch.core.distributed import require_single_process
from avtubes_torch.train.train3d import run


def main(argv=None):
    require_single_process()
    cfg = ExperimentConfig.from_args(list(sys.argv[1:] if argv is None else argv))
    disable_tf32()
    metrics = run(cfg, steps_cap=cfg.train.steps_cap)
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
