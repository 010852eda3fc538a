"""CLI: 16-frame hard-way training (the original `train_hardway.py` flags).

    python -m avtubes_torch.cli.train_hardway --compute_dtype float32 \
        --data_path ... --og_data_path ... --og_gt_path ... \
        --summaries_dir ckpts/ --batch_size 20

Smoke:  python -m avtubes_torch.cli.train_hardway --synthetic \
            --compute_dtype float32 --steps 3 --epochs 1

It runs on the card (`--device cuda`, the default, raises without one;
`--device cpu` must be asked for).  Float32 is IEEE float32 here: TF32 is
switched off for matmuls and cuDNN convolutions.  `--compute_dtype
bfloat16`, the flag's default as in the JAX package, is not ported and
raises.  Prints `final: {...}`, the last step's and the last evaluation's
metrics.
"""

import sys

import torch

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.train.hardway import run


def main(argv=None):
    cfg = ExperimentConfig.from_args(list(sys.argv[1:] if argv is None else argv))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    metrics = run(cfg, steps_cap=cfg.train.steps_cap)
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
