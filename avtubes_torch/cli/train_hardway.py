"""CLI: 16-frame hard-way training (the original `train_hardway.py` flags).

    python -m avtubes_torch.cli.train_hardway \
        --data_path ... --og_data_path ... --og_gt_path ... [--gt_path ...] \
        --summaries_dir ckpts/ --batch_size 20

Smoke:  python -m avtubes_torch.cli.train_hardway --synthetic --steps 3 --epochs 1

It runs on the card (`--device cuda`, the default, raises without one;
`--device cpu` must be asked for).  The backbones compute in
`--compute_dtype`, bfloat16 by default as in the JAX package (float32
parameters, Adam moments and BatchNorm statistics; the head and the losses
in float32), or float32.  Float32 is IEEE float32 here: TF32 is switched off
for matmuls and cuDNN convolutions, which also keeps the head's product in
float32 under bfloat16.  Prints `final: {...}`, the last step's and the last
evaluation's metrics.

More than one process, one card each (`core/distributed.py`; NCCL, or gloo
with `--device cpu`), `--batch_size` per process:

    torchrun --nproc_per_node N -m avtubes_torch.cli.train_hardway ...
    AVTUBES_COORDINATOR=host0:1234 AVTUBES_NUM_PROCESSES=N \
        AVTUBES_PROCESS_ID=i python -m avtubes_torch.cli.train_hardway ...
"""

import sys

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import disable_tf32
from avtubes_torch.core.distributed import maybe_initialize, shutdown
from avtubes_torch.train.hardway import run


def main(argv=None):
    cfg = ExperimentConfig.from_args(list(sys.argv[1:] if argv is None else argv))
    maybe_initialize(cfg.train.device)
    try:
        disable_tf32()
        metrics = run(cfg, steps_cap=cfg.train.steps_cap)
        print("final:", metrics)
    finally:
        shutdown()
    return metrics


if __name__ == "__main__":
    main()
