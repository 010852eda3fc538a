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

More than one process, one card each (`core/distributed.py`; NCCL, or gloo
with `--device cpu`), as under the JAX package's data mesh: `--batch_size`
is the GLOBAL batch (the flagship's `cli/train_hardway` takes it per
process), each rank holding its contiguous rows; a world that does not
divide it exits, naming the largest divisor that would:

    torchrun --nproc_per_node N -m avtubes_torch.cli.train_hardway_1frame ...
    AVTUBES_COORDINATOR=host0:1234 AVTUBES_NUM_PROCESSES=N \
        AVTUBES_PROCESS_ID=i python -m avtubes_torch.cli.train_hardway_1frame ...
"""

import sys

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import disable_tf32
from avtubes_torch.core.distributed import check_world_divides, maybe_initialize, shutdown
from avtubes_torch.train.hardway_1frame import run


def main(argv=None):
    cfg = ExperimentConfig.from_args(list(sys.argv[1:] if argv is None else argv))
    # a world that does not divide the global batch exits before any
    # rendezvous, reading or writing
    check_world_divides(cfg.optim.batch_size)
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
