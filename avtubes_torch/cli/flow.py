"""CLI: the flow path (reference `flow.py`).

    python -m avtubes_torch.cli.flow --train_flow --synthetic \
        --image_size 224 --batch_size 20 --epochs 1 --steps 6

--train_flow runs the unsupervised FlowNetLite pretraining loop (photometric
+ smoothness on synthetic frame pairs) and writes `flownet_ep*` checkpoints.
It runs on the card (`--device cuda`, the default, raises without one;
`--device cpu` must be asked for).

Without --train_flow the JAX package runs the flow-consistency
trainer (`train/flow.py`), which is not ported yet (ROADMAP.md Queue 1
item 10), so this entry point exits with an error that says so.
`--flow_loss_weight` and `--no_flow` belong to that trainer; they parse as
they do there.
"""

import sys

from avtubes_torch.core.config import ExperimentConfig


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--flow_loss_weight" in argv:
        i = argv.index("--flow_loss_weight")
        float(argv[i + 1])
        del argv[i : i + 2]
    train_flow = "--train_flow" in argv
    if train_flow:
        argv.remove("--train_flow")
    if "--no_flow" in argv:
        argv.remove("--no_flow")
    cfg = ExperimentConfig.from_args(argv)
    if not train_flow:
        raise SystemExit(
            "avtubes_torch.cli.flow: the flow-consistency trainer "
            "(train/flow.py) is not ported yet (ROADMAP.md Queue 1 item 10); "
            "run with --train_flow for the FlowNetLite pretrainer")
    from avtubes_torch.train.flow_pretrain import run_pretrain

    metrics = run_pretrain(cfg, steps_cap=cfg.train.steps_cap)
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
