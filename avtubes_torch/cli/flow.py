"""CLI: the flow path (reference `flow.py`): flow-guided consistency training.

    python -m avtubes_torch.cli.flow --synthetic --steps 2 --epochs 1 \
        --batch_size 2 --frame_density 2 [--flow_loss_weight 0.1] [--no_flow]
    python -m avtubes_torch.cli.flow --train_flow --synthetic \
        --image_size 224 --batch_size 20 --epochs 1 --steps 6

Without --train_flow it runs the flow-consistency trainer
(`train/flow.py::run`): AVENet's hard-way CE plus `--flow_loss_weight`
(default 0.0) times the warp consistency of its Pos maps along the frozen
FlowNetLite's flow; it writes `flow_ep<N>` and loads the newest
`flownet_ep<N>` of `--summaries_dir`.  `--no_flow` drops the flow net and
the warp probe from the step entirely (only at weight 0; the reference
always runs FlowNet2, flow.py:127-153).

--train_flow runs the unsupervised FlowNetLite pretraining loop instead
(photometric + smoothness on frame pairs: synthetic ones with
`--synthetic`, consecutive frames of the training clips otherwise) and
writes the `flownet_ep<N>` checkpoints that the consistency trainer
auto-loads.

Both run on the card (`--device cuda`, the default, raises without one;
`--device cpu` must be asked for), TF32 off.  Prints `final: {...}`, the
last step's metrics.
"""

import sys

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import disable_tf32


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    weight = 0.0
    if "--flow_loss_weight" in argv:
        i = argv.index("--flow_loss_weight")
        weight = float(argv[i + 1])
        del argv[i : i + 2]
    train_flow = "--train_flow" in argv
    if train_flow:
        argv.remove("--train_flow")
    compute_flow = "--no_flow" not in argv
    if not compute_flow:
        argv.remove("--no_flow")
    cfg = ExperimentConfig.from_args(argv)
    disable_tf32()
    if train_flow:
        from avtubes_torch.train.flow_pretrain import run_pretrain

        metrics = run_pretrain(cfg, steps_cap=cfg.train.steps_cap)
    else:
        from avtubes_torch.train.flow import run

        metrics = run(cfg, steps_cap=cfg.train.steps_cap, flow_loss_weight=weight,
                      compute_flow=compute_flow)
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
