"""CLI: export a checkpoint as a reference-compatible torch .pth.tar.

Counterpart of `avtubes/cli/export_torch.py`, the reverse of the
`--use_pretrained` warm start: weights trained here load straight into the
original stack (`test.py:64-68` / `train_hardway.py:93`), so its eval
harness can cross-validate our numbers; the flow-consistency trainer's
`--use_pretrained --pretrained_path <file>.pth.tar` warm-starts from it.

    python -m avtubes_torch.cli.export_torch --summaries_dir ckpts/ \
        --out model.pth.tar [--tag hardway16|hardway1frm|tube3d] [--loose]

It reads the newest `<tag>_ep<N>` of `--summaries_dir` (or
`--pretrained_path`) into the model its trainer builds (a tag starting
with `tube`: FullModel, any other: AVENet) on `--device` (default: the
card, or an error) and writes it through
`core/reference_checkpoint.py::reference_state_dict`.  `--loose`
leaves out the synthesized dead tensors (the other modalities' stems, the
fc heads): the file then needs `load_state_dict(strict=False)`.
"""

import sys
from pathlib import Path

from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import resolve_device
from avtubes_torch.core.reference_checkpoint import (
    reference_state_dict,
    save_reference_state_dict,
)
from avtubes_torch.train.state import restore_for_tag


def main(argv=None) -> Path:
    argv = list(sys.argv[1:] if argv is None else argv)

    def take(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            val = argv[i + 1]
            del argv[i : i + 2]
            return val
        return default

    out = take("--out", "model.pth.tar")
    tag = take("--tag", "hardway16")
    strict = "--loose" not in argv
    if not strict:
        argv.remove("--loose")
    if tag == "flow":
        raise SystemExit("--tag flow has no reference torch counterpart "
                         "(FlowNetLite replaces FlowNet2, see PARITY.md)")

    cfg = ExperimentConfig.from_args(argv)
    state, epoch = restore_for_tag(cfg, tag, resolve_device(cfg.train.device),
                                   missing="exporting untrained weights")
    sd = reference_state_dict(state.model, strict)
    path = save_reference_state_dict(out, sd, epoch=epoch)
    print(f"wrote {path} ({path.stat().st_size / 1e6:.1f} MB, {len(sd)} tensors, "
          f"strict={strict})")
    return path


if __name__ == "__main__":
    main()
