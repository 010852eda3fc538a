"""CLI: export a trained checkpoint as a serving artifact.

Counterpart of `avtubes/cli/export_model.py`.  Reads the trainer's
`hardway16_ep<N>` checkpoint (the latest in `--summaries_dir`, or
`--pretrained_path`) and writes the localizer artifact of
`avtubes_torch.core.export.export_localizer`, which `cli/serve.py` loads.
The model is built as the trainer builds it (`train/hardway.py::
build_model`), so the artifact runs in `--compute_dtype`: bfloat16 by
default, as in the JAX package; the header records it and the weights stay
float32.

    python -m avtubes_torch.cli.export_model --summaries_dir ckpts/ \
        --out model.avt [--audio_transport float32] [--validate [N]] \
        [--validate_tol 0.01] [--device cuda]

`--validate [N]` scores the written artifact against the checkpoint's
pipeline, in the same compute dtype, on an N-sample synthetic boxed eval
set (default 16) and prints `validate: {...}`; a cIoU or AUC delta above `--validate_tol` exits
with code 2 (the artifact stays on disk).  The checkpoint is read, and the
validation runs, on `--device` (default: the card, or an error).

`--quant int8` and `--s2d` (int8 inference convolutions, space-to-depth
stems) are not ported and raise.
"""

import json
import sys
from pathlib import Path

import torch

from avtubes_torch.core.checkpoint import latest_checkpoint
from avtubes_torch.core.config import ExperimentConfig
from avtubes_torch.core.device import resolve_device
from avtubes_torch.core.export import export_localizer, validate_artifact
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.train.hardway import HARDWAY_TAG, build_model

NOT_PORTED = ("{flag} is not ported to avtubes_torch (int8 convolutions and "
              "space-to-depth stems: ROADMAP.md Queue 1 item 11)")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    def take(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            val = argv[i + 1]
            del argv[i : i + 2]
            return val
        return default

    out = take("--out", "model.avt")
    if take("--quant") is not None:
        raise NotImplementedError(NOT_PORTED.format(flag="--quant"))
    if "--s2d" in argv:
        raise NotImplementedError(NOT_PORTED.format(flag="--s2d"))
    audio_transport = take("--audio_transport", "float32")
    validate_tol = float(take("--validate_tol", "0.01"))
    validate_n = 0
    if "--validate" in argv:
        i = argv.index("--validate")
        # optional numeric operand: `--validate 64` or bare `--validate`
        if i + 1 < len(argv) and argv[i + 1].isdigit():
            validate_n = int(argv[i + 1])
            del argv[i : i + 2]
        else:
            validate_n = 16
            del argv[i]

    cfg = ExperimentConfig.from_args(argv)
    d = cfg.data
    device = resolve_device(cfg.train.device)
    spec_cfg = SpectrogramConfig(samplerate=d.samplerate, seconds=d.audio_seconds)
    model = build_model(cfg, torch.Generator().manual_seed(0))
    ckpt = cfg.train.pretrained_path or latest_checkpoint(cfg.train.summaries_dir,
                                                          HARDWAY_TAG)
    if ckpt:
        payload = torch.load(Path(ckpt).absolute(), map_location="cpu", weights_only=True)
        model.load_state_dict(payload["params"], strict=True)
        print(f"loaded {ckpt} (epoch {payload['epoch']})")
    else:
        print("WARNING: no checkpoint found — exporting untrained weights")
    model = model.to(device)

    blob = export_localizer(model, spec_cfg, image_size=d.image_size,
                            audio_transport=audio_transport,
                            extra_meta={"s2d": False, "quant": None})
    Path(out).write_bytes(blob)
    print(f"wrote {out} ({len(blob) / 1e6:.1f} MB, audio_transport={audio_transport}, "
          f"compute_dtype={cfg.train.compute_dtype})")

    report = None
    if validate_n:
        report = validate_artifact(model, blob, spec_cfg, image_size=d.image_size,
                                   n=validate_n, device=device)
        print("validate:", json.dumps(report))
        worst = max(report["ciou_delta"], report["auc_delta"])
        if worst > validate_tol:
            print(f"WARNING: artifact deviates from the checkpoint's pipeline by {worst:.4f} "
                  f"cIoU/AUC (> --validate_tol {validate_tol}); NOT serving-safe "
                  "without a real-data check", flush=True)
            raise SystemExit(2)
        print(f"validate OK: max cIoU/AUC delta {worst:.4f} <= tol {validate_tol}")
    return report


if __name__ == "__main__":
    main()
