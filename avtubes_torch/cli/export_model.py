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
        --out model.avt [--quant int8] [--audio_transport float32] \
        [--validate [N]] [--validate_tol 0.01] [--device cuda]

`--quant int8` exports with int8 inference convolutions in both backbones
(`models/resnet2d.py::QuantConv2d`: per-output-channel weight scales,
per-sample activation scales, int8 x int8 -> int32 on the card's tensor
cores); the header says `"quant": "int8"` and the weights are the
checkpoint's own.  Any other `--quant` value exits, as in the JAX package.
Unlike the dtype, int8 is an approximation: pass `--validate` to measure
what it costs.

`--validate [N]` scores the written artifact against the checkpoint's
UNQUANTIZED pipeline, in the same compute dtype, on an N-sample synthetic
boxed eval set (default 16) and prints `validate: {...}`; a cIoU or AUC
delta above `--validate_tol` exits with code 2 (the artifact stays on
disk).  The checkpoint is read, and the validation runs, on `--device`
(default: the card, or an error).

`--s2d` (space-to-depth stems) raises: an MXU layout trick that is not to
be ported (ROADMAP.md, "Not to port").  So do the StableHLO export's
`--batch` (the exported batch; the port's artifact takes any batch) and
`--platforms` (the lowering targets), before argparse could read `--batch`
as an abbreviation of `--batch_size`.  `--remat` is accepted, as by the JAX
CLI, and changes nothing at inference.
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
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.train.hardway import HARDWAY_TAG, build_model

S2D_NOT_PORTED = ("--s2d is not ported to avtubes_torch: space-to-depth stems are "
                  "an MXU layout trick (ROADMAP.md, \"Not to port\")")
#: the JAX CLI's flags of its StableHLO export, which the port's artifact
#: (a state_dict that takes any batch, on the card) has no use for
STABLEHLO_NOT_PORTED = {
    "--batch": "the exported batch of a StableHLO artifact; the port's artifact takes "
               "any batch",
    "--platforms": "the StableHLO lowering's target platforms; the port's artifact runs "
                   "on the card (or the CPU if asked)",
}


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
    quant = take("--quant")
    if quant not in (None, "int8"):
        raise SystemExit(f"--quant supports only 'int8', got {quant!r}")
    if "--s2d" in argv:
        raise NotImplementedError(S2D_NOT_PORTED)
    for flag, meaning in STABLEHLO_NOT_PORTED.items():
        # by name, before argparse would take `--batch` for `--batch_size`
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            raise NotImplementedError(
                f"{flag} is not ported to avtubes_torch: {meaning} (ROADMAP.md, "
                "\"Not to port\")")
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
    exported = model    # the checkpoint's own semantics: what --validate scores against
    if quant == "int8":
        # QuantConv2d keeps Conv2d's weight: the checkpoint loads as it is
        exported = AVENet(hardway=model.hardway, compute_dtype=model.compute_dtype,
                          quant_int8=True)
        exported.load_state_dict(model.state_dict(), strict=True)
        print("exporting with int8 inference convs")

    blob = export_localizer(exported, spec_cfg, image_size=d.image_size,
                            audio_transport=audio_transport, extra_meta={"s2d": False})
    Path(out).write_bytes(blob)
    print(f"wrote {out} ({len(blob) / 1e6:.1f} MB, audio_transport={audio_transport}, "
          f"compute_dtype={cfg.train.compute_dtype}, quant={quant})")

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
