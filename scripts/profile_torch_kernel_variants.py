#!/usr/bin/env python3
"""What each part of the two serving kernels costs on the card.

    python3 scripts/profile_torch_kernel_variants.py

Needs one CUDA card and `nvcc`.  For K1 (`csrc/stft.cu`, the FFT kernel at
the serving shape (8, 220500) float32) and K2 (`csrc/median_select.cu` at
(8, 224, 224), a random map and a constant one) it builds copies of the
source with one part taken out or swapped — the results of those copies are
WRONG, only their times mean something — and times each like
`chip_smoke.py`'s `kernel_ms`: calls enqueued behind a sleeping stream, so
the host's launch rate is not in the reading.  The difference to `base` is
what the part costs; `launch_floor` is a kernel that returns at once.

An edit is a (text, replacement) pair and the script stops if the text is no
longer in the source, so it cannot silently measure the wrong thing.  Prints
one JSON object per kernel, then the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np
import torch

from avtubes_torch.core.device import device_report
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.ops import _build
from avtubes_torch.ops import median_select as k2
from avtubes_torch.ops import stft as k1
from chip_smoke import queued_ms

K1_VARIANTS = {
    "base": [],
    "launch_floor": [("    const int tid = threadIdx.x;\n    const int lane = tid & 31, warp = tid >> 5;\n    const int t0",
                      "    if (hop > 0) return;\n    const int tid = threadIdx.x;\n"
                      "    const int lane = tid & 31, warp = tid >> 5;\n    const int t0")],
    "no_register_stages": [("    fft_registers<E>(re, im);\n", "")],
    "no_lane_stages": [("    static_for<0, 5>([&](auto s_) {", "    static_for<0, 0>([&](auto s_) {")],
    "no_log": [("stage[k * TILE + column] = logf(power + log_offset) * inv_std;",
                "stage[k * TILE + column] = power;")],
    "no_store": [("    for (int idx = tid; idx < F * TILE; idx += NT) {",
                  "    for (int idx = tid; idx < F * TILE * (num_frames < 0); idx += NT) {")],
}

_PLAIN_ADD = ("            if ((value >> (shift + nbits)) == prefix)\n"
              "                atomicAdd(h + ((value >> shift) & ((1 << nbits) - 1)), 1);\n")
K2_VARIANTS = {
    "base": [],
    "launch_floor": [("    cg::cluster_group cluster = cg::this_cluster();",
                      "    if (n > 0) return;\n    cg::cluster_group cluster = cg::this_cluster();")],
    "no_histogram_adds": [(_PLAIN_ADD, "            if (value == 0x7fffffff) h[0] = 1;\n")],
    # a warp groups its lanes by digit first, one add per distinct digit
    "adds_grouped_by_match_any": [(_PLAIN_ADD,
        "            const bool active = (value >> (shift + nbits)) == prefix;\n"
        "            const int digit = (value >> shift) & ((1 << nbits) - 1);\n"
        "            if (__ballot_sync(FULL_MASK, active) != 0) {\n"
        "                const unsigned peers = __match_any_sync(FULL_MASK, active ? digit : -1);\n"
        "                if (active && __ffs(peers) - 1 == lane) atomicAdd(h + digit, __popc(peers));\n"
        "            }\n")],
    "one_pass": [("constexpr int NPASS = 3;", "constexpr int NPASS = 1;")],
    "no_remote_reads": [("cluster.map_shared_rank(g, r)", "g + (r & 0)"),
                        ("cluster.map_shared_rank(h, r)[", "(h + (r & 0))[")],
    "cluster_of_4": [("constexpr int CLUSTER = 8; ", "constexpr int CLUSTER = 4; ")],
}


def time_variants(name: str, variants: dict, timers: dict) -> dict:
    """Milliseconds of every timer under every variant of `csrc/<name>.cu`."""
    source = (_build.CSRC_DIR / f"{name}.cu").read_text()
    out = {}
    for variant, edits in variants.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}.cu no longer has the text of variant "
                                 f"{variant!r}: {old!r}")
            text = text.replace(old, new)
        with tempfile.TemporaryDirectory() as tmp:
            (Path(tmp) / f"{name}.cu").write_text(text)
            # the wrappers load `csrc/<name>.cu` through `_build`: point it at the copy
            with mock.patch.object(_build, "CSRC_DIR", Path(tmp)):
                _build._loaded.pop(name, None)
                out[variant] = {label: fn() for label, fn in timers.items()}
        _build._loaded.pop(name, None)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("this script needs one CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = SpectrogramConfig()
    rng = np.random.RandomState(0)
    wav = torch.from_numpy(
        np.clip(rng.randn(8, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)).to(dev)
    maps = torch.from_numpy(
        np.random.default_rng(0).random((8, 224, 224), dtype=np.float32)).to(dev)
    constant = torch.zeros_like(maps)
    k_med = 224 * 224 // 2
    print(json.dumps({"kernel": "K1 log_spectrogram_cuda (8, 220500) float32", "ms": time_variants(
        "stft", K1_VARIANTS,
        {"float32": lambda: queued_ms(lambda: k1.log_spectrogram_cuda(wav, cfg))})}), flush=True)
    print(json.dumps({"kernel": "K2 median_mask_cuda (8, 224, 224)", "ms": time_variants(
        "median_select", K2_VARIANTS,
        {"generic": lambda: queued_ms(lambda: k2.median_mask_cuda(maps, k_med)),
         "all_equal": lambda: queued_ms(lambda: k2.median_mask_cuda(constant, k_med))})}),
        flush=True)
    print(device_report(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
