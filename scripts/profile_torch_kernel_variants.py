#!/usr/bin/env python3
"""What each part of the hand-written kernels costs on the card.

    python3 scripts/profile_torch_kernel_variants.py [k1] [k2] [k3]

Needs one CUDA card and `nvcc`.  For K1 (`csrc/stft.cu`, the FFT kernel at
the serving shape (8, 220500) float32) and K2 (`csrc/median_select.cu` at
(8, 224, 224), a random map and a constant one) and K3
(`csrc/correlation.cu`, forward and both gradients in one launch, at the
pretrainer's (20, 28, 28, 96) maps and at the (300, 28, 28, 96) of a batch of
clips) it builds copies of the source with one part taken out or swapped — the results of those copies are
WRONG, only their times mean something — and times each like
`chip_smoke.py`'s `kernel_ms`: calls enqueued behind a sleeping stream, so
the host's launch rate is not in the reading.  The difference to `base` is
what the part costs; `launch_floor` is a kernel that returns at once.

An edit is a (text, replacement) pair and the script stops if the text is no
longer in the source, so it cannot silently measure the wrong thing.  Prints
one JSON object per kernel (all three, or those named), then the card's name
and power limit.
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
from avtubes_torch.ops import correlation as k3
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

_FMAS = {
    "dot4": "    acc = fmaf(a.x, v.x, acc);\n    acc = fmaf(a.y, v.y, acc);\n"
            "    acc = fmaf(a.z, v.z, acc);\n    acc = fmaf(a.w, v.w, acc);\n",
    "axpy4": "    acc.x = fmaf(w, v.x, acc.x);\n    acc.y = fmaf(w, v.y, acc.y);\n"
             "    acc.z = fmaf(w, v.z, acc.z);\n    acc.w = fmaf(w, v.w, acc.w);\n",
}
K3_VARIANTS = {
    "base": [],
    # both tiled kernels begin with this line
    "launch_floor": [("    const int tiles = g.tiles_x * g.tiles_y;\n",
                      "    if (g.H > 0) return;\n    const int tiles = g.tiles_x * g.tiles_y;\n")],
    # no FMAs, hence no shared-memory operand reads either: the cp.async
    # copies, the coefficient staging, the barriers and the stores remain
    "no_arithmetic": [(_FMAS["dot4"], ""), (_FMAS["axpy4"], "")],
    # a condition the compiler cannot fold, so that the sums are still computed
    "no_store": [("for (int e = threadIdx.x; e < valid; e += blockDim.x) dst[e] = srow[e];",
                  "for (int e = threadIdx.x; e < valid - (1 << 30); e += blockDim.x) "
                  "dst[e] = srow[e];"),
                 ("if (active && row < g.H && col0 + jj < g.W && c < g.C)",
                  "if (active && row < g.H - (1 << 30) && col0 + jj < g.W && c < g.C)")],
    # the plan chooses between one buffer and a ring of two, the next chunk in
    # flight under the sums: here it may take only the one or only the other
    "one_buffer_only": [("for (int stages = 1; stages <= 2; ++stages) {",
                         "for (int stages = 1; stages <= 1; ++stages) {")],
    "ring_of_two_only": [("for (int stages = 1; stages <= 2; ++stages) {",
                          "for (int stages = 2; stages <= 2; ++stages) {")],
    "chunks_of_16": [("constexpr int CK = 32; ", "constexpr int CK = 16; "),
                     ("constexpr int CKP = 36; ", "constexpr int CKP = 20; ")],
    # tiles of at most 4 rows, whatever the number of waves
    "tiles_of_4_rows": [("for (int th = 1; th <= H && th <= TILED_THREADS; ++th) {",
                         "for (int th = 1; th <= H && th <= 4; ++th) {")],
    # only the first chunk is copied: the sums alone, on stale operands
    "first_chunk_copied_only": [("if (ch + NSTAGE - 1 < nch) copy_chunk(ch + NSTAGE - 1);",
                        "if (ch + NSTAGE - 1 < nch - (1 << 30)) copy_chunk(ch + NSTAGE - 1);")],
    # the gf1 blocks first in the fused backward (as built: the dearer gf2 blocks)
    "gf1_blocks_first": [("const bool mirror = mode == 2 ? blockIdx.y == 0 : mode == 1;",
                          "const bool mirror = mode == 2 ? blockIdx.y == 1 : mode == 1;")],
    # blocks of the f2 gradient copy their own tile of the cotangent instead
    # of gathering the mirrored patch
    "no_mirrored_patch": [("    if (mirror) {\n        // a warp per row",
                           "    if (mirror && g.H < 0) {\n        // a warp per row")],
    # the row-segment kernels at the same shapes, for comparison
    "row_segment_kernels": [("const bool tiled_allowed = stride == 1 && aligned;",
                             "const bool tiled_allowed = false;")],
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
    wanted = set(sys.argv[1:]) or {"k1", "k2", "k3"}
    if not wanted <= {"k1", "k2", "k3"}:
        print(f"unknown kernel in {sorted(wanted)}: name k1, k2, k3", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = SpectrogramConfig()
    rng = np.random.RandomState(0)
    wav = torch.from_numpy(
        np.clip(rng.randn(8, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)).to(dev)
    maps = torch.from_numpy(
        np.random.default_rng(0).random((8, 224, 224), dtype=np.float32)).to(dev)
    constant = torch.zeros_like(maps)
    k_med = 224 * 224 // 2
    if "k1" in wanted:
        print(json.dumps({"kernel": "K1 log_spectrogram_cuda (8, 220500) float32",
                          "ms": time_variants("stft", K1_VARIANTS, {
                              "float32": lambda: queued_ms(
                                  lambda: k1.log_spectrogram_cuda(wav, cfg))})}), flush=True)
    if "k2" in wanted:
        print(json.dumps({"kernel": "K2 median_mask_cuda (8, 224, 224)",
                          "ms": time_variants("median_select", K2_VARIANTS, {
                              "generic": lambda: queued_ms(
                                  lambda: k2.median_mask_cuda(maps, k_med)),
                              "all_equal": lambda: queued_ms(
                                  lambda: k2.median_mask_cuda(constant, k_med))})}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    timers = {}
    for batch in (20, 300):
        f1, f2 = (torch.randn((batch, 28, 28, 96), generator=gen, device=dev) for _ in "12")
        cot = torch.randn((batch, 28, 28, 81), generator=gen, device=dev)
        timers[f"forward_batch{batch}"] = (lambda f1=f1, f2=f2: queued_ms(
            lambda: k3.correlation_forward_cuda(f1, f2, 4, 1), iters=20))
        timers[f"backward_both_batch{batch}"] = (lambda f1=f1, f2=f2, cot=cot: queued_ms(
            lambda: k3.correlation_backward_both_cuda(cot, f1, f2, 4, 1), iters=20))
    if "k3" in wanted:
        print(json.dumps({"kernel": "K3 correlation (B, 28, 28, 96), max_disp 4",
                          "ms": time_variants("correlation", K3_VARIANTS, timers)}), flush=True)
    print(device_report(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
