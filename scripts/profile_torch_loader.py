#!/usr/bin/env python3
"""Host decode rates of the port's real-data loaders, native and Python.

    python3 scripts/profile_torch_loader.py [--clips 40] [--threads 5,0]
                                            [--out FILE]

Writes a tree of photo-like 480x640 JPEGs (smooth gradients plus mild
noise: `write_synthetic_dataset(photo=True)`), `--clips` training clips of
16 frames and as many hard-way frames, with 10 s WAVs at 22.05 kHz, then
times, each with the port's native IO core and with
AVTUBES_TORCH_NO_NATIVE=1 (PIL and numpy), at every `--threads` count (0 =
the machine's CPU count):

  * one 480x640 JPEG -> 246 shortest side (the recipe's 1.1 x 224): PIL,
    native DCT-scaled, native full resolution (ms a JPEG, one thread);
  * `ClipTrainSource` + `BatchLoader` at the recipe clip (16 frames, 246
    shortest side, one 224 crop, batch 20): clips/s and JPEGs/s;
  * `make_hardway_loader` in both modes (`per_sample`, `batched`) and the
    `int16` and `spec_int16` transports (224 crop, batch 20): clips/s.

Prints one JSON line per measurement and a last line with all of them; with
`--out` the same object goes to FILE.  Host only: it needs no card, but the
numbers to keep are those of the card's machine (its name and power limit
are printed beside them where `nvidia-smi` is there).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from avtubes_torch import native
from avtubes_torch.core.config import DataConfig
from avtubes_torch.data.pipeline import BatchLoader, ClipTrainSource, make_hardway_loader
from avtubes_torch.data.synthetic import write_synthetic_dataset
from avtubes_torch.data.transforms import host_resize_shortest, open_rgb

FRAMES, IMAGE, SHORT, BATCH = 16, 224, int(224 * 1.1), 20


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip() or "no card"
    except (OSError, subprocess.TimeoutExpired):
        return "no card"


def per_jpeg_ms(path: str, reps: int = 20) -> dict[str, float]:
    def best(fn) -> float:
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    return {"pil_ms": best(lambda: np.asarray(host_resize_shortest(open_rgb(path), SHORT))),
            "native_scaled_ms": best(lambda: native.decode_jpeg_shortest(path, SHORT, 0, True)),
            "native_full_ms": best(lambda: native.decode_jpeg_shortest(path, SHORT, 0, False))}


def drain(loader) -> tuple[int, float]:
    t0 = time.perf_counter()
    n = sum(len(b["id"]) for b in loader.epoch(0))
    return n, time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--clips", type=int, default=40)
    p.add_argument("--threads", default="5,0", help="comma list; 0 = os.cpu_count()")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    threads = [int(t) or os.cpu_count() for t in a.threads.split(",")]
    if not native.available():
        print("profile_torch_loader: the native IO core did not build", file=sys.stderr)
        return 1
    report = {"card": card(), "cpu_count": os.cpu_count(),
              "affinity": len(os.sched_getaffinity(0)), "native": native.build_info(),
              "clips": a.clips, "frames": FRAMES, "jpeg_hw": [480, 640], "rows": []}

    def emit(row: dict) -> None:
        report["rows"].append(row)
        print(json.dumps(row), flush=True)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ids = write_synthetic_dataset(root, n_videos=a.clips, frames=FRAMES, seconds=10,
                                      image_hw=(480, 640), photo=True)
        report["write_tree_s"] = time.perf_counter() - t0
        emit({"what": "one_jpeg_to_246", **per_jpeg_ms(os.path.join(root, "frames",
                                                                   f"{ids[0]}.jpg"))})
        for decode in ("native", "python"):
            if decode == "python":
                os.environ[native.KILL_SWITCH] = "1"
            else:
                os.environ.pop(native.KILL_SWITCH, None)
            for n_threads in threads:
                cfg = DataConfig(image_size=IMAGE, frame_density=FRAMES, n_threads=n_threads)
                loader = BatchLoader(ClipTrainSource(root, ids, cfg), BATCH,
                                     num_workers=n_threads, shuffle=False)
                n, dt = drain(loader)
                emit({"what": "train_clip_loader", "decode": decode, "threads": n_threads,
                      "transport": cfg.audio_transport, "clips": n, "clips_per_s": n / dt,
                      "jpegs_per_s": n * FRAMES / dt})
                for transport in ("int16", "spec_int16"):
                    cfg = DataConfig(image_size=IMAGE, n_threads=n_threads,
                                     audio_transport=transport)
                    for mode in ("per_sample", "batched"):
                        loader = make_hardway_loader(root, ids, cfg, BATCH,
                                                     num_workers=n_threads, mode=mode)
                        n, dt = drain(loader)
                        emit({"what": "hardway_loader", "decode": decode, "mode": mode,
                              "ran_as": type(loader).__name__, "threads": n_threads,
                              "transport": transport, "clips": n, "clips_per_s": n / dt})
        os.environ.pop(native.KILL_SWITCH, None)
    print(json.dumps(report), flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
