"""CLI: environment + dataset diagnostics ("is this box ready to train?").

The port's counterpart of `avtubes/cli/doctor.py`.  Checks run in dependency
order and each prints one PASS/WARN/FAIL line:

  toolchain   g++ present, the port's native IO core builds and loads (and
              by which libjpeg route)
  device      a CUDA card visible to torch: its name and count (FAIL without
              one, unless --device cpu)
  metadata    split CSVs / vggss.json resolvable (vendored fallback)
  data        spot-decode of the first N samples of each referenced tree,
              through the port's own loaders
  throughput  host decode rate on the spot-checked samples (clips/s/core)

Exit code: 0 all PASS/WARN, 1 any FAIL.

    python -m avtubes_torch.cli.doctor [--data_path ...] [--og_data_path ...] \
        [--testset flickr] [--metadata_dir metadata] [--spot 8] \
        [--device cuda|cpu] [--skip_device]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


class Checks:
    """The PASS/WARN/FAIL lines of one run, and whether any failed."""

    def __init__(self):
        self.failed = False

    def report(self, status: str, name: str, detail: str) -> None:
        if status == "FAIL":
            self.failed = True
        print(f"[{status:4s}] {name:10s} {detail}", flush=True)


def check_toolchain(checks: Checks) -> None:
    import shutil

    from avtubes_torch import native

    if shutil.which("g++") is None:
        checks.report("WARN", "toolchain", "g++ not found - Python IO fallbacks only")
    if native.available():
        info = native.build_info()
        checks.report("PASS", "toolchain", f"native IO core loaded ({info['library']}, "
                      f"libjpeg route {info['route']}, headers ABI "
                      f"{info['jpeg_lib_version']} / libjpeg-turbo "
                      f"{info['libjpeg_turbo_headers']})")
    else:
        checks.report("WARN", "toolchain", "native core unavailable (build failed or "
                      f"{native.KILL_SWITCH} set) - Python fallbacks in use, host "
                      "decode will be several times slower")


def check_device(checks: Checks, device: str) -> None:
    import torch

    if device == "cpu":
        checks.report("PASS", "device", f"--device cpu: the CPU (torch {torch.__version__})")
        return
    if not torch.cuda.is_available():
        checks.report("FAIL", "device", "no CUDA card visible (torch.cuda.is_available() "
                      "is False); --device cpu checks a host without one")
        return
    n = torch.cuda.device_count()
    names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
    checks.report("PASS", "device", f"{n} card(s): {', '.join(names)} "
                  f"(torch {torch.__version__}, CUDA {torch.version.cuda})")


def check_metadata(checks: Checks, metadata_dir: str, testset: str) -> None:
    from avtubes_torch.data.index import load_split, resolve_metadata_dir

    try:
        resolved = resolve_metadata_dir(metadata_dir)
    except Exception as e:  # noqa: BLE001 - any failure is the finding
        checks.report("FAIL", "metadata", f"no metadata dir resolvable: {e}")
        return
    try:
        split = "test_hardway" if testset == "flickr" else "test"
        test_ids = load_split(resolved, testset, split)
        train_ids = load_split(resolved, testset, "train") if testset == "flickr" else []
        detail = f"{resolved}: {len(test_ids)} test ids"
        if train_ids:
            detail += f", {len(train_ids)} train ids"
        checks.report("PASS", "metadata", detail)
    except Exception as e:  # noqa: BLE001
        checks.report("FAIL", "metadata", f"split load failed from {resolved}: {e}")


def _spot_decode_train(checks: Checks, data_path: Path, n: int) -> None:
    """Decode the frames + audio of up to n training clips, timed."""
    import numpy as np

    from avtubes_torch.data.audio import prepare_waveform, read_wav
    from avtubes_torch.data.transforms import host_load_train_clip

    vids = sorted((data_path / "videos").glob("*/"))[:n]
    if not vids:
        checks.report("FAIL", "data", f"{data_path}/videos has no clip directories")
        return
    rng = np.random.RandomState(0)
    ok = bad = 0
    t0 = time.perf_counter()
    for vd in vids:
        frames = sorted(vd.glob("*.jpg"))
        wav = data_path / "audio" / f"{vd.name}.wav"
        try:
            if not frames or not wav.exists():
                raise FileNotFoundError(f"{vd.name}: frames={len(frames)} "
                                        f"wav={wav.exists()}")
            host_load_train_clip([str(p) for p in frames], rng)
            samples, sr = read_wav(wav)
            prepare_waveform(samples, sr, 10)
            ok += 1
        except Exception:  # noqa: BLE001 - counted, reported below
            bad += 1
    dt = time.perf_counter() - t0
    status = "PASS" if bad == 0 else ("WARN" if ok else "FAIL")
    rate = f", {ok / dt:.0f} clips/s/core decode" if ok and dt > 0 else ""
    checks.report(status, "data", f"train tree {data_path}: {ok}/{ok + bad} clips "
                  f"spot-decoded{rate}")


def _spot_decode_eval(checks: Checks, og_path: Path, n: int) -> None:
    from avtubes_torch.data.transforms import host_load_eval_frame

    frames = sorted((og_path / "frames").glob("*.jpg"))[:n]
    if not frames:
        checks.report("FAIL", "data", f"{og_path}/frames has no JPEGs")
        return
    ok = bad = 0
    for p in frames:
        try:
            host_load_eval_frame(p)
            ok += 1
        except Exception:  # noqa: BLE001
            bad += 1
    status = "PASS" if bad == 0 else ("WARN" if ok else "FAIL")
    checks.report(status, "data", f"eval tree {og_path}: {ok}/{ok + bad} frames "
                  "spot-decoded")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_path", default="", help="training tree root")
    p.add_argument("--og_data_path", default="", help="hard-way eval tree root")
    p.add_argument("--testset", default="flickr")
    p.add_argument("--metadata_dir", default="metadata")
    p.add_argument("--spot", default=8, type=int, help="samples per tree")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) needs a card; 'cpu' checks a host without one")
    p.add_argument("--skip_device", action="store_true",
                   help="skip the device check")
    a = p.parse_args(argv)

    checks = Checks()
    check_toolchain(checks)
    if a.skip_device:
        checks.report("WARN", "device", "skipped (--skip_device)")
    else:
        check_device(checks, a.device)
    check_metadata(checks, a.metadata_dir, a.testset)
    if a.data_path:
        _spot_decode_train(checks, Path(a.data_path), a.spot)
    if a.og_data_path:
        _spot_decode_eval(checks, Path(a.og_data_path), a.spot)
    if not a.data_path and not a.og_data_path:
        checks.report("WARN", "data", "no --data_path/--og_data_path given - "
                      "data trees not checked")
    print("doctor:", "FAIL" if checks.failed else "OK")
    return 1 if checks.failed else 0


if __name__ == "__main__":
    sys.exit(main())
