"""One run of one benchmark cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run builds the cell's system from the
seed, warms it, measures for `--seconds`, and with `--trace 1` profiles a
further stretch of the same traffic; the generator's `replay` then runs
what its check compares through the same warmed path.  Then the run
frees the program's state, checks what the timed path produced against the
plain reference, and prints one JSON line last on standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "checks"}

`metrics` holds the cell's end-to-end metrics (`--trace 0`) or its
per-layer ones (`--trace 1`), each read by `perfbench/metrics/<name>.py`.
The set-up's parts go to standard error first, and each number the check
compared, beside its limit, goes there last.  Without as many CUDA cards as
the cell asks for, or with the JAX stack or the JAX package loaded by the
end, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import gc
import importlib
import json
import subprocess
import sys
import time

from perfbench import harness
from perfbench.reference.arith import exact_float32

#: the set-up clock: the process's age here, by the kernel's clock (the
#: interpreter's start and the imports above, torch among them), and the
#: host clock from here on
AGE_AT_START = harness.process_age_s()
STARTED = time.perf_counter()
#: seconds after which a run is taken for hung (a run takes about one minute)
WATCHDOG_S = 340


@dataclasses.dataclass
class RunData:
    """What a metric's reader reads."""

    cell: harness.Cell
    kind: str                   # the traffic's KIND, such as 'train'
    setup_s: float
    window: dict                # the generator's window record
    tail: dict | None           # the traced stretch's record (--trace 1)
    trace: object | None        # its `perfbench.trace.Trace`
    peaks: dict | None          # `perfbench.peaks` of the card, None off it


def power_limit() -> str:
    """`nvidia-smi`'s name and power limit of every card, one line each."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().replace("\n", "; ")


def read_metrics(run: RunData, trace: bool) -> dict:
    out = {}
    for m in run.cell.metrics(trace):
        reader = harness.load_file_module(harness.BENCH_DIR / "metrics" / f"{m['name']}.py")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            overrides: dict | None = None) -> dict:
    """The run, short of printing.  `device` other than 'cuda' and
    `overrides` are for the benchmark's own tests."""
    clock = harness.SetupClock(STARTED)
    cell = harness.load_cell(workload, overrides)
    gen = harness.load_file_module(harness.BENCH_DIR / "traffic"
                                   / f"{cell.spec['generator']}.py")
    import torch

    for module in gen.PROGRAM_MODULES:
        importlib.import_module(module)
    clock.lap("import")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    clock.lap("cuda_init")
    built = {}
    if dev.type == "cuda":
        from avtubes_torch.ops._build import build

        built = build(tuple(cell.spec["kernels"]))
    clock.lap("build_or_cache")
    ctx = harness.Context(cell, seed, dev, clock)
    state = gen.setup(ctx)
    setup_s = AGE_AT_START + time.perf_counter() - STARTED
    print(f"perfbench: setup_s {setup_s} parts "
          f"{json.dumps({'interpreter_and_torch': AGE_AT_START, **clock.parts})} "
          f"nvcc_s {json.dumps(built)}", file=sys.stderr)

    phases = harness.SetupClock(time.perf_counter())
    window = gen.window(ctx, state, seconds)
    phases.lap("window")
    tail = trace_data = None
    if trace:
        from perfbench.trace import Capture

        capture = Capture(dev)
        tail = gen.traced(ctx, state, capture)
        trace_data = capture.trace
        phases.lap("trace")
    gen.replay(ctx, state)
    phases.lap("replay")
    peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    gen.release(ctx, state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    exact_float32()
    checks = gen.check(ctx, state, window)
    phases.lap("check")
    print(f"perfbench: after set-up {json.dumps(phases.parts)}", file=sys.stderr)

    from perfbench import peaks

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = RunData(cell, gen.KIND, setup_s, window, tail, trace_data, peaks.for_device(kind))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": cell.entry["chips"], "memory_peak_bytes": int(peak_bytes)}
    breakdown = None
    if trace_data is not None:
        from perfbench.trace import breakdown as make_breakdown, busy_seconds

        device_info["busy_s"] = busy_seconds(trace_data)
        device_info["window_s"] = trace_data.window_s
        breakdown = make_breakdown(trace_data)
    failed = int(window["failed"])
    return {"correct": failed == 0 and all(c.passed for c in checks),
            "attempted": int(window["attempted"]), "failed": failed,
            "metrics": read_metrics(run, trace), "device": device_info,
            "breakdown": breakdown, "checks": checks}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    a = p.parse_args(argv)
    if a.seed < 0:
        p.error("--seed must be a non-negative integer")
    # a run that hangs prints every thread's stack and exits non-zero
    # instead of holding the card
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    harness.set_cache_dirs()
    cell = harness.load_cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"perfbench: {a.workload} needs {cell.entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    out = execute(a.workload, a.seed, a.seconds, bool(a.trace))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"perfbench: the run loaded {loaded}, which the port must not", file=sys.stderr)
        return 4
    print(f"perfbench: card {power_limit()}", file=sys.stderr)
    for c in out["checks"]:
        print(f"perfbench check: {c.name} {c.value} limit {c.limit} "
              f"{'ok' if c.passed else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"],
                              out["device"], out["breakdown"], out["checks"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
