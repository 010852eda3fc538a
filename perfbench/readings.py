"""The readings a cell's limits are set from: the numbers its check
compares, for the program and for the lower-precision control, over many
seeds in one process.  The benchmark's own runs never run this.

    python3 -m perfbench.readings --workload <cell> \
        --side program|control|half_batch --seeds 1,2,3

program  the cell's set-up and its replayed checked steps, then the
         check against the float32 reference, as a run does;
control  the reference itself in float8 (`reference/arith.py`) put in
         the program's place, against the float32 reference;
half_batch  a fault: the reference on the first half of each batch's rows
         (the mean over them) put in the program's place.
One JSON line a seed: the compared numbers and what the worst of them was.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from perfbench import harness
from perfbench.reference.arith import exact_float32


def reading(cell: harness.Cell, gen, seed: int, side: str, device: torch.device) -> dict:
    ctx = harness.Context(cell, seed, device, harness.SetupClock(time.perf_counter()),
                          variant=side)
    details: dict = {}
    if side == "control":
        program = gen.reference_steps(ctx, precision="fp8")
    elif side == "half_batch":
        program = gen.reference_steps(ctx, rows=cell.params["batch"] // 2)
    else:
        st = gen.setup(ctx)
        gen.replay(ctx, st)
        program = st.checked
        gen.release(ctx, st)
        del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    exact_float32()
    checks = gen.compare(ctx, program, gen.reference_steps(ctx), details)
    details["program_losses"] = [s["loss"] for s in program["losses"]]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "side": side, **{c.name: c.value for c in checks}, **details}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", required=True, choices=("program", "control", "half_batch"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.load_cell(a.workload)
    gen = harness.load_file_module(harness.BENCH_DIR / "traffic"
                                   / f"{cell.spec['generator']}.py")
    device = torch.device(a.device)
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(reading(cell, gen, seed, a.side, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
