"""What every cell's run shares: the manifest and the files it names, the
run's context, the checks against the plain reference, the set-up clock,
the guard against the JAX package, and the result line.

A cell is found by its name alone:

  BENCHMARK.json                 its entry under "workloads" (configuration,
                                 traffic, chips) and the metrics it reports;
  perfbench/workloads/<cell>.json  the traffic's generator and parameters,
                                 and the limits of its checks;
  perfbench/configs/<config>.json  the model configuration as it is run;
  perfbench/traffic/<generator>.py the general generator of that traffic:
                                 KIND, PROGRAM_MODULES, setup, window,
                                 traced, replay, release and check;
  perfbench/metrics/<metric>.py    one reader a metric.

So a new cell, configuration, traffic mix or metric is a new file and a new
entry in BENCHMARK.json, and no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that no run may load: the JAX stack and the JAX
#: package the port was made from (compared whole: `avtubes_torch` is the port)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "avtubes")
#: build and kernel caches, at fixed paths inside the checkout
CACHE_DIR = ROOT / ".perfbench_cache"


class NoCard(RuntimeError):
    """The run asked for more CUDA cards than this machine shows."""


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's clock (Linux)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def set_cache_dirs() -> None:
    """Point every compiler cache a run may touch at a fixed directory of
    the checkout, so that only a checkout's first run builds.  (The
    program's own CUDA kernels are built into `avtubes_torch/_build/`,
    inside the checkout too.)"""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        path = CACHE_DIR / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that belong to the JAX stack or
    the JAX package."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: Path) -> ModuleType:
    """Import a file of the benchmark by its path (a metric's file name may
    hold dots)."""
    name = "perfbench_file_" + "_".join(path.relative_to(BENCH_DIR).with_suffix("").parts
                                        ).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def subseed(seed: int, *keys: str | int) -> int:
    """A 63-bit seed for one use of the run's seed (any non-negative
    integer, however large)."""
    words = [int(seed)] + [int(k) if isinstance(k, int) else
                           int.from_bytes(k.encode(), "little") for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Cell:
    """One entry of `workloads` with its files."""

    name: str
    entry: dict           # the BENCHMARK.json entry
    spec: dict            # perfbench/workloads/<name>.json
    config: dict          # perfbench/configs/<config>.json
    manifest: dict        # the whole BENCHMARK.json

    @property
    def params(self) -> dict:
        return self.spec["params"]

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        `trace` its per-layer ones."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell `name` from BENCHMARK.json and its files; `overrides`
    ({"params": {...}, "config": {...}}, tests only) replaces entries.  A
    cell file that BENCHMARK.json does not list yet is its own entry: it
    runs, and no metric names it."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    spec = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    entry = entries[0] if entries else {"name": name, **{k: spec[k] for k in (
        "config", "traffic", "chips", "why")}}
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"perfbench/workloads/{name}.json has {key}={spec[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    configs = [c for c in manifest["configs"] if c["name"] == entry["config"]]
    if len(configs) != 1:
        raise KeyError(f"no config {entry['config']!r} in BENCHMARK.json")
    config = load_json(ROOT / configs[0]["file"])
    for key, part in (overrides or {}).items():
        target = spec["params"] if key == "params" else config
        for k, v in part.items():
            if isinstance(v, dict) and isinstance(target.get(k), dict):
                target[k] = {**target[k], **v}
            else:
                target[k] = v
    return Cell(name, entry, spec, config, manifest)


class SetupClock:
    """The parts of the set-up, each timed by the host clock."""

    def __init__(self, started: float):
        self.started = started            # time.perf_counter() at the first line
        self.parts: dict[str, float] = {}
        self._last = started

    def lap(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self._last
        self._last = now


@dataclasses.dataclass
class Context:
    """What a traffic generator is handed."""

    cell: Cell
    seed: int
    device: "torch.device"  # noqa: F821 - imported by the caller
    clock: SetupClock
    variant: str = "program"     # "program", or "control" (the readings only)

    @property
    def params(self) -> dict:
        return self.cell.params

    @property
    def config(self) -> dict:
        return self.cell.config


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def limits_of(cell: Cell) -> dict:
    return cell.spec["limits"]


def relative_gap(value: float, ref: float) -> float:
    return abs(value - ref) / max(abs(ref), 1e-30)


def leaf_gaps(program: dict, reference: dict, leaves: list[str]) -> dict:
    """Each leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median leaf's;
    a leaf the program did not report, or reported as NaN, reads infinity."""
    median = float(np.median([reference[k] for k in leaves]))
    gaps = {k: abs(program.get(k, math.inf) - reference[k]) / max(reference[k], median, 1e-30)
            for k in leaves}
    return {k: math.inf if math.isnan(v) else v for k, v in gaps.items()}


def worst_leaf_gap(program: dict, reference: dict, leaves: list[str]) -> tuple[float, str]:
    """The largest of `leaf_gaps`, and its leaf."""
    gaps = leaf_gaps(program, reference, leaves)
    which = max(gaps, key=gaps.get, default="")
    return gaps.get(which, 0.0), which


def median_leaf_gap(program: dict, reference: dict, leaves: list[str]) -> float:
    """The median of `leaf_gaps`."""
    return float(np.median(list(leaf_gaps(program, reference, leaves).values())))


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                breakdown: dict | None, checks: list[Check]) -> str:
    """The run's last line of standard output; the checks come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(out)
