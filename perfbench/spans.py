"""The program's spans of a traced run, placed on the device trace's clock,
and the arithmetic the `program_span` metrics read from them.

The program (`avtubes_torch/utils/debug.py`) records one span tree a
training step while a `torch.profiler` session runs: the root `train.step`
and its parts `train.input`, `train.forward`, `train.backward` and
`train.optimizer`, each with its host interval (`time.time_ns()`) and on the
card a timing CUDA event pair.  The trace (`perfbench/trace.py`) drops its
clock's base, so the spans are placed on it by their anchors: each root
starts with one CUDA runtime call that launches nothing (the program's
`ANCHOR_CALL`, which CUPTI records) between two host-clock reads, and one
offset puts the anchors on the calls (`align`).  A step's misfit is how far
its aligned start lies from the first runtime call it makes; the worst goes
to standard error.

A program without the recorder (one older than it), a run without a trace,
or a trace without the anchor call yields no steps, and the readers then
read nothing.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import statistics
import sys

from perfbench.trace import idle_gaps

ROOT = "train.step"
PARTS = ("train.input", "train.forward", "train.backward", "train.optimizer")
#: idle inside a step but outside its parts
BETWEEN_PARTS = "train.step (between parts)"
#: how near an aligned anchor must lie to a call of its name to confirm it
MATCH_US = 50.0


@dataclasses.dataclass
class Step:
    """One traced step: its root span and parts (the program's `Span`s) and
    the root's interval on the trace's clock (microseconds)."""

    root: object
    parts: dict[str, object]
    start_us: float
    end_us: float
    misfit_us: float | None
    to_us: object            # host ns -> trace us


def recorded() -> tuple[list, str] | None:
    """The program's finished spans and the name of its anchor call, or
    None where the program has no recorder."""
    from avtubes_torch.utils import debug

    if not hasattr(debug, "finished_spans"):
        return None
    return debug.finished_spans(), debug.ANCHOR_CALL


def _mid_ns(pair: tuple[int, int]) -> int:
    return (pair[0] + pair[1]) // 2


def align(trace, roots: list, call: str):
    """host ns -> trace us, from the roots' anchors and the trace's `call`
    runtime calls; None if either is missing.  The anchor read most tightly
    (a session's first can take milliseconds) is tried against each call;
    the offset that the most anchors confirm within `MATCH_US` wins, and the
    median of its confirming anchors' offsets is taken."""
    anchored = [r.anchor_ns for r in roots if r.anchor_ns]
    calls = sorted((s + e) / 2 for s, e, name in trace.host if name == call)
    if not anchored or not calls:
        return None
    ref = min(anchored, key=lambda a: a[1] - a[0])
    ref_ns = _mid_ns(ref)

    def confirming(offset: float) -> list[float]:
        """The offsets of the anchors that a call confirms at `offset`."""
        out = []
        for a in anchored:
            t = offset + (_mid_ns(a) - ref_ns) / 1e3
            i = bisect.bisect_left(calls, t - MATCH_US)
            if i < len(calls) and calls[i] <= t + MATCH_US:
                out.append(calls[i] - (_mid_ns(a) - ref_ns) / 1e3)
        return out

    best = max((confirming(c) for c in calls), key=len)     # the first of equals
    offset = statistics.median(best)
    return lambda ns: offset + (ns - ref_ns) / 1e3


def _misfit_us(starts: list[float], at: float) -> float | None:
    """How far `at` lies from the start of the first host call that starts
    no earlier than `MATCH_US` before it."""
    i = bisect.bisect_left(starts, at - MATCH_US)
    return abs(starts[i] - at) if i < len(starts) else None


def steps_of(trace, spans: list, call: str) -> list[Step]:
    """The steps whose root overlaps the trace's window, in order."""
    roots = sorted((s for s in spans if s.name == ROOT and s.parent is None),
                   key=lambda s: s.host_start_ns)
    to_us = align(trace, roots, call)
    if to_us is None:
        return []
    children: dict[int, dict[str, object]] = {}
    for s in spans:
        if s.name in PARTS and s.parent is not None:
            children.setdefault(s.parent, {})[s.name] = s
    starts = [s for s, _, _ in trace.host]                 # sorted by start
    w0, w1 = trace.window
    out = []
    for r in roots:
        a, b = to_us(r.host_start_ns), to_us(r.host_end_ns)
        if b > w0 and a < w1:
            out.append(Step(r, children.get(r.id, {}), a, b, _misfit_us(starts, a), to_us))
    return out


_CACHE: dict[int, tuple[object, list[Step]]] = {}


def steps(run) -> list[Step]:
    """The traced steps of `run` (computed once a run; the alignment's
    misfit and the steps' device time against their parts' go to standard
    error then)."""
    if run.kind != "train" or run.trace is None:
        return []
    held = _CACHE.get(id(run))
    if held is not None and held[0] is run:
        return held[1]
    got = recorded()
    out = steps_of(run.trace, *got) if got is not None else []
    _CACHE[id(run)] = (run, out)
    if out:
        misfits = [s.misfit_us for s in out if s.misfit_us is not None]
        summary = {"steps": len(out), "anchor_call": got[1],
                   "misfit_us_worst": max(misfits, default=None),
                   "misfit_us_median": statistics.median(misfits) if misfits else None,
                   "step_device_ms_median": median([s.root.device_ms for s in out]),
                   "parts_device_ms_sum_median": median([
                       sum(p.device_ms for p in s.parts.values())
                       if s.parts and all(p.device_ms is not None for p in s.parts.values())
                       else None for s in out])}
        print(f"perfbench spans: {json.dumps(summary)}", file=sys.stderr)
    return out


def median(values: list) -> float | None:
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def part_device_ms(run, part: str) -> float | None:
    """The median over the traced steps of `part`'s device milliseconds."""
    return median([s.parts[part].device_ms for s in steps(run) if part in s.parts])


def is_sync(name: str) -> bool:
    """A runtime call in which the host waits for the device."""
    return name.endswith("Synchronize") or name in ("cudaMemcpy", "cudaMemcpyAsync")


def step_idle(per_step: dict[str, float]) -> float:
    """A step's idle milliseconds from its `idle_by_step` entry."""
    return sum(per_step[k] for k in (*PARTS, BETWEEN_PARTS))


def idle_by_step(run) -> list[dict[str, float]]:
    """Each traced step's idle milliseconds: the device's idle gaps (short
    ones included) whose middle falls inside the step's aligned root, by
    the part the middle falls in; `sync` sums those whose middle also lies
    inside a host call in which the host waited for the device."""
    out_steps = steps(run)
    if not out_steps:
        return []
    per = [dict.fromkeys((*PARTS, BETWEEN_PARTS, "sync"), 0.0) for _ in out_steps]
    starts = [s.start_us for s in out_steps]
    waits = [(s, e) for s, e, name in run.trace.host if is_sync(name)]
    for g0, g1 in idle_gaps(run.trace):
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0 or mid > out_steps[i].end_us:
            continue
        step, ms = out_steps[i], (g1 - g0) / 1e3
        part = next((name for name, p in step.parts.items()
                     if step.to_us(p.host_start_ns) <= mid <= step.to_us(p.host_end_ns)),
                    BETWEEN_PARTS)
        per[i][part] += ms
        if any(s <= mid <= e for s, e in waits):
            per[i]["sync"] += ms
    return per
