"""The device trace of a traced run, and the arithmetic the per-layer
metrics read from it.

`Capture` wraps a stretch of work in `torch.profiler`: on the card CUPTI's
kernels, copies, sets and CUDA runtime calls, and the traced window runs
from the first CUDA call to the closing synchronise; off it, the host
operators inside one annotation, `perfbench.window`.  The trace is
exported once, read, and its file deleted.

Device busy time is the UNION of the device's kernel, copy and set
intervals inside the window, so work on overlapping streams counts once.
An idle gap is a stretch of the window in which none of them ran; it is
named by the innermost host event at its middle (a CUDA runtime call, or
off the card an operator or one of the benchmark's own annotations), or
else by the one that overlaps it most, or as host code between CUDA calls;
gaps under `SHORT_GAP_US` are pooled as launch gaps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict

WINDOW = "perfbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SHORT_GAP_US = 5.0
SHORT_GAP_NAME = "launch gaps under 5 us"
NAME_CHARS = 120
NO_HOST_EVENT = "host code between CUDA calls"


@dataclasses.dataclass
class Trace:
    """Intervals in microseconds of the trace's clock."""

    window: tuple[float, float]
    device: list[tuple[float, float, str, str]]     # (start, end, name, category)
    host: list[tuple[float, float, str]]            # (start, end, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self, symbols: tuple[str, ...] = ()) -> list[tuple[float, float, str]]:
        """The kernel intervals, or those whose name holds one of `symbols`."""
        return [(s, e, n) for s, e, n, c in self.device if c == "kernel"
                and (not symbols or any(sym in n for sym in symbols))]


def parse_chrome_trace(events: list[dict]) -> Trace:
    """The window, device and host intervals of a Chrome trace's events."""
    window = None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat, name = e.get("cat", ""), str(e.get("name", ""))
        if name == WINDOW and cat == "user_annotation":
            window = (start, end)
        elif cat in DEVICE_CATEGORIES:
            device.append((start, end, name, cat))
        elif cat in HOST_CATEGORIES:
            host.append((start, end, name))
    if window is None:
        # a card's trace without host operators: from the first CUDA call
        # to the end of the last (the closing synchronise) or of the last
        # device operation
        spans = [(s, e) for s, e, _ in host] + [(s, e) for s, e, _, _ in device]
        if not spans:
            raise ValueError(f"the trace has no {WINDOW!r} annotation and no events")
        window = (min(s for s, _ in spans), max(e for _, e in spans))
    w0, w1 = window
    device = sorted((max(s, w0), min(e, w1), n, c) for s, e, n, c in device if e > w0 and s < w1)
    host.sort()
    return Trace(window, device, host)


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted intervals."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(trace: Trace) -> float:
    return sum(e - s for s, e in union([(s, e) for s, e, _, _ in trace.device])) / 1e6


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """The stretches of the window with nothing on the device."""
    gaps, cursor = [], trace.window[0]
    for s, e in union([(s, e) for s, e, _, _ in trace.device]):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if trace.window[1] > cursor:
        gaps.append((cursor, trace.window[1]))
    return gaps


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def gap_names(trace: Trace) -> dict[str, float]:
    """Idle seconds by the host event that was running in each gap: the
    shortest one that holds the gap's middle, else the one that overlaps
    the gap most."""
    host = [h for h in trace.host if h[2] != WINDOW]     # sorted by start
    out: dict[str, float] = defaultdict(float)
    active: list[tuple[float, float, str]] = []
    taken = 0
    for g0, g1 in idle_gaps(trace):                      # sorted, disjoint
        if g1 - g0 < SHORT_GAP_US:
            out[SHORT_GAP_NAME] += (g1 - g0) / 1e6
            continue
        # a sweep: the host events that began before the gap's end and
        # have not ended before its start
        while taken < len(host) and host[taken][0] < g1:
            active.append(host[taken])
            taken += 1
        active = [h for h in active if h[1] > g0]
        mid = (g0 + g1) / 2
        best, best_key = NO_HOST_EVENT, (0, 0.0, 0.0)
        for s, e, name in active:
            ov = _overlap(g0, g1, s, e)
            if ov <= 0:
                continue
            key = (1, -(e - s), ov) if s <= mid <= e else (0, ov, -(e - s))
            if key > best_key:
                best, best_key = name, key
        out[best[:NAME_CHARS]] += (g1 - g0) / 1e6
    return dict(out)


def device_ops(trace: Trace) -> dict[str, float]:
    """Device seconds by kernel, copy or set name."""
    out: dict[str, float] = defaultdict(float)
    for s, e, name, _ in trace.device:
        out[name[:NAME_CHARS]] += (e - s) / 1e6
    return dict(out)


def top(d: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(trace: Trace) -> dict:
    return {"device_ops": top(device_ops(trace)), "idle_gaps": top(gap_names(trace))}


class Capture:
    """`with Capture(device) as cap:` profiles the block; `cap.trace` is
    the parsed trace afterwards.  The block's work is waited for before the
    window closes."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity

        self.device = device
        # on the card CUPTI's activity alone (kernels, copies, sets and the
        # CUDA runtime calls): recording every host operator as well slows
        # the host enough to idle the card (a flagship step on an H100 read
        # 30-38 % idle so, against about 3 % by CUDA events)
        self.activities = ([ProfilerActivity.CUDA] if device.type == "cuda"
                           else [ProfilerActivity.CPU])
        self.trace: Trace | None = None
        self._torch = torch

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)

    def __enter__(self) -> "Capture":
        from torch.profiler import profile, record_function

        self._sync()
        self._prof = profile(activities=self.activities)
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.trace = parse_chrome_trace(events)
