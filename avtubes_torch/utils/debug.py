"""Debug and tracing utilities (PyTorch).

Counterpart of `avtubes/utils/debug.py`:

  * `shape_report` lists a module's parameters and BatchNorm running
    statistics with their shapes and float32 bytes, as the JAX package's
    lists its variable tree (params + batch_stats).  The module is built on
    the `meta` device: no memory is allocated and nothing is computed.
  * `trace` runs a region under `torch.profiler` (CPU activity, and CUDA
    activity on the card) and writes a trace that TensorBoard's profile
    plugin reads (`tensorboard --logdir <log_dir>`), or chrome://tracing.
  * `StepTimer` times steps on the host's clock, `torch.cuda.synchronize`
    (where the JAX package blocks until ready) closing each step that ran
    on the card.
  * `span(name)` marks a part of a step.  It records only while a
    `torch.profiler` session runs (the profiler's own enabled flag is the
    gate: `trace`, `cli/profile.py`, a benchmark's traced stretch); off, it
    costs one flag read.  On, it opens the profiler's host range `name`, the
    one `torch.profiler.record_function(name)` opens (so traces that record
    host operators show it), reads the host clock (`time.time_ns()`, the
    clock of a Chrome trace once its `baseTimeNanoseconds` is added back)
    just before the range starts and just after it ends, and on a card
    records a timing CUDA event pair on the stream current as its root
    opened.  A span opened inside a span of the same name records nothing,
    so a fused step and the step it calls make one root.  A root span on a
    card starts with an anchor: `ANCHOR_CALL`, a CUDA runtime call that
    launches nothing, between its start and a second host-clock read, by
    which a trace that drops its base is put on the spans' clock.
    `finished_spans()` reads the spans kept (the newest `SPAN_CAP`); a
    span's device time is read from its events only then, after the
    session's closing synchronise, so spans add no wait inside a step.
    `span_table` prints them by name, with the device's idle time put down
    to the span the host was in.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import statistics
import tempfile
import threading
import time
from collections.abc import Callable, Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch import nn


def default_trace_dir() -> str:
    """`<temporary directory>/avtubes_torch_trace`."""
    return os.path.join(tempfile.gettempdir(), "avtubes_torch_trace")


def shape_report(build: Callable[..., nn.Module], *args, **kwargs) -> str:
    """Parameter and statistic shapes and float32 megabytes of the module
    `build(*args, **kwargs)` makes, built on the `meta` device.  One line a
    tensor, then a TOTAL line; BatchNorm's `num_batches_tracked` counter is
    left out (the JAX package's statistics have no counter)."""
    with torch.device("meta"):
        module = build(*args, **kwargs)
    named = [*module.named_parameters(),
             *((n, b) for n, b in module.named_buffers()
               if not n.endswith("num_batches_tracked"))]
    lines, total = [], 0
    for name, t in named:
        nbytes = t.numel() * 4                    # float32, as the JAX report counts
        total += nbytes
        lines.append(f"{name:60s} {str(tuple(t.shape)):24s} {nbytes / 1e6:8.3f} MB")
    lines.append(f"{'TOTAL':60s} {'':24s} {total / 1e6:8.3f} MB")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None, device: str | torch.device = "cuda"
          ) -> Iterator[str]:
    """Profile the region under `torch.profiler`: CPU activity, plus CUDA
    activity when `device` is a card.  On exit the trace is written into
    `log_dir` (default `default_trace_dir()`) as `<host>_<pid>.<ms>.pt.trace.json`,
    which TensorBoard's profile plugin reads.  Yields `log_dir`."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or default_trace_dir()
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


class StepTimer:
    """Rolling step times on the host's clock.  `tick(probe)` ends a step:
    when `probe` is a tensor on a card, the card is synchronized first, so
    the step's queued work is in its time."""

    def __init__(self) -> None:
        self._time = time.perf_counter
        self.history: list[float] = []
        self._last = self._time()

    def tick(self, probe: torch.Tensor | None = None) -> float:
        if probe is not None and probe.device.type == "cuda":
            torch.cuda.synchronize(probe.device)
        now = self._time()
        dt = now - self._last
        self._last = now
        self.history.append(dt)
        return dt

    def mean(self, last: int = 50) -> float:
        if not self.history:
            return math.nan
        recent = self.history[-last:]
        return sum(recent) / len(recent)


#: spans kept (a ring: the oldest drop out)
SPAN_CAP = 4096
#: the CUDA runtime call of a root span's clock anchor
#: (`torch.cuda.current_stream().query()`; it launches nothing)
ANCHOR_CALL = "cudaStreamQuery"


@dataclasses.dataclass
class Span:
    """A finished span.  Host times are `time.time_ns()`; `step` is the
    step id its root was given (`TrainState.step` at entry); `anchor_ns` is
    the pair of host reads around a root's `ANCHOR_CALL`."""

    name: str
    id: int
    parent: int | None
    step: int | None
    host_start_ns: int
    host_end_ns: int
    anchor_ns: tuple[int, int] | None = None
    events: tuple[torch.cuda.Event, torch.cuda.Event] | None = dataclasses.field(
        default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between the span's two events on its stream (None
        off a card); waits for the end event."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Recorder:
    """The finished spans and each thread's open ones."""

    def __init__(self, cap: int = SPAN_CAP):
        self.done: collections.deque[Span] = collections.deque(maxlen=cap)
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list[_OpenSpan]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDER = _Recorder()
_OFF = contextlib.nullcontext()


def _enter_range(name: str):
    """The profiler's host range `name`: the `RecordFunction` that
    `torch.profiler.record_function(name)` opens, entered without the
    operator call that wraps it there (on an H100's host 5 us with its exit
    against 14, and the range's start is stamped as the call begins, not
    tens of microseconds into it under CPU tracing)."""
    return torch._C._autograd._record_function_with_args_enter(name)


def _exit_range(handle) -> None:
    """Closes `_enter_range`'s range; its end is stamped as this returns."""
    torch._C._autograd._record_function_with_args_exit(handle)


class _OpenSpan:
    def __init__(self, name: str, step: int | None):
        self.name, self.step = name, step
        self.nested = False
        self.stream = None

    def __enter__(self) -> _OpenSpan:
        stack = _RECORDER.stack()
        parent = stack[-1] if stack else None
        if parent is not None and parent.name == self.name:
            self.nested = True
            return self
        self.parent = parent.id if parent is not None else None
        if self.step is None and parent is not None:
            self.step = parent.step
        self.id = next(_RECORDER.ids)
        self.anchor_ns = self.events = None
        cuda = torch.cuda.is_initialized()
        if cuda:
            # the stream current as the root opened, shared by its spans
            self.stream = (parent.stream if parent is not None and parent.stream is not None
                           else torch.cuda.current_stream())
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.start_ns = time.time_ns()
        if cuda and parent is None:
            self.stream.query()
            self.anchor_ns = (self.start_ns, time.time_ns())
        self.range = _enter_range(self.name)
        if cuda:
            self.events[0].record(self.stream)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        if self.nested:
            return
        if self.events is not None:
            self.events[1].record(self.stream)
        _exit_range(self.range)
        end_ns = time.time_ns()
        _RECORDER.stack().pop()
        _RECORDER.done.append(Span(self.name, self.id, self.parent, self.step, self.start_ns,
                                   end_ns, self.anchor_ns, self.events))


def span(name: str, step: int | None = None):
    """A context manager marking a part of a step; it records while a
    `torch.profiler` session runs, and off costs one flag read.  `step`
    (a root's) is inherited by the spans opened inside it."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _OpenSpan(name, step)


def finished_spans() -> list[Span]:
    """The spans kept, in the order they finished (children before their
    parent)."""
    return list(_RECORDER.done)


def clear_spans() -> None:
    _RECORDER.done.clear()


def _device_intervals_ns(trace_file: str) -> list[tuple[int, int]]:
    """The kernel, copy and set intervals of a Chrome trace that
    `torch.profiler` exported, on the host clock (its base added back)."""
    with open(trace_file) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    return [(base + round(e["ts"] * 1e3), base + round((e["ts"] + e["dur"]) * 1e3))
            for e in data["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _idle_gaps_ns(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The stretches between the first and last device interval in which
    none ran (overlapping intervals merged)."""
    gaps, cursor = [], None
    for s, e in sorted(intervals):
        if cursor is not None and s > cursor:
            gaps.append((cursor, s))
        cursor = e if cursor is None else max(cursor, e)
    return gaps


def span_table(spans: list[Span], trace_file: str | None = None) -> str:
    """One line a span name, in the order the names first started: the
    median over the spans of that name of host ms and device ms, and with
    the card's `trace_file` the idle ms a span, from the device's idle gaps
    whose middle falls inside it (the host was in that span when the card
    ran dry)."""
    gaps = _idle_gaps_ns(_device_intervals_ns(trace_file)) if trace_file else []
    by_name: dict[str, list[Span]] = {}
    for s in sorted(spans, key=lambda s: s.host_start_ns):
        by_name.setdefault(s.name, []).append(s)

    def median_ms(values: list[float | None]) -> str:
        values = [v for v in values if v is not None]
        return f"{statistics.median(values):10.3f}" if values else f"{'-':>10s}"

    def idle_ms(s: Span) -> float:
        return sum(g1 - g0 for g0, g1 in gaps
                   if s.host_start_ns <= (g0 + g1) / 2 < s.host_end_ns) / 1e6

    lines = [f"{'span':20s} {'count':>5s} {'host ms':>10s} {'device ms':>10s} {'idle ms':>10s}"]
    for name, group in by_name.items():
        idle = [idle_ms(s) for s in group] if trace_file and group[0].events else []
        lines.append(f"{name:20s} {len(group):5d} {median_ms([s.host_ms for s in group])} "
                     f"{median_ms([s.device_ms for s in group])} {median_ms(idle)}")
    return "\n".join(lines)
