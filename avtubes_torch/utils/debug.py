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
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time
from collections.abc import Callable, Iterator

import torch
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
