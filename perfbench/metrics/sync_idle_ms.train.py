"""sync_idle_ms.train: the median over the traced steps of the idle
milliseconds of `step_idle_ms.train` whose gaps' middles also lie inside a
host runtime call ending in `Synchronize`, or in a `cudaMemcpy` or
`cudaMemcpyAsync`: the host blocked on the device inside the step
(`perfbench/spans.py`)."""

from perfbench import spans


def read(run):
    per = spans.idle_by_step(run)
    return spans.median([p["sync"] for p in per]) if per else None
