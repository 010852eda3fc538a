"""step_host_ms.train: the median over the traced steps of the host
milliseconds of the `train.step` span, the time the host takes to enqueue a
step; near the step's device time, the step is launch-bound
(`perfbench/spans.py`)."""

from perfbench import spans


def read(run):
    return spans.median([s.root.host_ms for s in spans.steps(run)])
