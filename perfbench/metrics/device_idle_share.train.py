"""device_idle_share.train: the share of the traced window in which no
kernel, copy or set ran on the device (their intervals merged)."""

from perfbench.trace import busy_seconds


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - busy_seconds(run.trace) / run.trace.window_s)
