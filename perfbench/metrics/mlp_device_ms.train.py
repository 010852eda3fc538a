"""mlp_device_ms.train: the median over the traced steps of the device
milliseconds of TimeSformer's `vid.mlp` spans inside the step's
`train.forward`, summed over its blocks: `norm2`, `fc1`, the exact GELU,
`fc2` and the residual (`perfbench/tower_spans.py`)."""

from perfbench.tower_spans import forward_device_ms


def read(run):
    return forward_device_ms(run, "vid.mlp")
