"""spatial_attn_device_ms.train: the median over the traced steps of the
device milliseconds of TimeSformer's `vid.spatial` spans inside the step's
`train.forward`, summed over its blocks: the gather of each frame's tokens
with the cls token, `norm1`, the attention over them, the cls residual's
mean over the frames and the residual's scatter back
(`perfbench/tower_spans.py`)."""

from perfbench.tower_spans import forward_device_ms


def read(run):
    return forward_device_ms(run, "vid.spatial")
