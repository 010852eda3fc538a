"""temporal_attn_device_ms.train: the median over the traced steps of the
device milliseconds of TimeSformer's `vid.temporal` spans inside the step's
`train.forward`, summed over its blocks: `temporal_norm1`, the attention of
each patch over its frames, `temporal_fc` and the residual
(`perfbench/tower_spans.py`)."""

from perfbench.tower_spans import forward_device_ms


def read(run):
    return forward_device_ms(run, "vid.temporal")
