"""window_attn_device_ms.train: the median over the traced steps of the
device milliseconds of Video Swin's `vid.window_attn` spans inside the
step's `train.forward`, summed over its 24 blocks: `norm1`, the shift, `qkv`,
the partition into windows, the bias (relative position, and the mask in a
shifted block), the attention, the reverse, `proj` and the residual
(`perfbench/tower_spans.py`)."""

from perfbench.tower_spans import forward_device_ms


def read(run):
    return forward_device_ms(run, "vid.window_attn")
