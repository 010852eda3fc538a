"""merge_device_ms.train: the median over the traced steps of the device
milliseconds of Video Swin's `vid.merge` spans inside the step's
`train.forward`, summed over its three patch merges: the 2x2 gather (after
stages 1 and 2), the LayerNorm and the bias-free reduction
(`perfbench/tower_spans.py`)."""

from perfbench.tower_spans import forward_device_ms


def read(run):
    return forward_device_ms(run, "vid.merge")
