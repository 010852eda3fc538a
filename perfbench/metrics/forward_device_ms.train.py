"""forward_device_ms.train: the median over the traced steps of the device
milliseconds between the `train.forward` span's CUDA events on its stream:
the forward passes and the losses (`perfbench/spans.py`)."""

from perfbench import spans


def read(run):
    return spans.part_device_ms(run, "train.forward")
