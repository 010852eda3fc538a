"""backward_device_ms.train: the median over the traced steps of the device
milliseconds between the `train.backward` span's CUDA events on its stream:
the backward pass (`perfbench/spans.py`)."""

from perfbench import spans


def read(run):
    return spans.part_device_ms(run, "train.backward")
