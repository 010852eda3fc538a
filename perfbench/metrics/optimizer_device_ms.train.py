"""optimizer_device_ms.train: the median over the traced steps of the device
milliseconds between the `train.optimizer` span's CUDA events on its stream:
the rank average, Adam, the audio statistics' advance and the metrics
(`perfbench/spans.py`)."""

from perfbench import spans


def read(run):
    return spans.part_device_ms(run, "train.optimizer")
