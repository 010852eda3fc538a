"""input_device_ms.train: the median over the traced steps of the device
milliseconds between the `train.input` span's CUDA events on its stream:
the log-spectrogram (K1) and the augmentation, or the normalisation and
flip (`perfbench/spans.py`)."""

from perfbench import spans


def read(run):
    return spans.part_device_ms(run, "train.input")
