"""mfu.train_swin3d: the model FLOPs of the window's steps (the Video Swin
reference's every product, the patch embedding, q k^T and the
attention-weighted sum included, with the audio tower's convolutions and
the head's products; forward and twice that for the backward) over the
window's host-clock time, as a share of the card's peak in the
configuration's compute dtype."""

from perfbench.reference.swin3d import train_step_flops


def read(run):
    if run.kind != "train" or run.peaks is None:
        return None
    flops = train_step_flops(run.cell.config, run.cell.params["batch"])
    rate = flops * run.window["steps"] / run.window["window_s"]
    return 100.0 * rate / run.peaks[run.cell.config["compute_dtype"]]
