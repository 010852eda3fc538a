"""mfu.train: the model FLOPs of the window's steps (the reference's
convolutions and products at the cell's sizes, forward and twice that for
the backward) over the window's host-clock time, as a share of the card's
peak in the configuration's compute dtype."""

from perfbench.reference.flops import train_step_flops


def read(run):
    if run.kind != "train" or run.peaks is None:
        return None
    p = run.cell.params
    flops = train_step_flops(run.cell.config, p["step"], p["batch"], p["frames"])
    rate = flops * run.window["steps"] / run.window["window_s"]
    return 100.0 * rate / run.peaks[run.cell.config["compute_dtype"]]
