"""train_clips_per_s: every clip stepped in the window over the window's
host-clock time, which ends in a synchronise."""


def read(run):
    if run.kind != "train":
        return None
    return run.window["clips"] / run.window["window_s"]
