"""launches_per_step.train: kernels on the device in the traced steps,
over those steps."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    kernels = run.trace.kernels()
    return len(kernels) / run.tail["steps"] if kernels else None
