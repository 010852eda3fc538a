"""setup_s: seconds from the process's start to the first timed step or
request (interpreter, imports, CUDA, the kernels' build or cache, weights,
inputs, warm-up), by the host clock."""


def read(run):
    return run.setup_s
