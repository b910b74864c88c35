"""Device time a frame of PyTorch's own kernels, copies and fills (the
glue between the port's kernels), overlapping spans once, ms."""

from bench_torch import devtrace


def read(run):
    if run.trace is None:
        return None
    glue = [k for k in run.trace.kernels if devtrace.is_torch(k[0])]
    if not glue:
        return None
    return devtrace.busy(glue) / run.trace.frames * 1e-3
