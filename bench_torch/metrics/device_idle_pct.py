"""Share of the traced stretch, from its first kernel's start to its last
kernel's end, in which no kernel ran on the card, %."""

from bench_torch import devtrace


def read(run):
    if run.trace is None:
        return None
    window = devtrace.span(run.trace)
    if window <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy(run.trace.kernels) / window)
