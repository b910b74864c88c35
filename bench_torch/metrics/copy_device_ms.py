"""Device time a frame of the copies between the host and the card (the
profiler's ``Memcpy HtoD`` and ``Memcpy DtoH`` activities), overlapping
copies counted once, ms."""

from bench_torch import devtrace

COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def is_copy(name: str) -> bool:
    """Whether a device activity is a copy between the host and the
    card."""
    return name.startswith(COPIES)


def copies(trace) -> list:
    return [k for k in trace.kernels if is_copy(k[0])]


def read(run):
    if run.trace is None:
        return None
    moved = copies(run.trace)
    if not moved:
        return None
    return devtrace.busy(moved) / run.trace.frames * 1e-3
