"""Seconds of ``kernels.load`` in a first call made in a fresh process:
the kernel library found (or built) and loaded."""

from bench_torch import spans


def read(run):
    m = spans.measure(run)
    return None if m is None else m.load_s
