"""Seconds of the process's first launch of each C entry in a first call
made in a fresh process, the self time of those ``kernels.launch`` spans
(the load inside the first left out): the kernels' modules reaching the
card."""

from bench_torch import spans


def read(run):
    m = spans.measure(run)
    return None if m is None else m.first_launch_s
