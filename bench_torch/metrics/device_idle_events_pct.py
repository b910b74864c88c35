"""Share of each recorded stretch, from its first device interval's start to
its last one's end, that no interval covers on any stream, %: the median
over the stretches of a fresh process in which no profiler has run, read
from the program's own device spans (``bench_torch/intervals.py``)."""

from bench_torch import intervals


def read(run):
    m = intervals.measure(run)
    return None if m is None else m.idle_pct
