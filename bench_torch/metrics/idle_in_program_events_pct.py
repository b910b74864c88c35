"""Share of the card's idle time in each recorded stretch, the gaps between
the program's device intervals, during which the host was inside a root
span of the program, %; the rest is the caller's. The median over the
stretches of ``bench_torch/intervals.py``'s fresh process; a stretch with
no idle time reads 0."""

from bench_torch import intervals


def read(run):
    m = intervals.measure(run)
    return None if m is None else m.in_program_pct
