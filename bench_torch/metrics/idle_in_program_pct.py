"""Share of the card's idle time in the recorded stretches, the gaps of
``devtrace.idle_gaps``, during which the host was inside a root span of
the program, %; the rest is the caller's."""

from bench_torch import spans


def read(run):
    m = spans.measure(run)
    return None if m is None else m.idle_in_program_pct
