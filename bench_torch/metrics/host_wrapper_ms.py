"""Host time a call in the program's own Python around its kernels: the
self time of its ``entry`` spans (the public entry's root span and the
wrappers': checks, allocations, taps, scratch queries) over the root spans
of the recorded stretches, ms. With ``host_glue_ms`` and ``host_launch_ms``
it sums to the root spans' time, the program's host time a call read from
inside."""

from bench_torch import spans


def read(run):
    m = spans.measure(run)
    return None if m is None else m.host_ms.get("entry")
