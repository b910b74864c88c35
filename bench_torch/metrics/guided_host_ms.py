"""Host time a call in ``guided_filter``'s own Python and in the launch of
its kernels: the self time of its ``entry`` spans (``ops.guided_filter``,
``guided.prepare``, ``guided.kernel``) and ``launch`` spans
(``kernels.launch``) over the root spans of the recorded stretches, ms.
Nothing to read where the program records neither."""

from bench_torch import spans


def read(run):
    m = spans.measure(run)
    if m is None:
        return None
    parts = [m.host_ms[k] for k in ("entry", "launch") if k in m.host_ms]
    return sum(parts) if parts else None
