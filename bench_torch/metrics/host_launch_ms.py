"""Host time a call in ``kernels.launch`` (the device context, the stream
lookup, the C call that launches a kernel): the self time of the ``launch``
spans over the root spans of the recorded stretches, ms."""

from bench_torch import spans


def read(run):
    m = spans.measure(run)
    return None if m is None else m.host_ms.get("launch")
