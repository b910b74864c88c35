"""Host time a call in the PyTorch glue between the program's kernels: the
self time of its ``glue`` spans (``clahe.tables``, ``enhance.scale``,
``enhance.to_u8``) over the root spans of the recorded stretches, ms."""

from bench_torch import spans


def read(run):
    m = spans.measure(run)
    return None if m is None else m.host_ms.get("glue")
