"""Host time a call in the PyTorch glue between the program's kernels: the
self time of its ``glue`` spans over the root spans of the recorded
stretches, ms. On the cells' path these are ``enhance.scale`` and
``enhance.to_u8``; ``clahe.tables`` runs only on the CPU and in
``clahe_sharded``, since the card builds CLAHE's tables inside the
tile-histogram kernel."""

from bench_torch import spans


def read(run):
    m = spans.measure(run)
    return None if m is None else m.host_ms.get("glue")
