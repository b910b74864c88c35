"""Host time a call in ``hist_equalize``'s own Python, in the PyTorch ops
that build its tables and in the launch of its two kernels: the self time
of its ``entry`` spans (``ops.hist_equalize``, ``he.hist``, ``he.map``),
``glue`` spans (``he.tables``) and ``launch`` spans (``kernels.launch``)
over the root spans of the recorded stretches, ms. It sums the layers that
are present. Nothing to read where the program opens no root span of its
own around the call (no ``entry`` layer): its launches alone would count
as roots."""

from bench_torch import spans

LAYERS = ("entry", "glue", "launch")


def read(run):
    m = spans.measure(run)
    if m is None or "entry" not in m.host_ms:
        return None
    return sum(m.host_ms[k] for k in LAYERS if k in m.host_ms)
