"""Host time a call in the morphology ops' own Python and in the launch of
their kernel: the self time of their ``entry`` spans (``ops.morph_open``
and the other three roots, ``morph.kernel``) and ``launch`` spans
(``kernels.launch``) over the root spans of the recorded stretches, ms.
Nothing to read where the program opens no root span of its own around
the call (no ``entry`` layer): its launches alone would count as roots."""

from bench_torch import spans

LAYERS = ("entry", "launch")


def read(run):
    m = spans.measure(run)
    if m is None or "entry" not in m.host_ms:
        return None
    return sum(m.host_ms[k] for k in LAYERS if k in m.host_ms)
