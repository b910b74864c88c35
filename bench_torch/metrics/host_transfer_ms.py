"""Host time a call in the copies between the host and the card: the self
time of the program's ``transfer`` spans (``host.stage``, ``host.upload``,
``host.download``) over the root spans of the recorded stretches, ms."""

from bench_torch import spans


def read(run):
    m = spans.measure(run)
    return None if m is None else m.host_ms.get("transfer")
