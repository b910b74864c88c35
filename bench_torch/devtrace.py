"""The device trace of a stretch of frames, by ``torch.profiler``, and the
arithmetic the per-layer metrics and the breakdown take from it.

Times are the profiler's microseconds. A kernel that starts before the one
ahead of it ends (a dependent launch waiting on it) counts from that end,
so overlapping spans count once.
"""

from __future__ import annotations

from dataclasses import dataclass

# the names of PyTorch's own device work: its kernels live in the ``at``
# namespace (CUB's under ``at_cuda_detail``), and copies and fills show as
# Memcpy and Memset
TORCH_KERNELS = ("at::", "at_cuda_detail", "cub::")
TORCH_TRANSFERS = ("Memcpy", "Memset")


@dataclass
class Trace:
    frames: int
    kernels: list  # (name, start, end), by start
    host: list  # (name, start, end): the CUDA runtime's calls on the host


def capture(stretch, frames: int, attempts: int = 3) -> Trace | None:
    """Trace ``stretch()``, which drives ``frames`` frames and waits for
    them, with the profiler's device activity only: recording every host op
    as well would slow the host path, and with it the device's idle share,
    several times over. A trace with no device work in it (the profiler
    drops one now and then) is taken again, up to ``attempts`` times in
    all; None if every one came back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stretch()
        kernels, host = [], []
        for e in prof.events():
            span = (e.name, float(e.time_range.start),
                    float(e.time_range.end))
            if e.device_type == DeviceType.CPU:
                host.append(span)  # the CUDA runtime's calls
            elif (e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)):
                kernels.append(span)
        if kernels:
            kernels.sort(key=lambda k: k[1])
            host.sort(key=lambda k: k[1])
            return Trace(frames, kernels, host)
    return None


def own_times(kernels) -> list[float]:
    """Each kernel's time not covered by the kernels before it."""
    own, done = [], float("-inf")
    for _, start, end in kernels:
        own.append(max(0.0, end - max(start, done)))
        done = max(done, end)
    return own


def busy(kernels) -> float:
    """The time in which at least one of ``kernels`` ran."""
    return sum(own_times(sorted(kernels, key=lambda k: k[1])))


def span(trace: Trace) -> float:
    """From the first kernel's start to the last one's end."""
    return max(k[2] for k in trace.kernels) - trace.kernels[0][1]


def named(trace: Trace, words) -> list:
    """The kernels whose name holds one of ``words``."""
    return [k for k in trace.kernels if any(w in k[0] for w in words)]


def is_torch(name: str) -> bool:
    return (any(w in name for w in TORCH_KERNELS)
            or name.startswith(TORCH_TRANSFERS))


def short(name: str) -> str:
    for head in ("void ", "(anonymous namespace)::"):
        name = name.removeprefix(head)
    return name[:120]


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """The stretches with no kernel running, between the first kernel's
    start and the last one's end."""
    gaps, done = [], trace.kernels[0][1]
    for _, start, end in trace.kernels:
        if start > done:
            gaps.append((done, start))
        done = max(done, end)
    return gaps


def host_doing(trace: Trace, at: float) -> str:
    """What the host was doing at ``at``: the innermost CUDA runtime call
    under way, or Python (the program's wrappers and glue, the harness)."""
    around = [h for h in trace.host if h[1] <= at < h[2]]
    if not around:
        return "host in Python, no runtime call"
    return max(around, key=lambda h: h[1])[0]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by what the host was doing, in seconds over the traced stretch."""
    by_name: dict[str, float] = {}
    for (name, _, _), own in zip(trace.kernels, own_times(trace.kernels)):
        key = short(name)
        by_name[key] = by_name.get(key, 0.0) + own
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, t * 1e-6] for n, t in ops],
            "idle_gaps": [[host_doing(trace, (a + b) / 2), (b - a) * 1e-6]
                          for a, b in gaps]}
