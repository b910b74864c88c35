"""Batched histogram equalization against its roofline, %: the least time
of its work on a call's stack over the device time of every device
operation a call, the port's kernels and PyTorch's alike, overlaps once.

The work: each u8 pixel read once and written once, 2 B H W bytes, and an
add (its histogram bin) and a load (its table entry) a pixel. For 16 1080p
frames that is 66.4 MB, 0.0198 ms, bound by bytes. It is counted from the
configuration's shapes and names no kernel, so it reads the same work
whatever implements it.
"""

from bench_torch import devtrace, roofline


def least_ms(cfg):
    n = cfg["batch"] * cfg["height"] * cfg["width"]
    return roofline.least_ms(2 * n, 2 * n)


def read(run):
    if run.trace is None:
        return None
    device_ms = devtrace.busy(run.trace.kernels) / run.trace.frames * 1e-3
    return roofline.share(least_ms(run.config), device_ms)
