"""Batched grayscale opening against its roofline, %: the least time of its
work on a call's stack over the device time of every device operation a
call, overlaps once.

The work: each u8 pixel read once and written once, 2 B H W bytes, and
van Herk's compares, about 3 a pixel a window pass (the prefix and the
suffix extremes and their pair), over a row and a column pass in each of
the two stages: 12 a pixel. For two 4K frames that is 33.2 MB, 0.0099 ms,
bound by bytes (the compares take 0.0030 ms). It is counted from the
configuration's shapes and names no kernel, so it reads the same work
whether one fused launch, two erode/dilate launches or another kernel
does it.
"""

from bench_torch import devtrace, roofline

# van Herk's compares a pixel: 3 a window pass, 2 passes a stage, 2 stages
COMPARES = 3 * 2 * 2


def least_ms(cfg):
    n = cfg["batch"] * cfg["height"] * cfg["width"]
    return roofline.least_ms(2 * n, COMPARES * n)


def read(run):
    if run.trace is None:
        return None
    device_ms = devtrace.busy(run.trace.kernels) / run.trace.frames * 1e-3
    return roofline.share(least_ms(run.config), device_ms)
