"""The shrink-border guided filter of C source channels by one guide
against its roofline, %: the least time of its work on the frame over the
device time of the guided walker kernels that do it.

The work: I read once, the C planes of p read once and the C planes of q
written once, f32, 4 (1 + 2C) H W bytes; and for each output pixel and
channel ``guided_ops(4)`` operations plus the area scaling (the window's
area and its reciprocal). At 4K with C = 3 that is 232 MB, 0.0693 ms, bound
by bytes. It is counted from the configuration's shapes, not from the
kernels that happen to run; where none of them ran (the plain chain) there
is nothing to read.
"""

from bench_torch import devtrace, roofline
from bench_torch.metrics.guided_roofline import KERNELS

AREA_OPS = 2  # cy * cx and its reciprocal


def least_ms(cfg):
    n, c = cfg["height"] * cfg["width"], cfg["channels"]
    return roofline.least_ms(4 * (1 + 2 * c) * n,
                             (roofline.guided_ops(4) + AREA_OPS) * c * n)


def read(run):
    if run.trace is None:
        return None
    device_ms = (devtrace.busy(devtrace.named(run.trace, KERNELS))
                 / run.trace.frames * 1e-3)
    return roofline.share(least_ms(run.config), device_ms)
