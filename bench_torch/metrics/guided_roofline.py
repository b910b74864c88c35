"""The guided filter with a distinct guide against its roofline, %: the
least time of its work on the frame over the device time of the kernels
that do it.

The work: I and p read once and q written once, f32, and ``guided_ops(4)``
operations an output pixel. At 4K that is 0.0297 ms, bound by bytes. It is
counted from the configuration's shapes, not from the kernels that happen
to run.
"""

from bench_torch import devtrace, roofline

KERNELS = ("guided_walk_kernel", "guided_twopass_kernel")


def least_ms(cfg):
    n = cfg["height"] * cfg["width"]
    return roofline.least_ms(3 * 4 * n, roofline.guided_ops(4) * n)


def read(run):
    if run.trace is None:
        return None
    device_ms = (devtrace.busy(devtrace.named(run.trace, KERNELS))
                 / run.trace.frames * 1e-3)
    return roofline.share(least_ms(run.config), device_ms)
