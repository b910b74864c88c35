"""The gaussian + guided tail of enhance against its roofline, %: the least
time of the tail's work on the frame over the device time of the kernels
that do it.

The work: the f32 blend read once and the f32 output written once, and
``gauss_ops(radius) + guided_ops(4)`` operations an output pixel (the guide
is the blend, the source its gaussian). At 4K that is 0.0198 ms, bound by
bytes. It is counted from the configuration's shapes, not from the kernels
that happen to run.
"""

from bench_torch import devtrace, roofline

# the kernels that do the tail's work: the fused tails, or the gaussian and
# guided kernels where the two run apart
KERNELS = ("tail_kernel", "gauss_reg_kernel", "gauss_tile_kernel",
           "guided_walk_kernel", "guided_twopass_kernel")


def least_ms(cfg):
    n = cfg["height"] * cfg["width"]
    prm = cfg["params"]
    ops = (roofline.gauss_ops(prm["radius"]) + roofline.guided_ops(4)) * n
    return roofline.least_ms(2 * 4 * n, ops)


def read(run):
    if run.trace is None:
        return None
    device_ms = (devtrace.busy(devtrace.named(run.trace, KERNELS))
                 / run.trace.frames * 1e-3)
    return roofline.share(least_ms(run.config), device_ms)
