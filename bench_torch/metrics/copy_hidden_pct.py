"""Share of the copies' device time during which some other device work
(a kernel, a fill) ran, %: ``busy(copies) + busy(others) - busy(all)`` over
``busy(copies)``. Copies that overlap other frames' kernels read near 100;
copies that serialize with them read 0."""

from bench_torch import devtrace
from bench_torch.metrics.copy_device_ms import copies, is_copy


def read(run):
    if run.trace is None:
        return None
    moved = copies(run.trace)
    copied = devtrace.busy(moved)
    if copied <= 0:
        return None
    others = [k for k in run.trace.kernels if not is_copy(k[0])]
    both = copied + devtrace.busy(others) - devtrace.busy(run.trace.kernels)
    return 100.0 * both / copied
