"""Box filter + guided filter (port of ``tpuimg.ops.guided``).

``guided_filter`` follows tpuimg's dispatch (``tpuimg/ops/guided.py``
``_guided_filter_impl``) for border="reflect101": radius <= 16 runs the
guided-filter kernel (kernels/boxsum.py, csrc/guided.cu) on a CUDA tensor,
in one launch for every batch and for the C-channel (CN1) form, at any frame
size; its plain version on a CPU tensor. border="shrink", the default and
the reference class path (gIntegralToMean: windows clamped to the image,
normalised by their true area), which tpuimg computes in XLA, takes the same
route at radius <= 16: the twopass kernel's shrink instance on a CUDA
tensor (one pair of launches for every batch and the CN1 form, at any frame
size), its plain version (the chain with shrink box means) on a CPU tensor.
Radius > 16 stays plain PyTorch on the tensor's device at both borders, as
tpuimg's XLA: the reflect-101 chain (window sums as direct adds up to r = 5
and cumsum differences above) or the shrink chain. ``box_filter`` (shrink
by default) is plain PyTorch on the tensor's device.

``guided_ypadded``, the per-shard op of ``parallel.guided_filter_sharded``
and ``enhance_sharded``, runs the onepass kernel's row-padded entry at any
radius, as tpuimg runs its Pallas kernel; ``box_filter_ypadded`` is plain
PyTorch on the tensor's device, as tpuimg's is XLA.
"""

from __future__ import annotations

import functools

import torch

from tpuimg_torch.core.borders import REFLECT101, SHRINK, pad_reflect101
from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.validate import (
    ParamError, ShapeError, check_image, check_positive, check_radius,
    check_ypadded_rows)
from tpuimg_torch.kernels.boxsum import (
    box_mean_shrink, cumsum0, guided_chain, guided_filter_kernel,
    guided_ypadded_kernel, window_sum)
from tpuimg_torch.profiling import span

_FLOAT_IN = [torch.float32, torch.float64, torch.uint8]

# below this radius, direct shifted adds; above, cumsum differences
# (tpuimg/ops/guided.py _DIRECT_MAX_RADIUS)
_DIRECT_MAX_RADIUS = 5

# guided_filter sends radius <= this to the kernel, larger ones to the plain
# chain, as tpuimg sends them to Pallas or XLA (tpuimg/ops/guided.py
# _PALLAS_MAX_RADIUS); the kernel itself takes more
_PALLAS_MAX_RADIUS = 16


def _window(xp, radius: int, dim: int):
    """tpuimg's ``_window_sum`` along ``dim`` of ``xp``, already padded by
    the radius there: direct adds up to r = 5, cumsum differences above."""
    ksz = 2 * radius + 1
    if radius <= _DIRECT_MAX_RADIUS:
        return window_sum(xp, ksz, dim)
    n = xp.shape[dim] - 2 * radius
    c = cumsum0(xp, dim)
    return c.narrow(dim, ksz, n) - c.narrow(dim, 0, n)


def _box_reflect(x, radius: int):
    """tpuimg's reflect-101 box mean: window sums along the rows, then the
    columns."""
    ksz = 2 * radius + 1
    rows = _window(pad_reflect101(x, 0, radius), radius, -1)
    return _window(pad_reflect101(rows, radius, 0), radius, -2) * (
        1.0 / (ksz * ksz))


def _broadcast(a: tuple, b: tuple) -> tuple:
    """``torch.broadcast_shapes`` of two shapes of one length, on tuples:
    its first call in a process imports sympy, about 3 s of set-up."""
    out = []
    for x, y in zip(a, b):
        if x != y and 1 not in (x, y):
            raise ShapeError(f"guide I {tuple(a)} and source p {tuple(b)} "
                             f"do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _box(border: str, radius: int):
    if border == SHRINK:
        return functools.partial(box_mean_shrink, radius=radius)
    if border == REFLECT101:
        return functools.partial(_box_reflect, radius=radius)
    raise ParamError(
        f"border must be one of {[REFLECT101, SHRINK]}, got {border!r}")


def box_filter(x, radius: int, border: str = SHRINK):
    """Box mean over a (2r+1)^2 window of a float32 (..., H, W) image.

    border="shrink": reference class-path semantics (gIntegralToMean).
    border="reflect101": fused-path semantics (fixed 1/ksz^2, mirrored halo).
    """
    check_radius(radius)
    x = as_image(x)
    check_image(x, "x", dtypes=_FLOAT_IN)
    return _box(border, radius)(x.to(torch.float32))


def box_filter_ypadded(p, radius: int):
    """Box mean (reflect-101 in x, 1/ksz^2) of a block already padded by
    ``radius`` rows on the row axis: (..., H + 2r, W) -> float32 (..., H,
    W). The sharded form of ``box_filter(border="reflect101")``."""
    check_radius(radius)
    p = as_image(p)
    check_image(p, "p", dtypes=_FLOAT_IN)
    check_ypadded_rows(p, radius, "2*radius")
    ksz = 2 * radius + 1
    rows = _window(pad_reflect101(p.to(torch.float32), 0, radius), radius, -1)
    return _window(rows, radius, -2) * (1.0 / (ksz * ksz))


def guided_ypadded(Ipad, ppad, radius: int, eps: float):
    """Guided filter (reflect-101 fused-path semantics) on blocks already
    padded by ``2*radius`` rows on the row axis, (..., H + 4r, W) ->
    float32 (..., H, W); x is reflect-101 in the kernel. Passing the same
    tensor twice is the self-guided form (object identity, as tpuimg's
    ``ppad is Ipad``). Any radius, as tpuimg's."""
    self_guided = ppad is Ipad
    check_radius(radius)
    check_positive(eps, "eps")
    Ipad = as_image(Ipad)
    check_ypadded_rows(Ipad, 2 * radius, "4*radius")
    Ipad = Ipad.to(torch.float32).contiguous()
    ppad = Ipad if self_guided else as_image(ppad, like=Ipad).to(
        torch.float32).contiguous()
    return guided_ypadded_kernel(Ipad, ppad, radius, eps, self_guided)


def guided_filter(I, p, radius: int, eps: float, border: str = SHRINK):
    """Guided filter q = mean(a)*I + mean(b) with a/b from the per-window
    variance. Passing the same tensor as I and p collapses the four window
    means to two (detected by object identity). p may add one leading
    channel dim to I: each channel is filtered with the shared guide."""
    with span("ops.guided_filter", "entry"):
        with span("guided.prepare", "entry"):
            self_guided = p is I
            check_radius(radius)
            # eps=0 gives 0/0=NaN on constant windows
            check_positive(eps, "eps")
            I = as_image(I)
            p = I if self_guided else as_image(p, like=I)
            check_image(I, "I", dtypes=_FLOAT_IN)
            check_image(p, "p", dtypes=_FLOAT_IN)
            if p.ndim not in (I.ndim, I.ndim + 1) or (
                    p.shape[-2:] != I.shape[-2:]):
                raise ShapeError(
                    f"guide I {tuple(I.shape)} and source p "
                    f"{tuple(p.shape)} must share spatial dims (p may add "
                    f"one leading channel dim)")
            box = _box(border, radius)
            I = I.to(torch.float32)
            p = I if self_guided else p.to(torch.float32)
            kernel = radius <= _PALLAS_MAX_RADIUS
            if kernel and self_guided:
                I = p = I.contiguous()
            elif kernel:  # the kernel takes I's frames, C times over in p
                lead = p.shape[:p.ndim - I.ndim]
                shape = _broadcast(I.shape, p.shape[len(lead):])
                I = I.expand(shape).contiguous()
                p = p.expand(lead + shape).contiguous()
        if not kernel:
            with span("guided.chain", "glue"):
                return guided_chain(I, p, eps, box, self_guided)
        with span("guided.kernel", "entry", border):
            return guided_filter_kernel(I, p, radius, eps,
                                        self_guided=self_guided,
                                        border=border)
