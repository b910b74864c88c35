"""Box filter + guided filter, reflect-101 fused-path semantics (port of
``tpuimg.ops.guided``).

Ported: ``box_filter`` and ``guided_filter`` with ``border="reflect101"``
(fixed 1/ksz^2 normalisation, mirrored halo), including the self-guided
collapse when ``p is I``. Not yet: the shrink-window class path, the
C-channel (CN1) form, and the guided-filter kernel, so ``guided_filter`` on a
CUDA tensor raises. ``box_filter`` has no kernel in the JAX package either
and runs as plain PyTorch on any device.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.borders import REFLECT101, SHRINK, pad_reflect101
from tpuimg_torch.core.validate import (
    NotPortedError, ParamError, ShapeError, check_image, check_positive,
    check_radius)

_FLOAT_IN = [torch.float32, torch.float64, torch.uint8]


def _window_sum(x, ksz: int, dim: int):
    """Sum over every length-``ksz`` window along ``dim`` (valid mode: the
    caller supplies ksz - 1 taps of halo), as direct shifted adds."""
    n = x.shape[dim] - ksz + 1
    acc = x.narrow(dim, 0, n)
    for k in range(1, ksz):
        acc = acc + x.narrow(dim, k, n)
    return acc


def _box_mean(x, radius: int):
    ksz = 2 * radius + 1
    xp = pad_reflect101(x, radius, radius)
    s = _window_sum(_window_sum(xp, ksz, -1), ksz, -2)
    return s * (1.0 / (ksz * ksz))


def _check_border(border: str, op: str):
    if border == SHRINK:
        raise NotPortedError(
            f"{op} border='shrink' (the class path, gIntegralToMean) is not "
            f"ported yet; border='reflect101' is")
    if border != REFLECT101:
        raise ParamError(
            f"border must be one of {[REFLECT101, SHRINK]}, got {border!r}")


def box_filter(x, radius: int, border: str = SHRINK):
    """Box mean over a (2r+1)^2 window of a float32 (..., H, W) image,
    reflect-101 border, fixed 1/ksz^2."""
    check_radius(radius)
    x = torch.as_tensor(x)
    check_image(x, "x", dtypes=_FLOAT_IN)
    _check_border(border, "box_filter")
    return _box_mean(x.to(torch.float32), radius)


def guided_filter(I, p, radius: int, eps: float, border: str = SHRINK):
    """Guided filter q = mean(a)*I + mean(b) with a/b from the per-window
    variance. Passing the same tensor as I and p collapses the four window
    means to two (detected by object identity)."""
    self_guided = p is I
    check_radius(radius)
    check_positive(eps, "eps")  # eps=0 gives 0/0=NaN on constant windows
    I = torch.as_tensor(I)
    p = I if self_guided else torch.as_tensor(p)
    check_image(I, "I", dtypes=_FLOAT_IN)
    check_image(p, "p", dtypes=_FLOAT_IN)
    if p.ndim not in (I.ndim, I.ndim + 1) or p.shape[-2:] != I.shape[-2:]:
        raise ShapeError(
            f"guide I {tuple(I.shape)} and source p {tuple(p.shape)} must "
            f"share spatial dims (p may add one leading channel dim)"
        )
    if p.ndim == I.ndim + 1:
        raise NotPortedError(
            "guided_filter with a C-channel source (the CN1 path) is not "
            "ported yet")
    _check_border(border, "guided_filter")
    if I.device.type != "cpu" or p.device.type != "cpu":
        raise NotPortedError(
            "guided_filter on a CUDA tensor needs the port of "
            "tpuimg/kernels/boxsum.py::guided_filter_pallas, which is not "
            "ported yet")
    I = I.to(torch.float32)
    p = I if self_guided else p.to(torch.float32)
    mean_I = _box_mean(I, radius)
    mean_II = _box_mean(I * I, radius)
    mean_p = mean_I if self_guided else _box_mean(p, radius)
    mean_Ip = mean_II if self_guided else _box_mean(I * p, radius)
    a = (mean_Ip - mean_p * mean_I) / (mean_II - mean_I * mean_I + eps)
    b = mean_p - a * mean_I
    return _box_mean(a, radius) * I + _box_mean(b, radius)
