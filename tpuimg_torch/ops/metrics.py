"""On-device comparison metrics (port of ``tpuimg.ops.metrics``).

The reference compares two frames on the device and fetches only the scalar
(gCmpMaxAbsDiff, Integral/integral_d.cu:811-852). Here the reductions run on
the first input's device and return 0-d tensors there, so only scalars
cross to the host.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.device import as_image


def _is_integer(x: torch.Tensor) -> bool:
    # bool is not an integer dtype, as jnp.issubdtype(bool, integer) is false
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def _absdiff(a, b):
    """Exact |a - b|: integer inputs stay in integer arithmetic (a float32
    detour would collapse differences between values above 2^24; integral
    images reach ~1e9). Both widen to int32 before the subtraction, since a
    uint8 ``a - b`` wraps (0 - 255 would give 1)."""
    a = as_image(a)
    b = as_image(b, like=a)
    if _is_integer(a) and _is_integer(b):
        ai = a.to(torch.int32)
        bi = b.to(torch.int32)
        return torch.where(ai >= bi, ai - bi, bi - ai)
    return torch.abs(a.to(torch.float32) - b.to(torch.float32))


def max_abs_diff(a, b):
    """0-d max |a - b| on the device; exact for int32-range integers."""
    return torch.max(_absdiff(a, b))


def max_abs_diff_loc(a, b):
    """(maxdiff, y, x) as 0-d tensors: the first maximum in row-major order
    (the reference's morphology demo prints where the largest difference
    is, Morphology/main.cpp:103)."""
    d = _absdiff(a, b)
    flat = d.reshape(-1)
    i = torch.argmax(flat)
    w = d.shape[-1]
    return flat[i], i // w, i % w
