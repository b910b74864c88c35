"""Typed parameter/shape validation (port of ``tpuimg.core.validate``).

Same exception names, the same accepted cases and the same messages as the
JAX package, so a caller switching packages sees the same failures. Dtype
names print without the ``torch.`` prefix (``'uint8'``, as numpy names them).
"""

from __future__ import annotations

import numbers

import numpy as _np
import torch


class TpuImgError(ValueError):
    """Base class for tpuimg_torch validation errors."""


class ShapeError(TpuImgError):
    pass


class DTypeError(TpuImgError):
    pass


class ParamError(TpuImgError):
    pass


class DeviceError(TpuImgError):
    """A NumPy (or list) input with no CUDA card to run it on."""


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def check_image(x, name: str = "img", min_ndim: int = 2, dtypes=None):
    if x.ndim < min_ndim:
        raise ShapeError(
            f"{name} must have at least {min_ndim} dims (..., H, W); "
            f"got shape {tuple(x.shape)}"
        )
    h, w = x.shape[-2], x.shape[-1]
    if h < 1 or w < 1:
        raise ShapeError(f"{name} has empty spatial dims: {tuple(x.shape)}")
    if dtypes is not None and x.dtype not in dtypes:
        raise DTypeError(
            f"{name} dtype must be one of {[dtype_name(d) for d in dtypes]}, "
            f"got {dtype_name(x.dtype)}"
        )
    return h, w


def check_ypadded_rows(p, depth: int, reach: str) -> None:
    """A row-padded block (``depth`` halo rows on each side) must keep at
    least one row; ``reach`` names 2 * depth as tpuimg's message does."""
    if p.ndim < 2 or p.shape[-2] - 2 * depth < 1:
        raise ValueError(f"ypadded block must have > {reach} rows; got "
                         f"{p.shape[-2] if p.ndim >= 2 else tuple(p.shape)}")


def check_radius(radius: int, lo: int = 1, name: str = "radius"):
    # bool is an int subclass (True would pass as radius 1); NumPy integer
    # scalars (np.int64 from configs/sweeps) are valid radii
    if (isinstance(radius, bool) or not isinstance(radius, (int, _np.integer))
            or radius < lo):
        raise ParamError(f"{name} must be an int >= {lo}, got {radius!r}")


def check_positive(value, name: str):
    # `not (value > 0)` so that NaN, for which every comparison is False,
    # fails typed
    if not isinstance(value, numbers.Real) or not (value > 0):
        raise ParamError(f"{name} must be positive, got {value!r}")


def check_impl(impl: str, allowed=("auto", "xla", "pallas"),
               name: str = "impl"):
    """Reject misspelled impl selectors instead of silently running another
    implementation."""
    if impl not in allowed:
        raise ParamError(f"{name} must be one of {allowed}, got {impl!r}")
