"""Reflect-101 border (port of ``tpuimg.core.borders``).

reflect-101 mirrors without repeating the edge pixel (OpenCV
``BORDER_DEFAULT``, reference ``reflectBorder``). Past the first mirror the
map keeps mirroring: it is periodic with period 2(n - 1), and constant for
n = 1. That is ``np.pad(mode="reflect")``'s map, which ``jnp.pad`` and so
tpuimg's XLA paths follow, so any pad is valid, on any frame size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuimg_torch.core.validate import ParamError

REFLECT101 = "reflect101"
REPLICATE = "replicate"
SHRINK = "shrink"

_NUMPY_PAD_MODE = {REFLECT101: "reflect", REPLICATE: "edge"}


def reflect101_index(x, size: int):
    """The iterated mirror-without-repeat index map, valid for every x:
    m = |x| mod 2(size - 1), then 2(size - 1) - m where m >= size.

    Works on ints and integer tensors (and numpy arrays)."""
    if size == 1:
        return x * 0
    period = 2 * (size - 1)
    m = abs(x) % period
    return m - (2 * m - period) * (m >= size)


def pad_mode(border: str) -> str:
    """``np.pad`` mode string for a border policy."""
    try:
        return _NUMPY_PAD_MODE[border]
    except KeyError:
        raise ParamError(
            f"border must be one of {sorted(_NUMPY_PAD_MODE)}, got {border!r}"
        ) from None


def pad_reflect101(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad the trailing two dims of ``x`` by ``pad_h`` rows and ``pad_w``
    columns on each side with reflect-101."""
    h, w = x.shape[-2], x.shape[-1]
    if pad_h < h and pad_w < w:
        # one mirror deep: the padding kernel, on any device
        lead = x.shape[:-2]
        y = F.pad(x.reshape((-1, h, w)), (pad_w, pad_w, pad_h, pad_h),
                  mode="reflect")
        return y.reshape(lead + y.shape[-2:])
    ys = reflect101_index(torch.arange(-pad_h, h + pad_h, device=x.device), h)
    xs = reflect101_index(torch.arange(-pad_w, w + pad_w, device=x.device), w)
    return x.index_select(-2, ys).index_select(-1, xs)
