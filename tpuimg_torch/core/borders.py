"""Reflect-101 border (port of ``tpuimg.core.borders``).

reflect-101 mirrors without repeating the edge pixel (OpenCV
``BORDER_DEFAULT``, reference ``reflectBorder``). ``torch.nn.functional.pad``
with ``mode="reflect"`` is exactly this map and has the same validity bound,
``pad < n``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuimg_torch.core.validate import ParamError

REFLECT101 = "reflect101"
SHRINK = "shrink"


def reflect101_index(x, size: int):
    """Mirror-without-repeat index map: valid for -size < x < 2*size - 1.

    Works on ints and integer tensors (and numpy arrays)."""
    x = abs(x)
    over = x - (size - 1)
    return x - 2 * over * (over > 0)


def pad_reflect101(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad the trailing two dims of ``x`` by ``pad_h`` rows and ``pad_w``
    columns on each side with reflect-101."""
    h, w = x.shape[-2], x.shape[-1]
    if pad_h >= h or pad_w >= w:
        raise ParamError(
            f"reflect-101 padding ({pad_h}, {pad_w}) needs pad < n on each "
            f"axis; the image is {h}x{w}")
    lead = x.shape[:-2]
    y = F.pad(x.reshape((-1, h, w)), (pad_w, pad_w, pad_h, pad_h),
              mode="reflect")
    return y.reshape(lead + y.shape[-2:])
