"""Grayscale morphology: erode / dilate / open / close, square structuring
element of side 2r+1, replicate border (port of ``tpuimg.ops.morphology``).

On a CUDA tensor erode and dilate run the morphology kernel
(kernels/sep_stencil.py, csrc/morphology.cu) and open and close the fused
open/close kernel (csrc/open_close.cu), all leading dims in one launch; on a
CPU tensor their plain versions run. The result is tpuimg's bit for bit, in
u8, int32 and float32 (NaN propagates), at any radius: a radius past the
frame's edges clamps.

Dtypes follow tpuimg's ``jnp.asarray``: float64 is taken as float32 and
int64 as int32; other dtypes raise ``DTypeError``.

``morph_ypadded``, the per-shard op of ``parallel.stencil_sharded``, runs
the morphology kernel's row-padded entry on a block whose rows already carry
the radius of halo rows.

Each public op records a root span of its own name (``ops.erode``,
``ops.dilate``, ``ops.morph_open``, ``ops.morph_close``) with a
``morph.kernel`` span around its kernel wrapper inside it;
``morph_ypadded`` records the ``morph.kernel`` span alone, so that it adds
no root inside a sharded call.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.validate import (
    check_image, check_radius, check_ypadded_rows)
from tpuimg_torch.kernels.sep_stencil import (
    MORPH_DTYPES, morph_ypadded_kernel, morphology_kernel, open_close_kernel)
from tpuimg_torch.profiling import span

# what JAX without x64 narrows an array to, as tpuimg receives it
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _prepared(img, radius: int):
    check_radius(radius)
    img = as_image(img)
    img = img.to(_NARROW.get(img.dtype, img.dtype))
    check_image(img, "img", dtypes=list(MORPH_DTYPES))
    return img.contiguous()


def _op(name: str, kernel, img, radius: int, mode: int):
    """The public op ``name``: its root span, the checks, then ``kernel``
    in a ``morph.kernel`` span."""
    with span(name, "entry"):
        img = _prepared(img, radius)
        with span("morph.kernel", "entry"):
            return kernel(img, radius, mode)


def erode(img, radius: int):
    """Min over a (2r+1)^2 square, replicate border."""
    return _op("ops.erode", morphology_kernel, img, radius, 0)


def dilate(img, radius: int):
    """Max over a (2r+1)^2 square, replicate border."""
    return _op("ops.dilate", morphology_kernel, img, radius, 1)


def morph_open(img, radius: int):
    """Erode, then dilate (square, replicate border)."""
    return _op("ops.morph_open", open_close_kernel, img, radius, 0)


def morph_close(img, radius: int):
    """Dilate, then erode (square, replicate border)."""
    return _op("ops.morph_close", open_close_kernel, img, radius, 1)


def morph_ypadded(p, radius: int, mode: int):
    """Erode (mode 0) or dilate (mode 1) a block already padded by
    ``radius`` rows on the row axis (halo rows), (..., H + 2r, W) ->
    (..., H, W); x is replicate in the kernel."""
    p = _prepared(p, radius)
    check_ypadded_rows(p, radius, "2*radius")
    with span("morph.kernel", "entry"):
        return morph_ypadded_kernel(p, radius, mode)
