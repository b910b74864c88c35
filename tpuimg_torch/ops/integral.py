"""Integral image: the inclusive 2-D prefix sum, int32 (port of
``tpuimg.ops.integral``).

uint8 frames run the scan kernel (kernels/scan2d.py, csrc/integral.cu) on a
CUDA tensor, all leading dims in one launch; other integer dtypes and bool
are a cumulative sum wrapped to int32 as plain PyTorch on the tensor's
device, as tpuimg runs them in XLA. No leading zero row or column
(Integral/main.cpp:124-125); sums wrap mod 2^32.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.validate import DTypeError, check_image, dtype_name
from tpuimg_torch.kernels.scan2d import integral_kernel, integral_plain


def integral(img):
    """Inclusive 2D prefix sum over the trailing two dims; int32 result."""
    img = as_image(img)
    check_image(img, "img")
    if img.is_floating_point() or img.is_complex():
        raise DTypeError(
            f"integral is the reference's uint8 -> int32 prefix sum "
            f"(Integral/integral_d.h:6); got float dtype "
            f"{dtype_name(img.dtype)} — use torch.cumsum directly for float "
            f"integrals"
        )
    if img.dtype == torch.uint8:
        return integral_kernel(img.contiguous())
    return integral_plain(img)
