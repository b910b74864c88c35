"""Separable Gaussian blur, reflect-101 border (port of
``tpuimg.ops.gaussian``).

On a CUDA tensor every frame size and batch runs the gaussian kernel
(kernels/sep_stencil.py, csrc/gaussian.cu) in one launch, for radius up to
its shared-memory ceiling; on a CPU tensor its plain version runs.
``gaussian_ypadded``, the per-shard op of ``parallel.stencil_sharded`` and
``enhance_sharded``, runs the same source's row-padded entry.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.validate import (
    check_image, check_radius, check_ypadded_rows)
from tpuimg_torch.kernels.sep_stencil import (
    gaussian_kernel, gaussian_ypadded_kernel)


def gaussian(img, radius: int, sigma: float):
    """Gaussian blur of a float image (..., H, W), reflect-101 border;
    float32 result. uint8 and float64 input is promoted to float32 (u8: a
    blur of the raw 0..255 values), as tpuimg promotes it."""
    check_radius(radius)
    img = as_image(img)
    check_image(img, "img",
                dtypes=[torch.float32, torch.float64, torch.uint8])
    return gaussian_kernel(img.to(torch.float32).contiguous(), radius, sigma)


def gaussian_ypadded(p, radius: int, sigma: float):
    """Gaussian blur of a block already padded by ``radius`` rows on the row
    axis (halo rows from a neighbour shard or the border policy), (...,
    H + 2r, W) -> float32 (..., H, W); x is reflect-101 in the kernel."""
    check_radius(radius)
    p = as_image(p)
    check_ypadded_rows(p, radius, "2*radius")
    return gaussian_ypadded_kernel(p.to(torch.float32).contiguous(), radius,
                                   sigma)
