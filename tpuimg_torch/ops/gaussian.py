"""Separable Gaussian blur, reflect-101 border (port of
``tpuimg.ops.gaussian``).

On a CUDA tensor every frame size and batch runs the gaussian kernel
(kernels/sep_stencil.py, csrc/gaussian.cu) in one launch, for radius up to
its shared-memory ceiling; on a CPU tensor its plain version runs.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.validate import check_image, check_radius
from tpuimg_torch.kernels.sep_stencil import gaussian_kernel


def gaussian(img, radius: int, sigma: float):
    """Gaussian blur of a float image (..., H, W), reflect-101 border;
    float32 result. uint8 and float64 input is promoted to float32 (u8: a
    blur of the raw 0..255 values), as tpuimg promotes it."""
    check_radius(radius)
    img = torch.as_tensor(img)
    check_image(img, "img",
                dtypes=[torch.float32, torch.float64, torch.uint8])
    return gaussian_kernel(img.to(torch.float32).contiguous(), radius, sigma)
