"""Separable Gaussian blur, reflect-101 border (port of
``tpuimg.ops.gaussian``).

Only the plain form is ported: on a CUDA tensor ``gaussian`` needs the
counterpart of ``tpuimg/kernels/sep_stencil.py::gaussian_pallas`` and raises
until it exists. The enhance pipeline does not call this on the card; its
tail kernel smooths the frame itself.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.borders import pad_reflect101
from tpuimg_torch.core.kernelgen import gaussian_kernel_1d
from tpuimg_torch.core.validate import NotPortedError, check_image, check_radius


def _sep_pass(img, weights, dim: int):
    """One separable pass along ``dim`` (already padded by the radius there),
    with the symmetric-kernel form k[i]*(left + right)."""
    radius = (len(weights) - 1) // 2
    n = img.shape[dim] - 2 * radius

    def sl(off):
        return img.narrow(dim, off, n)

    acc = weights[radius] * sl(radius)
    for i in range(1, radius + 1):
        acc = acc + weights[radius - i] * (sl(radius - i) + sl(radius + i))
    return acc


def taps(radius: int, sigma: float) -> list[float]:
    """The 2*radius + 1 OpenCV weights as Python floats (exact f32 values)."""
    return [float(v) for v in gaussian_kernel_1d(2 * radius + 1, sigma)]


def gaussian(img, radius: int, sigma: float):
    """Gaussian blur of a float image (..., H, W), reflect-101 border;
    float32 result. uint8 input is promoted (blur of the raw 0..255 values)."""
    check_radius(radius)
    img = torch.as_tensor(img)
    check_image(img, "img",
                dtypes=[torch.float32, torch.float64, torch.uint8])
    if img.device.type != "cpu":
        raise NotPortedError(
            "gaussian on a CUDA tensor needs the port of "
            "tpuimg/kernels/sep_stencil.py::gaussian_pallas, which is not "
            "ported yet")
    w = taps(radius, sigma)
    p = pad_reflect101(img.to(torch.float32), radius, radius)
    rows = _sep_pass(p, w, img.ndim - 1)  # horizontal, rows still padded
    return _sep_pass(rows, w, img.ndim - 2)
