"""Separable gaussian: the gaussian kernel (csrc/gaussian.cu) and its plain
PyTorch version.

Replaces ``tpuimg/kernels/sep_stencil.py::gaussian_pallas``. The plain
version is tpuimg's XLA form: pad by the radius (reflect-101), one pass along
the rows, then one down the columns, each in the symmetric form
k[i]*(left + right).
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.borders import pad_reflect101
from tpuimg_torch.core.kernelgen import gaussian_kernel_1d
from tpuimg_torch.core.validate import ParamError
from tpuimg_torch.kernels import (
    GAUSS_MAX_RADIUS, GaussTaps, launch, require_cuda_tensor)


def taps(radius: int, sigma: float) -> list[float]:
    """The 2*radius + 1 OpenCV weights as Python floats (exact f32 values)."""
    return [float(v) for v in gaussian_kernel_1d(2 * radius + 1, sigma)]


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


def gaussian_plain(img, radius: int, sigma: float):
    """Gaussian blur of float32 (..., H, W) frames, reflect-101 border."""
    w = taps(radius, sigma)
    p = pad_reflect101(img, radius, radius)
    rows = _sep_pass(p, w, img.ndim - 1)  # horizontal, rows still padded
    return _sep_pass(rows, w, img.ndim - 2)


def gaussian_kernel(img, radius: int, sigma: float):
    """``gaussian_plain`` on a CPU tensor; on a CUDA tensor one launch of
    the kernel over all leading dims. Takes radius <= GAUSS_MAX_RADIUS on
    the card, the largest whose 32x32 tile extent fits in a block's 227 KB
    of shared memory."""
    if img.device.type == "cpu":
        return gaussian_plain(img, radius, sigma)
    require_cuda_tensor(img, "img", torch.float32, batched=True)
    if radius > GAUSS_MAX_RADIUS:
        raise ParamError(
            f"the gaussian kernel takes radius <= {GAUSS_MAX_RADIUS} (its "
            f"(32 + 2r)^2 tile extent must fit in a block's 227 KB of shared "
            f"memory), got {radius}")
    h, w = img.shape[-2:]
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    tp = GaussTaps()
    wts = taps(radius, sigma)
    tp.w[:len(wts)] = wts
    launch("tpuimg_gaussian", img.device, img.data_ptr(),
           img.numel() // (h * w), h, w, tp, radius, out.data_ptr())
    gaussian_kernel.launches += 1
    return out


gaussian_kernel.launches = 0
