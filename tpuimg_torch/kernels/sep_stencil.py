"""Separable stencils: the gaussian kernel (csrc/gaussian.cu), the erode /
dilate kernel (csrc/morphology.cu), the fused open / close kernel
(csrc/open_close.cu), and their plain PyTorch versions.

``gaussian_kernel`` replaces ``tpuimg/kernels/sep_stencil.py::
gaussian_pallas``. Its plain version is tpuimg's XLA form: pad by the radius
(reflect-101), one pass along the rows, then one down the columns, each in
the symmetric form k[i]*(left + right).

``morphology_kernel`` replaces ``morphology_pallas`` and
``open_close_kernel`` replaces ``open_close_pallas``. The plain versions are
tpuimg's XLA form (``tpuimg/ops/morphology.py``): replicate pad, then the
minimum or maximum over the 2r+1 shifted slices, along the rows, then down
the columns; open and close compose two of them. u8, int32 and float32 are
computed natively (tpuimg widens u8 to bf16 for the TPU's tiles; the
results are the same), and NaN propagates, as ``torch.minimum`` does.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.borders import pad_reflect101
from tpuimg_torch.core.kernelgen import gaussian_kernel_1d
from tpuimg_torch.core.validate import ParamError
from tpuimg_torch.kernels import (
    GAUSS_MAX_RADIUS, MORPH_MAX_TILE_RADIUS, OPEN_CLOSE_MAX_RADIUS, GaussTaps,
    launch, require_cuda_tensor)

# the dtypes the morphology kernels take, and their csrc/morph.cuh codes
MORPH_DTYPES = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}


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


def _extreme_pass(x, radius: int, dim: int, mode: int):
    """The minimum (mode 0) or maximum (mode 1) over every 2r+1 window along
    ``dim`` (already padded by the radius there), as direct shifted
    slices."""
    fn = torch.minimum if mode == 0 else torch.maximum
    n = x.shape[dim] - 2 * radius
    acc = x.narrow(dim, 0, n)
    for off in range(1, 2 * radius + 1):
        acc = fn(acc, x.narrow(dim, off, n))
    return acc


def pad_replicate(x, radius: int):
    """Pad the trailing two dims by ``radius`` on each side, repeating the
    edge pixel; any radius and dtype."""
    h, w = x.shape[-2:]
    ys = torch.arange(-radius, h + radius, device=x.device).clamp(0, h - 1)
    xs = torch.arange(-radius, w + radius, device=x.device).clamp(0, w - 1)
    return x.index_select(-2, ys).index_select(-1, xs)


def morphology_plain(img, radius: int, mode: int):
    """Erode (mode 0) or dilate (mode 1) (..., H, W) frames over a
    (2r+1)^2 square, replicate border: along the rows, then down the
    columns."""
    p = pad_replicate(img, radius)
    rows = _extreme_pass(p, radius, img.ndim - 1, mode)
    return _extreme_pass(rows, radius, img.ndim - 2, mode)


def open_close_plain(img, radius: int, mode: int):
    """Open (mode 0: erode, then dilate) or close (mode 1: dilate, then
    erode), each stage with its own replicate border."""
    first = morphology_plain(img, radius, mode)
    return morphology_plain(first, radius, 1 - mode)


def _check_morph(img, mode: int):
    if mode not in (0, 1):
        raise ParamError(f"mode must be 0 or 1, got {mode!r}")
    if img.device.type != "cpu":
        require_cuda_tensor(img, "img", tuple(MORPH_DTYPES), batched=True)


def _frames(img):
    h, w = img.shape[-2:]
    return img.numel() // (h * w), h, w


def morphology_kernel(img, radius: int, mode: int):
    """``morphology_plain`` on a CPU tensor; on a CUDA tensor one call of
    the kernel over all leading dims: one launch for
    min(radius, max(H, W) - 1) <= MORPH_MAX_TILE_RADIUS (a larger radius
    reaches past every edge and clamps), two above it, a row pass into a
    scratch frame and a column pass out of it. ``launches`` counts the
    calls, ``split_launches`` those that took the two-launch route."""
    _check_morph(img, mode)
    if img.device.type == "cpu":
        return morphology_plain(img, radius, mode)
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    n, h, w = _frames(img)
    r = min(radius, max(h, w) - 1)  # a window past every edge clamps
    scratch = torch.empty_like(img) if r > MORPH_MAX_TILE_RADIUS else None
    launch("tpuimg_morphology", img.device, img.data_ptr(), n, h, w,
           MORPH_DTYPES[img.dtype], r, mode,
           None if scratch is None else scratch.data_ptr(), out.data_ptr())
    morphology_kernel.launches += 1
    morphology_kernel.split_launches += scratch is not None
    return out


morphology_kernel.launches = 0
morphology_kernel.split_launches = 0


def open_close_kernel(img, radius: int, mode: int):
    """``open_close_plain`` on a CPU tensor; on a CUDA tensor one launch of
    the fused kernel over all leading dims, the stage-1 result kept in
    shared memory, for min(radius, max(H, W) - 1) <= OPEN_CLOSE_MAX_RADIUS
    (its (32 + 4r)^2 extent then fits a block's 227 KB). Above that the
    two stages are two ``morphology_kernel`` calls, which count on
    ``morphology_kernel.launches`` and not on ``launches``."""
    _check_morph(img, mode)
    if img.device.type == "cpu":
        return open_close_plain(img, radius, mode)
    if img.numel() == 0:
        return torch.empty_like(img)
    n, h, w = _frames(img)
    r = min(radius, max(h, w) - 1)
    if r > OPEN_CLOSE_MAX_RADIUS:
        return morphology_kernel(morphology_kernel(img, radius, mode), radius,
                                 1 - mode)
    out = torch.empty_like(img)
    launch("tpuimg_open_close", img.device, img.data_ptr(), n, h, w,
           MORPH_DTYPES[img.dtype], r, mode, out.data_ptr())
    open_close_kernel.launches += 1
    return out


open_close_kernel.launches = 0
