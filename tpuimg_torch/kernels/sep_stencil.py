"""Separable stencils: the gaussian kernel (csrc/gaussian.cu), the erode /
dilate kernel (csrc/morphology.cu), the fused open / close kernel
(csrc/open_close.cu), and their plain PyTorch versions.

``gaussian_kernel`` replaces ``tpuimg/kernels/sep_stencil.py::
gaussian_pallas``. Its plain version is tpuimg's XLA form: pad by the radius
(reflect-101), one pass along the rows, then one down the columns, each in
the symmetric form k[i]*(left + right).

``gaussian_ypadded_kernel`` (the same source) replaces
``gaussian_pallas_ypadded``: a block whose rows already carry the radius of
halo rows on each side (a shard of ``parallel/sharding.py`` with its
neighbours' rows), (..., H + 2r, W) in and (..., H, W) out. Its plain version
is tpuimg's XLA form of ``gaussian_ypadded``: pad x only (reflect-101), the
row pass, then the column pass over the block's own rows.

``morphology_kernel`` replaces ``morphology_pallas``,
``morph_ypadded_kernel`` (the same source) ``morph_pallas_ypadded``, on a
row-padded block as above, replicate in x only, and ``open_close_kernel``
replaces ``open_close_pallas``. All three run van Herk/Gil-Werman window
extremes (about three compares an output at any radius, csrc/morph.cuh)
over square tiles that ``morph_tile`` and ``open_close_tile`` size, u8 four
to a word down the columns; open/close keeps stage 1 in shared memory: open
r15 on two 2160x3840 u8 frames in 0.1248 ms on an NVIDIA H100 80GB HBM3 at
700.00 W (chip_smoke.py; bound 0.0099 ms, by bytes; the tile kernel it
replaced took 1.2534). The plain versions are
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
    GAUSS_MAX_RADIUS, SMEM_MAX_BYTES, GaussTaps, launch, require_cuda_tensor)

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


def gaussian_ypadded_plain(p, radius: int, sigma: float):
    """Gaussian blur of float32 (..., H + 2r, W) row-padded blocks:
    (..., H, W), reflect-101 in x, the block's own rows in y."""
    w = taps(radius, sigma)
    rows = _sep_pass(pad_reflect101(p, 0, radius), w, p.ndim - 1)
    return _sep_pass(rows, w, p.ndim - 2)


def _gauss_launch(entry: str, src, radius: int, sigma: float, cut: int):
    """The checks and the one launch of a gaussian C entry over the frames
    of ``src``, whose outputs have ``cut`` rows fewer; returns the output."""
    require_cuda_tensor(src, "img", torch.float32, batched=True)
    if radius > GAUSS_MAX_RADIUS:
        raise ParamError(
            f"the gaussian kernel takes radius <= {GAUSS_MAX_RADIUS} (its "
            f"(32 + 2r)^2 tile extent must fit in a block's 227 KB of shared "
            f"memory), got {radius}")
    h, w = src.shape[-2] - cut, src.shape[-1]
    out = torch.empty(src.shape[:-2] + (h, w), dtype=torch.float32,
                      device=src.device)
    if out.numel():
        tp = GaussTaps()
        wts = taps(radius, sigma)
        tp.w[:len(wts)] = wts
        launch(entry, src.device, src.data_ptr(), out.numel() // (h * w), h,
               w, tp, radius, out.data_ptr())
    return out


def gaussian_kernel(img, radius: int, sigma: float):
    """``gaussian_plain`` on a CPU tensor; on a CUDA tensor one launch of
    the kernel over all leading dims. Takes radius <= GAUSS_MAX_RADIUS on
    the card, the largest whose 32x32 tile extent fits in a block's 227 KB
    of shared memory."""
    if img.device.type == "cpu":
        return gaussian_plain(img, radius, sigma)
    return _gauss_launch("tpuimg_gaussian", img, radius, sigma, 0)


def gaussian_ypadded_kernel(p, radius: int, sigma: float):
    """``gaussian_ypadded_plain`` on a CPU tensor; on a CUDA tensor one
    launch over all leading dims, any width, radius <= GAUSS_MAX_RADIUS.
    ``p`` is float32 (..., H + 2r, W) with H >= 1."""
    if p.device.type == "cpu":
        return gaussian_ypadded_plain(p, radius, sigma)
    return _gauss_launch("tpuimg_gaussian_ypadded", p, radius, sigma,
                         2 * radius)


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


def _clamped(x, radius: int, dim: int):
    """Pad ``dim`` by ``radius`` on each side, repeating the edge element."""
    n = x.shape[dim]
    idx = torch.arange(-radius, n + radius, device=x.device).clamp(0, n - 1)
    return x.index_select(dim, idx)


def pad_replicate(x, radius: int):
    """Pad the trailing two dims by ``radius`` on each side, repeating the
    edge pixel; any radius and dtype."""
    return _clamped(_clamped(x, radius, -2), radius, -1)


def morphology_plain(img, radius: int, mode: int):
    """Erode (mode 0) or dilate (mode 1) (..., H, W) frames over a
    (2r+1)^2 square, replicate border: along the rows, then down the
    columns."""
    p = pad_replicate(img, radius)
    rows = _extreme_pass(p, radius, img.ndim - 1, mode)
    return _extreme_pass(rows, radius, img.ndim - 2, mode)


def morph_ypadded_plain(p, radius: int, mode: int):
    """Erode (mode 0) or dilate (mode 1) (..., H + 2r, W) row-padded blocks:
    (..., H, W), replicate in x, the block's own rows in y."""
    rows = _extreme_pass(_clamped(p, radius, -1), radius, p.ndim - 1, mode)
    return _extreme_pass(rows, radius, p.ndim - 2, mode)


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
    min(radius, max(H, W) - 1) <= morph_max_radius(dtype) (a larger radius
    reaches past every edge and clamps), over tiles of ``morph_tile``; two
    above it, a row pass into a scratch frame and a column pass out of it
    (the two-launch route, where ``morph_tile`` is None)."""
    _check_morph(img, mode)
    if img.device.type == "cpu":
        return morphology_plain(img, radius, mode)
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    n, h, w = _frames(img)
    r = min(radius, max(h, w) - 1)  # a window past every edge clamps
    split = morph_tile(r, img.element_size()) is None
    scratch = torch.empty_like(img) if split else None
    launch("tpuimg_morphology", img.device, img.data_ptr(), n, h, w,
           MORPH_DTYPES[img.dtype], r, mode,
           None if scratch is None else scratch.data_ptr(), out.data_ptr())
    return out


def morph_ypadded_kernel(p, radius: int, mode: int):
    """``morph_ypadded_plain`` on a CPU tensor; on a CUDA tensor one call of
    the kernel over all leading dims: one launch for radius <=
    morph_max_radius(dtype), a row pass into a scratch block and a column
    pass out of it above. The radius is the block's halo depth and is never
    shrunk to the frame. ``p`` is (..., H + 2r, W) with H >= 1."""
    _check_morph(p, mode)
    if p.device.type == "cpu":
        return morph_ypadded_plain(p, radius, mode)
    n, hin, w = _frames(p)
    h = hin - 2 * radius
    out = torch.empty(p.shape[:-2] + (h, w), dtype=p.dtype, device=p.device)
    if out.numel() == 0:
        return out
    split = morph_tile(radius, p.element_size()) is None
    scratch = torch.empty_like(p) if split else None
    launch("tpuimg_morphology_ypadded", p.device, p.data_ptr(), n, h, w,
           MORPH_DTYPES[p.dtype], radius, mode,
           None if scratch is None else scratch.data_ptr(), out.data_ptr())
    return out


# the tiles of csrc/morphology.cu and csrc/open_close.cu, largest first, and
# the footprint under which two blocks share an SM (half of its 228 KB, less
# the 1 KB the card keeps for each block)
OPEN_CLOSE_TILES = (128, 64, 32, 16)
OPEN_CLOSE_PAIR_BYTES = 233_472 // 2 - 1024


def _row_words(n: int, itemsize: int) -> int:
    """csrc/morph.cuh row_words: the words of a row of n elements, made
    odd."""
    return (n * itemsize + 3) // 4 | 1


def morph_smem(tile: int, radius: int, itemsize: int) -> int:
    """The shared-memory bytes of the erode/dilate tile kernel
    (csrc/morphology.cu MorphGeom::bytes): (tile + 2r) rows of (tile + 2r)
    and of tile elements."""
    e = tile + 2 * radius
    return 4 * e * (_row_words(e, itemsize) + _row_words(tile, itemsize))


def open_close_smem(tile: int, radius: int, itemsize: int) -> int:
    """The shared-memory bytes of the open/close kernel (csrc/open_close.cu
    OcGeom::bytes): (tile + 4r) rows of (tile + 4r) and (tile + 2r)
    elements."""
    e = tile + 4 * radius
    return 4 * e * (_row_words(e, itemsize)
                    + _row_words(tile + 2 * radius, itemsize))


def _max_radius(plan, dtype: torch.dtype) -> int:
    size = torch.empty((), dtype=dtype).element_size()
    r = 0
    while plan(r + 1, size) is not None:
        r += 1
    return r


# csrc/morphology.cu kWideTile, kNarrowMaxRadius: tiles narrower than 64
# stage over 9x their outputs at the radii that need them and lose to the
# two-launch route; they run only up to the r = 96 the 32x32 tiles reached
MORPH_WIDE_TILE = 64
MORPH_NARROW_MAX_RADIUS = 96


def morph_tile(radius: int, itemsize: int) -> int | None:
    """The erode/dilate tile kernel's output tile side at this radius and
    element size (csrc/morphology.cu morph_tile): the largest of
    OPEN_CLOSE_TILES whose footprint lets two blocks share an SM, unless the
    largest that fits a block stages less than half as much an output
    ((tile + 2r)^2 / tile^2); None where no tile fits, or where the tile
    would be narrower than MORPH_WIDE_TILE past MORPH_NARROW_MAX_RADIUS:
    there the two-launch route runs."""
    fits = [t for t in OPEN_CLOSE_TILES
            if morph_smem(t, radius, itemsize) <= SMEM_MAX_BYTES]
    pair = [t for t in fits
            if morph_smem(t, radius, itemsize) <= OPEN_CLOSE_PAIR_BYTES]
    if not fits:
        return None
    tile = fits[0]
    if pair:
        big, small = fits[0], pair[0]
        eb, es = big + 2 * radius, small + 2 * radius
        if not 2 * eb * eb * small * small < es * es * big * big:
            tile = small
    narrow = tile < MORPH_WIDE_TILE and radius > MORPH_NARROW_MAX_RADIUS
    return None if narrow else tile


def morph_max_radius(dtype: torch.dtype) -> int:
    """The largest radius the erode/dilate tile kernel takes in one launch
    for ``dtype``: 191 for u8, 96 for int32 and float32."""
    return _max_radius(morph_tile, dtype)


def open_close_tile(radius: int, itemsize: int) -> int | None:
    """The open/close kernel's output tile side at this radius and element
    size: the largest of OPEN_CLOSE_TILES whose footprint lets two blocks
    share an SM, else the largest that fits a block, else None (past the
    kernel's ceiling)."""
    fits = [t for t in OPEN_CLOSE_TILES
            if open_close_smem(t, radius, itemsize) <= SMEM_MAX_BYTES]
    pair = [t for t in fits
            if open_close_smem(t, radius, itemsize) <= OPEN_CLOSE_PAIR_BYTES]
    return (pair or fits or [None])[0]


def open_close_max_radius(dtype: torch.dtype) -> int:
    """The largest radius the fused kernel takes in one launch for
    ``dtype``: 93 for u8, 44 for int32 and float32."""
    return _max_radius(open_close_tile, dtype)


def open_close_kernel(img, radius: int, mode: int):
    """``open_close_plain`` on a CPU tensor; on a CUDA tensor one launch of
    the fused kernel over all leading dims, the stage-1 result kept in
    shared memory, for min(radius, max(H, W) - 1) <=
    open_close_max_radius(dtype), over tiles of ``open_close_tile``. Above
    that the two stages are two ``morphology_kernel`` calls."""
    _check_morph(img, mode)
    if img.device.type == "cpu":
        return open_close_plain(img, radius, mode)
    if img.numel() == 0:
        return torch.empty_like(img)
    n, h, w = _frames(img)
    r = min(radius, max(h, w) - 1)
    tile = open_close_tile(r, img.element_size())
    if tile is None:
        return morphology_kernel(morphology_kernel(img, radius, mode), radius,
                                 1 - mode)
    out = torch.empty_like(img)
    launch("tpuimg_open_close", img.device, img.data_ptr(), n, h, w,
           MORPH_DTYPES[img.dtype], r, tile, mode, out.data_ptr())
    return out
