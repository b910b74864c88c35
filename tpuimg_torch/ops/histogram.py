"""Global histogram equalization and CLAHE (port of
``tpuimg.ops.histogram``).

``hist_equalize`` is the reference's gCalcHistUnroll8 -> gCalcHeTable ->
gMapping. On a CUDA tensor it is two kernel launches for a frame or a whole
batch: the histogram kernel ending in the 256-entry tables
(kernels/hist.py::he_tables, the block that holds a frame's final counts
builds its table) and the table lookup (kernels/lut.py). On a CPU tensor,
and for the sharded path's summed partial histograms
(parallel/sharding.py), the tables are plain PyTorch (``_he_tables``), as
they are XLA glue in the JAX package.

CLAHE is the chain gCalcTileHistsUnroll -> gClipLimit -> gCreateTable ->
gInterpolateMappingUnroll (Claher::run). On a CUDA tensor the per-tile
histograms, clip/redistribute and the float tables are one kernel launch
(kernels/hist.py::tile_tables) and the bilinear mapping another; on a CPU
tensor, and for the sharded path's summed partial histograms
(parallel/sharding.py), the tables are plain PyTorch (``_clahe_tables``).

Rounding follows the CUDA ops: ``__float2int_rn`` -> round half to even,
``__float2int_rz`` -> trunc, float -> u8 assignment -> truncation.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.layout import cdiv
from tpuimg_torch.core.validate import (
    ParamError, ShapeError, check_image, check_positive, check_radius)
from tpuimg_torch.kernels.hist import (
    he_factor, he_tables_frames, hist256, hist256_frames, hist256_groups,
    tile_hist, tile_tables)
from tpuimg_torch.profiling import span


def bincount256(x, per_leading: bool = False):
    """256-bin histogram(s) of a uint8 array, int32.

    per_leading=False reduces everything; True keeps the leading dim and
    reduces the rest (one histogram per leading index)."""
    x = as_image(x).contiguous()
    if per_leading:
        return hist256_groups(x.reshape(x.shape[0], -1))
    return hist256(x)


def apply_lut(table, img):
    """dst = table[img] (gMapping) for a uint8 array of any shape; a float
    table gives float32, as tpuimg's ``lut_apply`` does."""
    from tpuimg_torch.kernels.lut import lut_gather

    img = as_image(img).contiguous()
    table = as_image(table, like=img)
    if table.is_floating_point():
        table = table.to(torch.float32)
    return lut_gather(table, img.reshape(1, -1)).reshape(img.shape)


def _he_tables(hists, pixels: int):
    """table[v] = rint(min(255, cdf[v] * 256/N)) (gCalcHeTable) for (..., 256)
    histograms: u8 (..., 256). The factor is the host's float32 of a float64
    quotient (hist_equalization.cpp:58), multiplied, never divided by; the
    cdf rounds to float32 to nearest even above 2^24; min comes before the
    half-to-even rounding, so cdf * factor = 256 gives 255."""
    cdf = torch.cumsum(hists, dim=-1).to(torch.float32)
    return torch.round(torch.clamp(cdf * he_factor(pixels),
                                   max=255.0)).to(torch.uint8)


def hist_equalize(img):
    """Global HE of a uint8 image: table[v] = rint(min(255, cdf[v]*256/N)).
    Leading batch dims (..., H, W) get one histogram and table per frame.

    The intended algorithm, not the reference kernel's undercount of the
    last x-block of each row band (KNOWN_DIVERGENCES.md section 1)."""
    from tpuimg_torch.kernels.lut import lut_gather, lut_gather_frames

    with span("ops.hist_equalize", "entry"):
        img = as_image(img)
        check_image(img, "img", dtypes=[torch.uint8])
        img = img.contiguous()
        h, w = img.shape[-2:]
        flat = img.reshape(-1, h, w)
        if img.device.type != "cpu":
            # the kernel that counts a frame also builds its table
            with span("he.hist", "entry"):
                tables = he_tables_frames(flat)
        else:
            with span("he.hist", "entry"):
                hists = hist256_frames(flat)
            with span("he.tables", "glue"):
                tables = _he_tables(hists, h * w)
        with span("he.map", "entry"):
            if img.ndim > 2:
                return lut_gather_frames(tables, flat).reshape(img.shape)
            return lut_gather(tables[0], img)


def _clip_redistribute(hists, limit: int):
    """Vectorized gClipLimit: every bin gets ``steal >> 8`` of the total
    excess over ``limit``; the residual r = steal & 255 lands one count each
    on bins (i << 8) // r for i < r, counted in closed form per bin."""
    excess = torch.clamp(hists - limit, min=0)
    steal = excess.sum(dim=-1, keepdim=True)
    clipped = torch.clamp(hists, max=limit)
    bonus = steal >> 8
    residual = steal - (bonus << 8)  # in [0, 255]
    b = torch.arange(256, dtype=steal.dtype, device=hists.device)
    # #{i : (i << 8) // r == b, 0 <= i < r} = max(0, hi - lo + 1)
    lo = -torch.div(-b * residual, 256, rounding_mode="floor")
    hi = torch.div((b + 1) * residual - 1, 256, rounding_mode="floor")
    extra = torch.where(residual > 0, torch.clamp(hi - lo + 1, min=0), 0)
    return clipped + bonus + extra


def _bilinear_blend(t11, t12, t21, t22, xa, ya):
    """The 4-LUT bilinear lerp (gInterpolateMappingUnroll). Each product and
    sum is its own PyTorch op, so nothing is contracted into an FMA; the CUDA
    mapping kernel rounds the same way with __fmul_rn/__fadd_rn."""
    xa1 = 1.0 - xa
    ya1 = 1.0 - ya
    return (t11 * xa1 + t12 * xa) * ya1 + (t21 * xa1 + t22 * xa) * ya


def _blend_to_u8(out):
    """float -> uchar device assignment: truncate, then clamp."""
    return torch.clamp(torch.trunc(out), 0.0, 255.0).to(torch.uint8)


def _tile_coords(n: int, tiles: int, tsize: int, pad: int, use_recip: bool,
                 device, start: int = 0):
    """Per-axis interpolation coordinates of positions start .. start + n - 1
    (the counterpart of tpuimg's ``_tile_coord_runs``, which groups the same
    values into static runs).

    The reference's f32 math: y uses a true division (``__fdiv_rn``), x a
    multiply by the host's f32 reciprocal; the tile index truncates toward
    zero. Returns (t1, t2, frac) with t2 = min(t1 + 1, tiles - 1); frac may be
    negative at the leading border."""
    idx = torch.arange(start, start + n, dtype=torch.float32, device=device)
    if use_recip:
        inv = float(np.float32(1.0) / np.float32(tsize))
        tf = (idx + pad) * inv - 0.5
    else:
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which is not __fdiv_rn
        tf = (idx + pad) / torch.full_like(idx, float(tsize)) - 0.5
    t1f = torch.trunc(tf)
    t1 = t1f.to(torch.int64)
    return t1, torch.clamp(t1 + 1, max=tiles - 1), tf - t1f


def _clahe_geometry(h: int, w: int, xtiles: int, ytiles: int):
    """Tile size and centred padding (clahe.cpp:28-38): (th, tw, pad_top,
    pad_left). Raises ParamError where the reflect-101 extension would need
    more padding than the frame has."""
    tw, th = cdiv(w, xtiles), cdiv(h, ytiles)
    pad_left = (tw * xtiles - w) >> 1
    pad_top = (th * ytiles - h) >> 1
    pad_bot = th * ytiles - h - pad_top
    pad_right = tw * xtiles - w - pad_left
    if max(pad_top, pad_bot) + 1 > h or max(pad_left, pad_right) + 1 > w:
        raise ParamError(
            f"tile grid {xtiles}x{ytiles} needs more reflect padding than the "
            f"{h}x{w} image can provide (reference dLimitSize has the same "
            f"validity bound)"
        )
    return th, tw, pad_top, pad_left


def _clahe_scale(clip_limit: float, th: int, tw: int) -> tuple[int, float]:
    """(limit, fr): the clip limit in counts (clahe.cpp:87), at most the
    tile's th*tw pixels (a limit at or above them clips nothing), and the
    tables' scale, the f32 of 255/tile_pixels (gCreateTable)."""
    limit = int(tw * th * clip_limit / 256 + 0.5)
    return min(limit, th * tw), float(np.float32(255.0 / (tw * th)))


def _clahe_tables(hists, clip_limit: float, th: int, tw: int):
    """Clip + redistribute (clahe.cpp:87), then the float tables
    cdf * 255/tile_pixels (gCreateTable): (T, 256) float32."""
    limit, fr = _clahe_scale(clip_limit, th, tw)
    hists = _clip_redistribute(hists, limit)
    return torch.cumsum(hists, dim=-1).to(torch.float32) * fr


def _clahe_checks(img, clip_limit: float, xtiles: int, ytiles: int):
    """CLAHE's checks of the frame and the parameters, then its geometry
    (th, tw, pad_top, pad_left)."""
    check_image(img, "img", dtypes=[torch.uint8])
    check_radius(xtiles, name="xtiles")
    check_radius(ytiles, name="ytiles")
    check_positive(clip_limit, "clip_limit")
    if img.ndim != 2:
        raise ShapeError(
            f"clahe operates on a single (H, W) image, got shape "
            f"{tuple(img.shape)}; call it once per frame for a batch"
        )
    return _clahe_geometry(*img.shape, xtiles, ytiles)


def _clahe_front(img, clip_limit: float, xtiles: int, ytiles: int):
    """Validated CLAHE front end: per-tile clipped tables + mapping geometry.

    Returns (tables (ytiles*xtiles, 256) f32, th, tw, pad_top, pad_left),
    as ``tpuimg.ops.histogram._clahe_front`` does."""
    th, tw, pad_top, pad_left = _clahe_checks(img, clip_limit, xtiles, ytiles)
    if img.device.type != "cpu":
        # the kernel sees whole tiles: the tables leave its launch
        with span("clahe.hist", "entry"):
            tables = tile_tables(img, ytiles, xtiles, th, tw, pad_top,
                                 pad_left, *_clahe_scale(clip_limit, th, tw))
    else:
        with span("clahe.hist", "entry"):
            hists = tile_hist(img, ytiles, xtiles, th, tw, pad_top, pad_left)
        with span("clahe.tables", "glue"):
            tables = _clahe_tables(hists, clip_limit, th, tw)
    return tables, th, tw, pad_top, pad_left


def clahe(img, clip_limit: float = 1.0, xtiles: int = 8, ytiles: int = 8):
    """CLAHE of a uint8 (H, W) image, matching Claher::run."""
    from tpuimg_torch.kernels.lut import clahe_map

    img = as_image(img).contiguous()
    tables, th, tw, pad_top, pad_left = _clahe_front(
        img, clip_limit, xtiles, ytiles)
    with span("clahe.map", "entry"):
        return clahe_map(img, tables, ytiles, xtiles, th, tw,
                         pad_top, pad_left)
