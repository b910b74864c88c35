"""CLAHE bilinear 4-LUT mapping: the mapping kernel (csrc/clahe_map.cu) and
its plain PyTorch version.

Replaces ``tpuimg/kernels/lut.py::clahe_map_full`` (and, for tiny tiles,
``clahe_band_map``: the per-pixel kernel takes any tile grid). The plain
version is the gather form of ``tpuimg/kernels/onehot.py::lut_apply4``: the
four corner tables indexed by the pixel value.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuimg_torch.kernels import launch, require_cuda_tensor
from tpuimg_torch.ops.histogram import (
    _bilinear_blend, _blend_to_u8, _tile_coords)


def clahe_map_plain(img, tables, ytiles: int, xtiles: int, th: int, tw: int,
                    pad_top: int, pad_left: int, out_f32: bool = False):
    """Blend the four corner tables of every pixel of the u8 (h, w) frame.
    ``tables`` is (ytiles*xtiles, 256) float32. Returns u8 (h, w), or the raw
    float32 blend in [0, 255] when ``out_f32``."""
    h, w = img.shape
    ty1, ty2, ya = _tile_coords(h, ytiles, th, pad_top, False, img.device)
    tx1, tx2, xa = _tile_coords(w, xtiles, tw, pad_left, True, img.device)
    flat = tables.reshape(-1)
    v = img.to(torch.int64)

    def lut(ty, tx):
        return flat[(ty[:, None] * xtiles + tx[None, :]) * 256 + v]

    out = _bilinear_blend(lut(ty1, tx1), lut(ty1, tx2), lut(ty2, tx1),
                          lut(ty2, tx2), xa[None, :], ya[:, None])
    return out if out_f32 else _blend_to_u8(out)


def clahe_map(img, tables, ytiles: int, xtiles: int, th: int, tw: int,
              pad_top: int, pad_left: int, out_f32: bool = False):
    """``clahe_map_plain`` on a CPU tensor; the CUDA kernel otherwise."""
    if img.device.type == "cpu":
        return clahe_map_plain(img, tables, ytiles, xtiles, th, tw, pad_top,
                               pad_left, out_f32)
    require_cuda_tensor(img, "img", torch.uint8)
    require_cuda_tensor(tables, "tables", torch.float32)
    if tables.device != img.device or tables.shape != (ytiles * xtiles, 256):
        raise ValueError(
            f"tables must be ({ytiles * xtiles}, 256) on {img.device}, got "
            f"{tuple(tables.shape)} on {tables.device}")
    h, w = img.shape
    if ytiles * th < h or xtiles * tw < w or pad_top < 0 or pad_left < 0:
        raise ValueError(
            f"tile grid {ytiles}x{xtiles} of {th}x{tw} does not cover {h}x{w}")
    out = torch.empty((h, w), dtype=torch.float32 if out_f32 else torch.uint8,
                      device=img.device)
    inv_tw = float(np.float32(1.0) / np.float32(tw))
    launch("tpuimg_clahe_map", img.device, img.data_ptr(), h, w,
           tables.data_ptr(), ytiles, xtiles, th, pad_top, pad_left, inv_tw,
           int(out_f32), out.data_ptr())
    clahe_map.launches += 1
    return out


clahe_map.launches = 0
