"""CLAHE per-tile histograms: the tile-histogram kernel (csrc/tile_hist.cu)
and its plain PyTorch version.

Replaces ``tpuimg/kernels/hist.py::hist_tiles_fused``. ``hist256_tiled`` is
the plain form of ``tpuimg/kernels/onehot.py::hist256_tiled`` (a bincount per
tile instead of a one-hot contraction).
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.borders import reflect101_index
from tpuimg_torch.kernels import launch, require_cuda_tensor


def hist256_tiled(tiles: torch.Tensor) -> torch.Tensor:
    """Per-tile 256-bin histograms: (T, ...) u8 -> (T, 256) int32."""
    t = tiles.shape[0]
    flat = tiles.reshape(t, -1).to(torch.int64)
    flat = flat + 256 * torch.arange(t, device=tiles.device)[:, None]
    counts = torch.bincount(flat.reshape(-1), minlength=t * 256)
    return counts.reshape(t, 256).to(torch.int32)


def tile_hist_plain(img, ytiles: int, xtiles: int, th: int, tw: int,
                    pad_top: int, pad_left: int) -> torch.Tensor:
    """Histograms of the (ytiles*th, xtiles*tw) reflect-101 extension of the
    u8 (h, w) frame, centred by (pad_top, pad_left): (ytiles*xtiles, 256)
    int32, tile-major in row order."""
    h, w = img.shape
    dev = img.device
    ys = reflect101_index(torch.arange(ytiles * th, device=dev) - pad_top, h)
    xs = reflect101_index(torch.arange(xtiles * tw, device=dev) - pad_left, w)
    ext = img[ys[:, None], xs[None, :]]
    tiles = ext.reshape(ytiles, th, xtiles, tw).permute(0, 2, 1, 3)
    return hist256_tiled(tiles.reshape(ytiles * xtiles, th * tw))


def tile_hist(img, ytiles: int, xtiles: int, th: int, tw: int, pad_top: int,
              pad_left: int) -> torch.Tensor:
    """``tile_hist_plain`` on a CPU tensor; the CUDA kernel otherwise."""
    if img.device.type == "cpu":
        return tile_hist_plain(img, ytiles, xtiles, th, tw, pad_top, pad_left)
    require_cuda_tensor(img, "img", torch.uint8)
    h, w = img.shape
    pad_bot = ytiles * th - h - pad_top
    pad_right = xtiles * tw - w - pad_left
    if min(pad_top, pad_bot, pad_left, pad_right) < 0 or max(
            pad_top, pad_bot) >= h or max(pad_left, pad_right) >= w:
        raise ValueError(
            f"tile grid {ytiles}x{xtiles} of {th}x{tw} with pads "
            f"({pad_top}, {pad_left}) is not a reflect-101 extension of a "
            f"{h}x{w} frame")
    out = torch.zeros((ytiles * xtiles, 256), dtype=torch.int32,
                      device=img.device)
    launch("tpuimg_tile_hist", img.device, img.data_ptr(), h, w, ytiles,
           xtiles, th, tw, pad_top, pad_left, out.data_ptr())
    tile_hist.launches += 1
    return out


tile_hist.launches = 0
