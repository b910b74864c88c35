"""Table lookups: the CLAHE mapping kernel (csrc/clahe_map.cu), the gather
kernel (csrc/lut_gather.cu) and their plain PyTorch versions.

``clahe_map`` replaces ``tpuimg/kernels/lut.py::clahe_map_full`` (the
per-pixel kernel takes any tile grid); its plain version is the gather form
of ``tpuimg/kernels/onehot.py::lut_apply4``: the four corner tables indexed
by the pixel value. ``clahe_band_map`` (the same source) replaces
``clahe_band_map``: the blend of a band of rows starting at global row y0
of a frame, with the frame's tables and geometry (a row shard of
``parallel/sharding.py::clahe_sharded``); ``clahe_map`` is its band at
y0 = 0, and may scale its float32 output in the kernel's store
(``scale``): the enhance pipeline takes the blend times 1/255 from it.
``lut_gather`` and ``lut_gather_frames`` replace the TPU kernels of the
same names (one table; one table per frame); both launch the one gather
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuimg_torch.core.layout import cdiv, round_up
from tpuimg_torch.kernels import launch, require_cuda_tensor, sm_count
from tpuimg_torch.ops.histogram import (
    _bilinear_blend, _blend_to_u8, _tile_coords)


def clahe_band_map_plain(img, tables, ytiles: int, xtiles: int, th: int,
                         tw: int, pad_top: int, pad_left: int, y0: int,
                         out_f32: bool = False, scale: float = 1.0):
    """Blend the four corner tables of every pixel of the u8 (h, w) rows
    [y0, y0 + h) of a frame. ``tables`` is the frame's (ytiles*xtiles, 256)
    float32. Returns u8 (h, w), or when ``out_f32`` the float32 blend times
    ``scale``, an f32 product (1.0 keeps the raw blend's bits)."""
    h, w = img.shape
    ty1, ty2, ya = _tile_coords(h, ytiles, th, pad_top, False, img.device,
                                start=y0)
    tx1, tx2, xa = _tile_coords(w, xtiles, tw, pad_left, True, img.device)
    flat = tables.reshape(-1)
    v = img.to(torch.int64)

    def lut(ty, tx):
        return flat[(ty[:, None] * xtiles + tx[None, :]) * 256 + v]

    out = _bilinear_blend(lut(ty1, tx1), lut(ty1, tx2), lut(ty2, tx1),
                          lut(ty2, tx2), xa[None, :], ya[:, None])
    return out * scale if out_f32 else _blend_to_u8(out)


def clahe_map_plain(img, tables, ytiles: int, xtiles: int, th: int, tw: int,
                    pad_top: int, pad_left: int, out_f32: bool = False,
                    scale: float = 1.0):
    """The blend of the whole u8 (h, w) frame: its band at y0 = 0."""
    return clahe_band_map_plain(img, tables, ytiles, xtiles, th, tw, pad_top,
                                pad_left, 0, out_f32, scale)


def check_clahe_args(img, tables, ytiles: int, xtiles: int, th: int,
                     tw: int, pad_top: int, pad_left: int,
                     y0: int = 0) -> None:
    """The checks of the kernels that blend CLAHE tables on the card
    (clahe_map.cu, enhance_tail_clahe.cu): ``img`` is the rows [y0, y0 + h)
    of a frame whose tile grid covers them past its padding, so that every
    table index the blend takes is in the grid."""
    require_cuda_tensor(img, "img", torch.uint8)
    require_cuda_tensor(tables, "tables", torch.float32)
    if tables.device != img.device or tables.shape != (ytiles * xtiles, 256):
        raise ValueError(
            f"tables must be ({ytiles * xtiles}, 256) on {img.device}, got "
            f"{tuple(tables.shape)} on {tables.device}")
    h, w = img.shape
    if (y0 < 0 or pad_top < 0 or pad_left < 0
            or ytiles * th - pad_top < y0 + h or xtiles * tw - pad_left < w):
        raise ValueError(
            f"tile grid {ytiles}x{xtiles} of {th}x{tw} does not cover rows "
            f"[{y0}, {y0 + h}) of width {w}")


def inv_tile_width(tw: int) -> float:
    """The host's f32 1/tw, by which the blend kernels multiply a column
    (clahe_map.cu, enhance_tail_clahe.cu)."""
    return float(np.float32(1.0) / np.float32(tw))


def _map(img, tables, ytiles: int, xtiles: int, th: int, tw: int,
         pad_top: int, pad_left: int, y0: int, out_f32: bool,
         scale: float = 1.0):
    """The checks and one launch of the mapping kernel over the rows
    [y0, y0 + h) of a frame."""
    check_clahe_args(img, tables, ytiles, xtiles, th, tw, pad_top, pad_left,
                     y0)
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.float32 if out_f32 else torch.uint8,
                      device=img.device)
    launch("tpuimg_clahe_map", img.device, img.data_ptr(), h, w, y0,
           tables.data_ptr(), ytiles, xtiles, th, pad_top, pad_left,
           inv_tile_width(tw), int(out_f32), scale, out.data_ptr())
    return out


def clahe_map(img, tables, ytiles: int, xtiles: int, th: int, tw: int,
              pad_top: int, pad_left: int, out_f32: bool = False,
              scale: float = 1.0):
    """``clahe_map_plain`` on a CPU tensor; the CUDA kernel otherwise.
    ``scale`` multiplies the float32 blend in the kernel's store (1.0, the
    raw blend, or the f32 value of 1/255 for the enhance pipeline); the u8
    output takes none."""
    if not out_f32 and scale != 1.0:
        raise ValueError(f"scale applies to the float32 blend (out_f32=True), "
                         f"got {scale} with a u8 output")
    if img.device.type == "cpu":
        return clahe_map_plain(img, tables, ytiles, xtiles, th, tw, pad_top,
                               pad_left, out_f32, scale)
    return _map(img, tables, ytiles, xtiles, th, tw, pad_top, pad_left, 0,
                out_f32, scale)


def clahe_band_map(img, tables, ytiles: int, xtiles: int, th: int, tw: int,
                   pad_top: int, pad_left: int, y0: int,
                   out_f32: bool = False):
    """``clahe_band_map_plain`` on a CPU tensor; on a CUDA tensor one launch
    of the mapping kernel with the band's first global row y0. The frame's
    tile grid must cover rows [y0, y0 + h)."""
    if img.device.type == "cpu":
        return clahe_band_map_plain(img, tables, ytiles, xtiles, th, tw,
                                    pad_top, pad_left, y0, out_f32)
    return _map(img, tables, ytiles, xtiles, th, tw, pad_top, pad_left, y0,
                out_f32)


def _word_table(table):
    """The table as the gather kernel takes it: 1-byte and 4-byte entries as
    they are; other floats through float32 and other ints through int32, as
    tpuimg's ``astype`` round trip takes them."""
    if table.element_size() in (1, 4):
        return table
    return table.to(torch.float32 if table.is_floating_point()
                    else torch.int32)


def lut_gather_plain(table, img):
    """dst = table[img] for a (256,) table and a u8 array of any shape, in
    the table's dtype, every bit of the selected entry kept."""
    return _word_table(table)[img.to(torch.int64)].to(table.dtype)


def lut_gather_frames_plain(tables, imgs):
    """dst[b] = tables[b][imgs[b]] for u8 (B, 256) tables and u8 (B, H, W)
    frames."""
    b = imgs.shape[0]
    idx = imgs.reshape(b, -1).to(torch.int64)
    return torch.gather(tables, 1, idx).reshape(imgs.shape)


# csrc/lut_gather.cu's u8 kernel: pixels a chunk (a lane's 16-byte load),
# chunks a block takes at a time, blocks an SM (all resident: one wave, so
# that a block stages its table once a frame)
LUT_CHUNK = 16
LUT_ITER_CHUNKS = 512
LUT_BLOCKS_PER_SM = 4


def lut_gather_plan(total: int, sms: int) -> tuple[int, int]:
    """(blocks, per_block) of csrc/lut_gather.cu's u8 kernel over ``total``
    pixels on a card of ``sms`` SMs: block b takes chunks [b * per_block,
    min(chunks, (b + 1) * per_block)) of the cdiv(total, LUT_CHUNK) chunks,
    per_block a multiple of LUT_ITER_CHUNKS, in at most LUT_BLOCKS_PER_SM
    blocks an SM. (The kernel for 4-byte entries sizes its own grid.)"""
    chunks = cdiv(total, LUT_CHUNK)
    blocks = min(cdiv(chunks, LUT_ITER_CHUNKS), sms * LUT_BLOCKS_PER_SM)
    per_block = round_up(cdiv(chunks, blocks), LUT_ITER_CHUNKS)
    return cdiv(chunks, per_block), per_block


def _gather(img, tables, tstride: int):
    """One launch of the gather kernel over the (frames, n) u8 pixels of
    ``img``: frame f looks up ``tables`` from entry f * tstride on. Tables
    are 1-byte or 4-byte entries; the result has their dtype."""
    words = tables.view(torch.uint8 if tables.element_size() == 1
                        else torch.int32)
    out = torch.empty(img.shape, dtype=words.dtype, device=img.device)
    if img.numel() == 0:
        return out.view(tables.dtype)
    frames = img.shape[0] if tstride else 1
    blocks, per_block = lut_gather_plan(img.numel(), sm_count(img.device))
    launch("tpuimg_lut_gather", img.device, img.data_ptr(),
           img.numel() // frames, frames, words.data_ptr(), tstride,
           words.element_size(), blocks, per_block, out.data_ptr())
    return out.view(tables.dtype)


def lut_gather(table, img):
    """``lut_gather_plain`` on a CPU tensor; the gather kernel otherwise,
    for a contiguous u8 (..., H, W) image."""
    if img.device.type == "cpu":
        return lut_gather_plain(table, img)
    require_cuda_tensor(img, "img", torch.uint8, batched=True)
    if table.shape != (256,) or table.device != img.device:
        raise ValueError(
            f"table must be (256,) on {img.device}, got {tuple(table.shape)} "
            f"on {table.device}")
    words = _word_table(table).contiguous()
    return _gather(img, words, 0).to(table.dtype)


def lut_gather_frames(tables, imgs):
    """``lut_gather_frames_plain`` on a CPU tensor; the gather kernel
    otherwise, one launch for every frame."""
    if imgs.device.type == "cpu":
        return lut_gather_frames_plain(tables, imgs)
    require_cuda_tensor(imgs, "imgs", torch.uint8, batched=True)
    require_cuda_tensor(tables, "tables", torch.uint8)
    if imgs.ndim != 3 or tables.shape != (imgs.shape[0], 256) or (
            tables.device != imgs.device):
        raise ValueError(
            f"imgs must be (B, H, W) with tables (B, 256) on one card, got "
            f"{tuple(imgs.shape)} on {imgs.device} and "
            f"{tuple(tables.shape)} on {tables.device}")
    return _gather(imgs, tables, 256)
