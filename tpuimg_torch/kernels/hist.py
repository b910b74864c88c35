"""256-bin histograms: the tile-histogram kernel (csrc/tile_hist.cu), the
group-histogram kernel (csrc/hist256.cu) and their plain PyTorch versions.

``tile_hist`` replaces ``tpuimg/kernels/hist.py::hist_tiles_fused`` (CLAHE's
per-tile histograms), one launch a call: ``tile_hist_plan`` sizes its grid
and ``tile_row``/``tile_runs`` mirror the frame rows and column runs it
counts. ``tile_tables`` is the same launch ending in CLAHE's clipped f32
tables instead of the histograms. ``hist256_groups`` replaces
``hist256_groups_pallas``, and its thin forms ``hist256`` (one frame) and
``hist256_frames`` (a stack) replace ``hist256_pallas`` and
``hist256_frames_pallas``: the three share one kernel, as they share one
``pallas_call`` in tpuimg. ``hist256_groups_plain`` is the plain form of
``tpuimg/kernels/onehot.py::hist256_tiled`` (a bincount per group instead
of a one-hot contraction). ``hist256_groups_packed``, the
same kernel body reading int32 words of four packed pixels, replaces
``hist256_groups_pallas_packed``. Each call of the group kernel is one
launch: no memset, its output written whole, its cross-block sums through a
workspace of this (device, stream) that every call leaves zeroed
(``_hist_workspace``). ``he_tables`` (and ``he_tables_frames``, a stack) is
the same launch ending in HE's u8 tables instead of the histograms: the
block that holds a group's final counts scans them and writes
rint(min(255, cdf * he_factor(P))), bit for bit
``ops/histogram.py::_he_tables`` of the histograms, which is its plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuimg_torch.core.borders import reflect101_index
from tpuimg_torch.core.layout import cdiv
from tpuimg_torch.kernels import (
    HIST_SPLIT_MAX_GROUPS, launch, require_cuda_tensor, sm_count)

# csrc/tile_hist.cu kMaxCluster: the portable thread-block cluster size
TILE_HIST_MAX_CLUSTER = 8
# the tile kernel's grid: blocks an SM it aims at, and the fewest pixels a
# block counts, so that a block's zeroing and sums stay small beside them
TILE_HIST_BLOCKS_PER_SM = 4
TILE_HIST_MIN_BLOCK_PIXELS = 4096

# (device index, stream) -> the group kernel's zeroed int32 workspace
_WORKSPACES: dict = {}


def _hist_workspace(device: torch.device, groups: int) -> tuple[int, int]:
    """(pointer, ints) of the zeroed workspace csrc/hist256.cu takes for a
    call on ``groups`` groups on ``device``'s current stream: the
    accumulators and tickets of groups that several blocks count, 257 int32
    a group, for HIST_SPLIT_MAX_GROUPS groups or fewer (more groups are a
    block each). It is made, zeroed, the first time a stream needs one at
    least this large; calls on one stream run in turn and leave it zeroed,
    and a stream never shares one with another."""
    if groups > HIST_SPLIT_MAX_GROUPS:
        return 0, 0
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < 257 * groups:
        ws = torch.zeros(257 * groups, dtype=torch.int32, device=device)
        _WORKSPACES[key] = ws
    return ws.data_ptr(), ws.numel()


def hist256_groups_plain(groups: torch.Tensor) -> torch.Tensor:
    """Per-group 256-bin histograms: (G, ...) u8 -> (G, 256) int32."""
    g = groups.shape[0]
    flat = groups.reshape(g, -1).to(torch.int64)
    flat = flat + 256 * torch.arange(g, device=groups.device)[:, None]
    counts = torch.bincount(flat.reshape(-1), minlength=g * 256)
    return counts.reshape(g, 256).to(torch.int32)


def hist256_groups(groups: torch.Tensor) -> torch.Tensor:
    """``hist256_groups_plain`` of a u8 (G, P) tensor on the CPU; the CUDA
    kernel otherwise, one launch for every group."""
    if groups.device.type == "cpu":
        return hist256_groups_plain(groups)
    require_cuda_tensor(groups, "groups", torch.uint8)
    g, p = groups.shape
    if groups.numel() == 0:
        return torch.zeros((g, 256), dtype=torch.int32, device=groups.device)
    out = torch.empty((g, 256), dtype=torch.int32, device=groups.device)
    ws, ints = _hist_workspace(groups.device, g)
    launch("tpuimg_hist256", groups.device, groups.data_ptr(), g, p, ws,
           ints, out.data_ptr())
    return out


def hist256_groups_packed_plain(words: torch.Tensor) -> torch.Tensor:
    """Per-group histograms of packed pixels: int32 (G, P4) words, each four
    u8 pixels little-endian -> (G, 256) int32. The bytes are (word >> 8k) &
    255: the shift is arithmetic, so the mask keeps a word with its top bit
    set right."""
    g = words.shape[0]
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32,
                          device=words.device)
    pixels = (words.reshape(g, -1, 1) >> shifts) & 255
    return hist256_groups_plain(pixels.to(torch.uint8).reshape(g, -1))


def hist256_groups_packed(words: torch.Tensor) -> torch.Tensor:
    """``hist256_groups_packed_plain`` of an int32 (G, P4) tensor on the
    CPU; the CUDA kernel otherwise, one launch for every group. Counts are
    exact, with no bin-0 correction."""
    if words.device.type == "cpu":
        return hist256_groups_packed_plain(words)
    require_cuda_tensor(words, "words", torch.int32)
    g, p4 = words.shape
    if words.numel() == 0:
        return torch.zeros((g, 256), dtype=torch.int32, device=words.device)
    out = torch.empty((g, 256), dtype=torch.int32, device=words.device)
    ws, ints = _hist_workspace(words.device, g)
    launch("tpuimg_hist256_packed", words.device, words.data_ptr(), g, p4, ws,
           ints, out.data_ptr())
    return out


def hist256(img: torch.Tensor) -> torch.Tensor:
    """Global histogram of a contiguous u8 array of any shape: (256,)
    int32."""
    return hist256_groups(img.reshape(1, -1))[0]


def hist256_frames(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame histograms of a contiguous u8 (B, H, W) stack: (B, 256)
    int32. The stack is already B groups of H*W bytes."""
    return hist256_groups(frames.reshape(frames.shape[0], -1))


def he_factor(pixels: int) -> float:
    """HE's table scale: the host's float32 of the float64 quotient 256 /
    N (hist_equalization.cpp:58), which the cdf is multiplied by."""
    return float(np.float32(256.0 / pixels))


def he_tables_plain(groups: torch.Tensor) -> torch.Tensor:
    """HE's tables of u8 (G, P) groups: ``_he_tables`` of their plain
    histograms, (G, 256) u8."""
    # ops/histogram.py imports this module
    from tpuimg_torch.ops.histogram import _he_tables

    return _he_tables(hist256_groups_plain(groups), groups.shape[1])


def he_tables(groups: torch.Tensor) -> torch.Tensor:
    """``he_tables_plain`` of a u8 (G, P) tensor on the CPU; on the card
    one launch of the group kernel that ends in the tables, with no
    histogram left in device memory."""
    if groups.device.type == "cpu":
        return he_tables_plain(groups)
    require_cuda_tensor(groups, "groups", torch.uint8)
    g, p = groups.shape
    factor = he_factor(p)  # p = 0 raises, as the plain version does
    out = torch.empty((g, 256), dtype=torch.uint8, device=groups.device)
    if g == 0:
        return out
    ws, ints = _hist_workspace(groups.device, g)
    launch("tpuimg_he_tables", groups.device, groups.data_ptr(), g, p, ws,
           ints, factor, out.data_ptr())
    return out


def he_tables_frames(frames: torch.Tensor) -> torch.Tensor:
    """HE's table of each frame of a contiguous u8 (B, H, W) stack:
    (B, 256) u8."""
    return he_tables(frames.reshape(frames.shape[0], -1))


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
    return hist256_groups_plain(tiles.reshape(ytiles * xtiles, th * tw))


def tile_hist_plan(ytiles: int, xtiles: int, th: int, tw: int,
                   sms: int) -> tuple[int, int]:
    """(cluster, rows) of csrc/tile_hist.cu's grid on a card of ``sms``
    SMs: the blocks that count one tile, a power of two from 1 to 8 (so
    that the tiles' clusters fill about TILE_HIST_BLOCKS_PER_SM blocks an
    SM, each over at least TILE_HIST_MIN_BLOCK_PIXELS pixels), and the tile
    rows a block counts: block k of a tile takes rows [k * rows,
    min(th, (k + 1) * rows))."""
    want = min(TILE_HIST_MAX_CLUSTER, th,
               cdiv(sms * TILE_HIST_BLOCKS_PER_SM, ytiles * xtiles),
               th * tw // TILE_HIST_MIN_BLOCK_PIXELS)
    cluster = 1 << (max(want, 1).bit_length() - 1)
    return cluster, cdiv(th, cluster)


def _reflect101(x: int, n: int) -> int:
    """csrc/common.cuh reflect101: one mirror, for -n < x < 2n - 1."""
    x = abs(x)
    return x - 2 * max(x - (n - 1), 0)


def tile_row(h: int, th: int, pad_top: int, ty: int, r: int) -> int:
    """The frame row that row r of tile row ty counts (csrc/tile_hist.cu:
    reflect101 once a row)."""
    return _reflect101(ty * th + r - pad_top, h)


def tile_runs(w: int, tw: int, pad_left: int,
              tx: int) -> list[tuple[int, int]]:
    """The frame columns that tile column tx counts, as csrc/tile_hist.cu's
    three (start, length) runs of a frame row: the mirror of the
    extension's columns before 0, those inside the frame, the mirror of
    those past w - 1 (length 0 where absent). A mirrored run is counted
    forwards."""
    a = tx * tw - pad_left
    b = a + tw
    e = min(b, 0)
    i0, i1 = max(a, 0), min(b, w)
    s = max(a, w)
    return [(1 - e, max(e - a, 0)), (i0, max(i1 - i0, 0)),
            (2 * w - 1 - b, max(b - s, 0))]


def _tile_launch_args(img, ytiles: int, xtiles: int, th: int, tw: int,
                      pad_top: int, pad_left: int) -> tuple:
    """The checks csrc/tile_hist.cu's entries need, then their arguments up
    to ``rows``: img, h, w, the grid and its pads, and tile_hist_plan's
    (cluster, rows)."""
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
    cluster, rows = tile_hist_plan(ytiles, xtiles, th, tw,
                                   sm_count(img.device))
    return (img.data_ptr(), h, w, ytiles, xtiles, th, tw, pad_top, pad_left,
            cluster, rows)


def tile_hist(img, ytiles: int, xtiles: int, th: int, tw: int, pad_top: int,
              pad_left: int) -> torch.Tensor:
    """``tile_hist_plain`` on a CPU tensor; the CUDA kernel otherwise, one
    launch a call."""
    if img.device.type == "cpu":
        return tile_hist_plain(img, ytiles, xtiles, th, tw, pad_top, pad_left)
    args = _tile_launch_args(img, ytiles, xtiles, th, tw, pad_top, pad_left)
    out = torch.empty((ytiles * xtiles, 256), dtype=torch.int32,
                      device=img.device)
    launch("tpuimg_tile_hist", img.device, *args, out.data_ptr())
    return out


def tile_tables(img, ytiles: int, xtiles: int, th: int, tw: int,
                pad_top: int, pad_left: int, limit: int,
                fr: float) -> torch.Tensor:
    """CLAHE's f32 tables of a u8 CUDA frame in one launch of the tile
    kernel: each tile's histogram clipped at ``limit`` counts, the excess
    redistributed, its cdf times ``fr`` (ytiles*xtiles, 256), bit for bit
    ``ops/histogram.py::_clahe_tables`` of ``tile_hist``, which is the
    plain version (this wrapper takes no CPU tensor). A limit at or above
    a tile's th*tw pixels clips nothing, so the kernel gets at most th*tw."""
    args = _tile_launch_args(img, ytiles, xtiles, th, tw, pad_top, pad_left)
    out = torch.empty((ytiles * xtiles, 256), dtype=torch.float32,
                      device=img.device)
    launch("tpuimg_tile_tables", img.device, *args, min(limit, th * tw), fr,
           out.data_ptr())
    return out
