"""``enhance``'s fused chain on a card as one C call a frame
(csrc/enhance_plan.cu).

The wrappers that ``enhance``'s fused paths compose (hist.py::tile_tables,
lut.py::clahe_map, boxsum.py::enhance_tail and enhance_tail_clahe) work out
on every call what no frame of one shape and parameter set changes, and
their C entries make CUDA queries on every call. An ``EnhancePlan`` does
that work once: CLAHE's tile geometry, clip limit and table scale, the tile
kernel's clusters, the tail's taps and scratch, the byte layout of the one
device workspace the chain uses, and, through ``tpuimg_enhance_plan``, each
kernel's instance, grid and shared memory. ``run`` then allocates the
workspace and the output and makes one launch of ``tpuimg_enhance_run``:
the tile kernel's tables, then the mapping and the tail's two walks
(``fused``, 4 kernels) or the CLAHE-fused tail's two walks (``fused1``, 3
kernels). The kernels, their grids and their outputs are the wrappers'.

A plan holds no device memory: each call allocates its workspace on its
stream from PyTorch's caching allocator, so calls on several streams
(``host.py``'s pool) share no buffer.
"""

from __future__ import annotations

import ctypes

import torch

from tpuimg_torch.core.layout import cdiv, round_up
from tpuimg_torch.kernels import KernelLaunchError, launch, load, sm_count
from tpuimg_torch.kernels.boxsum import (
    INV_255, _tail_scratch_floats, _tail_taps)
from tpuimg_torch.kernels.hist import tile_hist_plan
from tpuimg_torch.kernels.lut import inv_tile_width
from tpuimg_torch.ops.histogram import _clahe_scale

# each region of the workspace starts where PyTorch's caching allocator
# starts a block
WORKSPACE_ALIGN = 512


class EnhancePlan:
    """The fused chain of ``enhance`` on (h, w) u8 frames of ``device`` at
    these parameters; ``geometry`` is CLAHE's (th, tw, pad_top, pad_left)
    for a ``tiles`` x ``tiles`` grid, the parameters already checked as the
    composed path checks them. The tail's own limits raise ``ParamError``
    here, as its wrappers raise them."""

    def __init__(self, device: torch.device, h: int, w: int, geometry,
                 clip_limit: float, tiles: int, radius: int, sigma: float,
                 gf_radius: int, gf_eps: float, fused1: bool):
        th, tw, pad_top, pad_left = geometry
        self.device, self.h, self.w = device, h, w
        limit, fr = _clahe_scale(clip_limit, th, tw)
        cluster, rows = tile_hist_plan(tiles, tiles, th, tw,
                                       sm_count(device))
        taps = _tail_taps(h, w, radius, sigma, gf_radius)
        floats = _tail_scratch_floats(h, w, radius, gf_radius)
        # the workspace: tables, the blend (fused only), the tail's scratch
        blend_at = round_up(tiles * tiles * 256 * 4, WORKSPACE_ALIGN)
        scratch_at = round_up(blend_at + (0 if fused1 else h * w * 4),
                              WORKSPACE_ALIGN)
        self.workspace_bytes = scratch_at + 4 * floats
        lib = load()
        # the C plan, which tpuimg_enhance_run reads on every call
        self._c = (ctypes.c_longlong
                   * cdiv(lib.tpuimg_enhance_plan_bytes(), 8))()
        self.ptr = ctypes.addressof(self._c)
        with torch.cuda.device(device):  # the card the queries are about
            err = lib.tpuimg_enhance_plan(
                int(fused1), h, w, tiles, tiles, th, tw, pad_top, pad_left,
                cluster, rows, limit, fr, inv_tile_width(tw), INV_255, taps,
                radius, gf_radius, gf_eps, 0, blend_at, scratch_at,
                self.ptr)
        if err != 0:
            msg = lib.tpuimg_cuda_error_string(err).decode()
            raise KernelLaunchError(
                f"tpuimg_enhance_plan: CUDA error {err} ({msg})")

    def run(self, img: torch.Tensor) -> torch.Tensor:
        """The u8 output of a contiguous u8 (h, w) frame on the plan's
        card, queued on the current stream."""
        ws = torch.empty(self.workspace_bytes, dtype=torch.uint8,
                         device=self.device)
        out = torch.empty((self.h, self.w), dtype=torch.uint8,
                          device=self.device)
        launch("tpuimg_enhance_run", self.device, self.ptr, img.data_ptr(),
               ws.data_ptr(), out.data_ptr())
        return out
