#!/usr/bin/env python3
"""Drive tpuimg_torch's enhance pipeline, filters, histogram equalization,
integral image, morphology, row-sharded path, CLI, colour, metrics,
profiling and frame stream once on one CUDA card and check them.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (nvidia-smi name and power limit); no card -> exit 1;
2. build the CUDA kernels from tpuimg_torch/csrc (one nvcc per source, all
   at once, sm_90a);
3. each kernel against its plain PyTorch version on the same card tensors,
   at 2160x3840, 2161x3839 (unaligned tiles and padding) and 1080x1920:
   tile histograms bit-exact, CLAHE f32 blend <= 1e-3 and u8 <= 1 step,
   enhance tail <= 1e-4 (the fused guided-filter contract); gaussian
   (r 1, 2, 7, plus a batch of three 1080p frames and a 3x9 frame at r 4)
   equal to its plain version bit for bit; guided filter onepass (self-guided and general) and twopass
   (r 1, 8, 16, plus a 6x40 frame at r 8; twopass also at r 17 and 32 on
   1080p and r 64 on 2161x3839 and 6x40) <= 1e-4 and finite; guided_filter
   at its default (shrink) border, one launch of the twopass kernel's shrink
   entry a call and no other guided entry, <= 1e-4 of the plain shrink
   chain: a 3-channel source by a 4K guide at r 15 (the guided-rgb-shrink-4k
   cell), 2161x3839 r 16, self-guided 1080p r 1, a batch of two 540x1917
   guides by 3 channels at r 8, and 20x24 r 15 and 5x7 r 16; bit-exact:
   hist256 at those sizes, at 4320x7680 and on a flat 4K frame,
   hist256_frames on 16 frames of 1080p and on 3 odd-sized frames,
   he_tables (hist256's launch ending in HE's tables) on those stacks and
   a flat 4K frame, hist256_groups on (64, 8161) groups,
   hist256_groups_packed on a 4K frame seen as (2160, 960) int32 words and
   on (64, 2041) random words with top bits set, lut_gather with u8, int32
   and float32 tables (compared as int32 bits), lut_gather_frames on 16 frames
   of 1080p, integral at 4K, 2161x3839, on three and on 16 1080p frames
   and on an all-255 4320x7680 frame whose sums wrap, each also on its
   mirror image in the next call and at a storage offset of 3 bytes;
   hist_equalize at 8K and on a
   flat frame, and every integral, also against NumPy formulas; erode and
   dilate (morphology) at those three sizes for r 1, 2, 7, 15, 31 in u8,
   int32 (INT_MIN and INT_MAX planted) and float32 (NaNs, infinities and
   -0.0 planted), on 10x200 at r15, 5x6 at r40 and 1x1 at r3, on a batch of
   two 4K frames and at r200 at 4K, at each dtype's tile ceiling (226 u8,
   108 int32 and float32: one launch) and one past it (the two-pass route),
   and open and close (open_close) at the same sizes for
   r 1, 15, 31, 39, at each dtype's ceiling (93 u8, 44 int32 and float32:
   one fused launch) and one past it (two morphology launches), and on
   frames narrower than a tile or of one row or column at r15 and r16: all
   equal to the plain versions, NaNs in the same places;
   the fused1 tail (enhance_tail_clahe) at the three sizes for tiles 4, 8,
   16 and a 3x5 grid within 5e-6 of enhance_tail on the card's own CLAHE
   blend times 1/255 (the count of differing pixels printed), and within
   1e-4 of its plain version; both tails at gf r 1, 8, 16, 64 by gaussian
   r 0, 2, 16 at the three sizes and on frames just above enhance's gate
   (walk 1's scratch route where its rings pass shared memory), the same
   contracts; the row-padded kernels at the blocks of a 4K
   shard over sp = 4 (540, 541 of 3839 columns, and 1 output rows, with the
   enhance tail's 2*18 halo rows): gaussian_ypadded r2 bit for bit,
   guided_ypadded r8 general and self <= 1e-4 (and r 20, 32, 64 and 80,
   the last on its scratch route, on 540-row and one-row 4K blocks),
   morph_ypadded r1 and r15 on
   2x4K-shard, unaligned and one-row blocks, r120 and at each dtype's tile
   ceiling and one past it (the two-pass route) in u8, int32 and float32
   with NaNs, equal; clahe_band_map on 540-row
   4K bands at y0 0, 537 and 1620, tiles 8 and 16: f32 <= 1e-3, u8 <= 1
   step, and equal to clahe_map's rows; the guided walkers with a NaN,
   +-inf, 1e3, 1e8 or 1e20 planted at one pixel of I, then of p, of a
   70x150 frame (an inner pixel, a segment boundary and strip edge, a
   128-column strip edge): onepass self-guided and general and twopass at
   r 2 and 8, the row-padded entry at r 8 and 80 (scratch route), each
   with the plain version's non-finite outputs and within 1e-4 of it
   outside the pixel's windows; clahe_map and clahe_band_map at tile grids
   2-64 on 300-row frames 3840, 1917, 1000 (the unstaged tables) and 7
   columns wide, bands either side of a tile-row centre equal to the
   frame's rows; hist256 of one-value frames over many blocks and one,
   64x8161 groups at unaligned offsets, 70000 groups, calls interleaved on
   two streams, each call one kernel by the profiler, every workspace left
   zeroed; tile_hist on flat 4K frames (8 and 64 tiles), frames of one
   value a tile, the 300-row frames of the mapping's grids, 64x64 tiles at
   4K and grids whose pads reach past a tile, and lut_gather at input
   offsets 0-15 and lengths 1, 15, 16, 17 and 4K + 1 with six table kinds
   and on (70000, 1, 3) and (3, 1081, 1917) frames, all exact, calls of
   both on two streams, each call one kernel (no memset) by the profiler;
4. the main paths, each run once with the launches of each kernel's C entry
   (``kernels.launches``) counted across it, and each of its kernels
   launched:
   enhance at 4K (impl="fused": tile_tables, clahe_map, enhance_tail;
   impl="fused1": tile_tables, enhance_tail_clahe and no clahe_map; never
   tile_hist: the tables leave the tile kernel's one launch), enhance at 4K
   with impl="staged" and enhance on a 32x48 frame (under the tail kernel's
   gate; both: tile_tables, clahe_map, gaussian, guided), and
   the stand-alone filters (gaussian r2 at 1080p, guided r8 at 4K
   self-guided, general, and twopass, and guided_filter at its default
   border on a 3-channel source at 4K r 15; that call also timed as one
   call and as three calls of one channel, the call by event pairs and
   each of its two launches by the profiler, the two within 1e-5),
   hist_equalize at 4K
   (he_tables, lut_gather) and on 16 frames of 1080p (the same two
   kernels, frames form, one launch each), hist256_groups_packed on a 4K
   frame's words (equal to hist256 and NumPy's bincount), integral at 4K
   (integral), and
   erode, dilate
   (one morphology launch each), morph_open and morph_close (one
   open_close launch each) at r15 on two 4K u8 frames (the JAX package's
   morph_31x31_4k_batch2 bench row). Each enhance output is u8 of the
   frame's shape, within 1 step of the plain composition on the card and
   within 1 step of the CPU run on a crop, and fused1's within 1 step of
   fused's (differing pixels counted); each filter output is within its
   contract of the plain version; hist_equalize, integral and the
   morphology ops equal the plain composition and the CPU run on a crop
   bit for bit, and hist_equalize and integral the NumPy formula. Then the
   sharded path (tpuimg_torch/parallel, meshes of the one card repeated)
   against the unsharded ops: enhance_sharded at 4K, 8K and 2161x3840 over
   (1, 4) within 1 step of enhance(impl="staged") (clahe_band_map,
   gaussian_ypadded, guided_ypadded); stencil_sharded gaussian r2 (1e-6)
   and erode r15 (equal) on 2x4K over (2, 4); guided_filter_sharded r8 at
   4K, general and self (1e-5); at gf_radius 20, guided_filter_sharded
   (1e-5 of the unsharded kernel, 1e-3 of guided_filter's plain chain) and
   enhance_sharded (1 step of staged); integral_sharded, hist_equalize_sharded
   at 4K and on 16x1080p over (4, 2) (equal), clahe_sharded at 4K and
   2161x3840 (1 step);
5. none: the benchmark (bench_torch/) times the port, a change beside its
   parent; the other phases keep their numbers;
6. the modules around the ops, in a temporary working directory, each CLI
   call with its launches counted as in phase 4, every kernel it reaches
   launched: first a probe of what the
   IO-dependent commands need (cv2, PIL, g++ and the native loader, whose
   build failure is named); the CLI in-process
   (``tpuimg_torch.cli.main``) at 4K, its defaults, --nreps 5: enhance
   (its three rows beside events on the same frame), gaussian r1, integral,
   guided (twopass and onepass), morphology erode r5 and open r15, sweep
   morphology at r 1 and 15, every row [OK]; the seven autotest families at
   their default --max-size, two runs of seed 0, each res.log line within
   its family's tolerance; rgb_to_lab, lab_to_rgb and rgb_to_gray on a 4K
   RGB frame on the card within 1 step of the CPU (differing values
   counted); max_abs_diff and max_abs_diff_loc on the card equal to NumPy
   (int32 above 2^24 with a tie, uint8 0 against 255); profiling.trace
   around one 4K enhance call in a fresh process (python3 chip_smoke.py
   --profiling DIR runs it alone), its Chrome trace naming the enhance
   tail's two walk kernels and holding the call's spans, its three C calls
   among them; then, where cv2 or PIL can write PNGs, he and
   clahe on a 4K gray PNG, clahe on a 1080p colour PNG and morphology
   --color rgb|lab (rgb equal to erode of its channels), and, where the
   native loader builds, stream --op enhance over 16 1080p PNGs (its first
   frame equal to enhance on the card), frames/s printed; what the machine
   lacks is named on one line.

Then one JSON line with the kernels (launches of each one's C entry summed
over phase 4's runs, and the largest error against its plain version), and
last the device line. Any failed check raises, so the script exits
non-zero without printing the device line.
"""

from __future__ import annotations

import contextlib
import glob
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpuimg_torch import (
    clahe, dilate, erode, gaussian, guided_filter, hist_equalize, integral,
    kernels, morph_close, morph_open)
from tpuimg_torch.core.timing import card_label, time_cuda
from tpuimg_torch.kernels.boxsum import (
    INV_255, enhance_tail, enhance_tail_clahe, enhance_tail_clahe_plain,
    enhance_tail_plain, guided_filter_kernel, guided_filter_plain,
    guided_ypadded_kernel, guided_ypadded_plain)
from tpuimg_torch.kernels.hist import (
    he_tables_frames, hist256, hist256_frames, hist256_groups,
    hist256_groups_packed, hist256_groups_packed_plain, hist256_groups_plain,
    tile_hist, tile_hist_plain, tile_tables)
from tpuimg_torch.kernels.lut import (
    clahe_band_map, clahe_band_map_plain, clahe_map, clahe_map_plain,
    lut_gather, lut_gather_frames, lut_gather_frames_plain, lut_gather_plain)
from tpuimg_torch.kernels.scan2d import integral_kernel, integral_plain
from tpuimg_torch.kernels.sep_stencil import (
    gaussian_kernel, gaussian_plain, gaussian_ypadded_kernel,
    gaussian_ypadded_plain, morph_max_radius, morph_tile,
    morph_ypadded_kernel, morph_ypadded_plain, morphology_kernel,
    morphology_plain, open_close_kernel, open_close_max_radius,
    open_close_plain)
from tpuimg_torch.ops.gaussian import gaussian_ypadded
from tpuimg_torch.ops.histogram import (
    _clahe_geometry, _clahe_scale, _clahe_tables, _he_tables)
from tpuimg_torch.ops.color import lab_to_rgb, rgb_to_gray, rgb_to_lab
from tpuimg_torch.ops.metrics import max_abs_diff, max_abs_diff_loc
from tpuimg_torch.ops.morphology import morph_ypadded
from tpuimg_torch.parallel import (
    clahe_sharded, enhance_sharded, guided_filter_sharded,
    hist_equalize_sharded, integral_sharded, make_mesh, shard_batch,
    shard_rows, stencil_sharded)
from tpuimg_torch.pipeline import _to_u8, enhance
from tpuimg_torch.profiling import trace

SEED = 0
SHAPES = [(2160, 3840), (2161, 3839), (1080, 1920)]
# enhance's defaults (tpuimg/pipeline.py, the enhance_pipeline_4k bench row)
CLIP, TILES, RG, SIGMA, GF_R, GF_EPS = 2.0, 8, 2, 1.5, 8, 1e-3
GAUSS = [(1, 0.8), (2, 1.5), (7, 3.0)]  # radius, sigma
GUIDED_R = [1, 8, 16]
# twopass past the tile kernel's ceiling of 16, up to its own of 64
TWOPASS_LARGE = [((1080, 1920), 17), ((1080, 1920), 32), ((2161, 3839), 64),
                 ((6, 40), 64)]
SMALL = (32, 48)  # under the tail kernel's gate: 32 <= 2*(2*8 + 2)
UHD8K = (4320, 7680)  # 33 Mpx: more than 2^24 pixels, and all-255 sums wrap
BATCH = (16, 1080, 1920)  # the hist_equalize_1080p_b16 bench row (bench.py:58)
MORPH_R = [1, 2, 7, 15, 31]
OPEN_CLOSE_R = [1, 15, 31, 39]
# frames narrower than a tile or a line shorter than a window
OPEN_CLOSE_NARROW = [(2160, 40), (40, 3840), (2160, 1), (1, 3840)]
# the tails' radius range: gf radius (64 the ceiling, on the scratch route at
# rg 16) by gaussian radius
TAIL_R = [1, 8, 16, 64]
TAIL_RG = [0, 2, 16]
MORPH_TINY = [((10, 200), 15), ((5, 6), 40), ((1, 1), 3)]
# the gaussian kernel's routes: its own register-window instances (r 1-4),
# the 8 and 16 windows (r 5-16), the tile body (r 17-96)
GAUSS_ROUTES_SHAPE = (300, 257)
GAUSS_ROUTES_R = [3, 4, 5, 8, 9, 16, 17, 96]
MORPH_BATCH = (2, 2160, 3840)  # morph_31x31_4k_batch2 (bench.py:84): r15
MORPH_PATH_R = 15
TAIL_GRIDS = [(4, 4), (8, 8), (16, 16), (3, 5)]  # (ytiles, xtiles)
ITERS = 30

KERNELS = [  # name, its C entry, source, TPU kernel replaced
    ("tile_hist", "tpuimg_tile_hist", "tpuimg_torch/csrc/tile_hist.cu",
     "tpuimg/kernels/hist.py:213"),
    ("tile_tables", "tpuimg_tile_tables", "tpuimg_torch/csrc/tile_hist.cu",
     "tpuimg/kernels/hist.py:213 and the table glue after it"),
    ("clahe_map", "tpuimg_clahe_map", "tpuimg_torch/csrc/clahe_map.cu",
     "tpuimg/kernels/lut.py:341"),
    ("enhance_tail", "tpuimg_enhance_tail",
     "tpuimg_torch/csrc/enhance_tail.cu", "tpuimg/kernels/boxsum.py:396"),
    ("gaussian", "tpuimg_gaussian", "tpuimg_torch/csrc/gaussian.cu",
     "tpuimg/kernels/sep_stencil.py:542"),
    ("guided", "tpuimg_guided_onepass", "tpuimg_torch/csrc/guided.cu",
     "tpuimg/kernels/boxsum.py:632"),
    ("guided_twopass", "tpuimg_guided_twopass", "tpuimg_torch/csrc/guided.cu",
     "tpuimg/kernels/boxsum.py:108"),
    ("hist256", "tpuimg_hist256", "tpuimg_torch/csrc/hist256.cu",
     "tpuimg/kernels/hist.py:115 (also :126, :145)"),
    ("lut_gather", "tpuimg_lut_gather", "tpuimg_torch/csrc/lut_gather.cu",
     "tpuimg/kernels/lut.py:77 (also :193)"),
    ("integral", "tpuimg_integral", "tpuimg_torch/csrc/integral.cu",
     "tpuimg/kernels/scan2d.py:216"),
    ("morphology", "tpuimg_morphology", "tpuimg_torch/csrc/morphology.cu",
     "tpuimg/kernels/sep_stencil.py:575"),
    ("open_close", "tpuimg_open_close", "tpuimg_torch/csrc/open_close.cu",
     "tpuimg/kernels/sep_stencil.py:509"),
    ("enhance_tail_clahe", "tpuimg_enhance_tail_clahe",
     "tpuimg_torch/csrc/enhance_tail_clahe.cu",
     "tpuimg/kernels/boxsum.py:495"),
    ("gaussian_ypadded", "tpuimg_gaussian_ypadded",
     "tpuimg_torch/csrc/gaussian.cu", "tpuimg/kernels/sep_stencil.py:551"),
    ("morph_ypadded", "tpuimg_morphology_ypadded",
     "tpuimg_torch/csrc/morphology.cu", "tpuimg/kernels/sep_stencil.py:594"),
    ("guided_ypadded", "tpuimg_guided_onepass_ypadded",
     "tpuimg_torch/csrc/guided.cu", "tpuimg/kernels/boxsum.py:602"),
    # clahe_map's entry: its row counts clahe_map's launches too
    ("clahe_band_map", "tpuimg_clahe_map", "tpuimg_torch/csrc/clahe_map.cu",
     "tpuimg/kernels/lut.py:502"),
    ("hist256_packed", "tpuimg_hist256_packed", "tpuimg_torch/csrc/hist256.cu",
     "tpuimg/kernels/hist.py:167"),
    ("guided_twopass_shrink", "tpuimg_guided_twopass_shrink",
     "tpuimg_torch/csrc/guided.cu", "no TPU kernel: tpuimg's XLA class path"),
    # enhance's fused chain from its plan: the tile, mapping and tail
    # kernels above, queued by one C call
    ("enhance_run", "tpuimg_enhance_run", "tpuimg_torch/csrc/enhance_plan.cu",
     "no TPU kernel: tpuimg/pipeline.py's fused chain in one C call"),
    # hist256's launch ending in HE's tables: hist_equalize on the card
    ("he_tables", "tpuimg_he_tables", "tpuimg_torch/csrc/hist256.cu",
     "tpuimg/kernels/hist.py:145 and the table glue after it "
     "(tpuimg/ops/histogram.py:138)"),
]

# the enhance tail's halo: 2*gf_radius + radius rows (enhance_sharded)
REACH = 2 * GF_R + RG
SHARD_ROWS = [540, 541, 1]  # a 4K shard over sp = 4, unaligned, one row
BAND_Y0 = [0, 537, 1620]
BAND_GRIDS = [8, 16]
YPAD_MORPH_R = [1, 15]
# the row-padded guided entry past tpuimg's dispatch ceiling of 16; 80 takes
# its scratch route (past kernels.GUIDED_SMEM_MAX_RADIUS)
YPAD_GUIDED_R = [20, 32, 64, 80]
GF_R_LARGE = 20  # the sharded paths at a gf_radius past 16
# guided_filter at its default (shrink) border: the guided-rgb-shrink-4k
# cell's call (4K guide, 3-channel source, r 15), an unaligned frame,
# self-guided, a batch, and frames with windows clamped at both ends
# (min(H, W) <= 2r): (shape of I, channels of p or 0 for p of I's shape or
# None for self-guided, radius)
SHRINK_CASES = [((2160, 3840), 3, 15), ((2161, 3839), 0, 16),
                ((1080, 1920), None, 1), ((2, 540, 1917), 3, 8),
                ((20, 24), 3, 15), ((5, 7), 0, 16)]
# values planted at one pixel of I or p of the guided filter's inputs, at an
# inner pixel, on a 32-row segment boundary and 64-column strip edge, and on
# a 128-column strip edge (the walkers' running sums must drop each with
# its windows)
PLANTED = [float("nan"), float("inf"), float("-inf"), 1e3, 1e8, 1e20]
PLANT_AT = [(5, 10), (32, 64), (50, 128)]
PLANT_SHAPE = (70, 150)
# the CLAHE mapping at tile grids from 2 to 64 and widths whose rows start
# unaligned, or narrower than a tile (a 64-tile grid needs more reflect
# padding than 7 columns give)
CLAHE_GRIDS = [(t, w) for t in (2, 8, 16, 64) for w in (3840, 1917, 1000, 7)
               if w > t or t < 64]
def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def make_frame(h: int, w: int, seed: int) -> np.ndarray:
    """A u8 scene with what CLAHE acts on: smooth illumination, a dark
    low-contrast region, edges and sensor noise."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    scene = 70 + 50 * np.sin(7 * x + 3 * y) * np.cos(5 * y) + 60 * x * y
    scene = np.where((x - 0.3) ** 2 + (y - 0.6) ** 2 < 0.04, scene * 0.25,
                     scene)
    scene = scene + 40 * ((np.floor(x * 12) + np.floor(y * 7)) % 2)
    scene = scene + rng.normal(0.0, 6.0, (h, w)).astype(np.float32)
    return np.clip(scene, 0, 255).astype(np.uint8)


def guide_pair(shape, seed: int, dev):
    """A [0, 1] guide I and a noisy source p of it, on the card."""
    rng = np.random.default_rng(seed)
    I = rng.random(shape, dtype=np.float32)
    p = np.clip(I + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return torch.from_numpy(I).to(dev), torch.from_numpy(p).to(dev)


def front(img):
    """CLAHE geometry and tables of a frame (plain versions)."""
    h, w = img.shape
    th, tw, pt, pl = _clahe_geometry(h, w, TILES, TILES)
    hists = tile_hist_plain(img, TILES, TILES, th, tw, pt, pl)
    return (th, tw, pt, pl), _clahe_tables(hists, CLIP, th, tw)


def enhance_plain(img, impl: str = "fused"):
    """enhance(img, impl=impl) composed from the kernels' plain versions."""
    geo, tables = front(img)
    if impl == "staged":
        eq = clahe_map_plain(img, tables, TILES, TILES, *geo)
        f = eq.to(torch.float32) * (1.0 / 255.0)
    else:
        f = clahe_map_plain(img, tables, TILES, TILES, *geo,
                            out_f32=True) * (1.0 / 255.0)
        if min(img.shape) > 2 * (2 * GF_R + RG):
            return _to_u8(enhance_tail_plain(f, RG, SIGMA, GF_R, GF_EPS))
    smooth = gaussian_plain(f, RG, SIGMA)
    return _to_u8(guided_filter_plain(f, smooth, GF_R, GF_EPS))


def kernel_args(img):
    """The arguments each kernel gets on the enhance paths for this frame."""
    geo, tables = front(img)
    blend = clahe_map_plain(img, tables, TILES, TILES, *geo, out_f32=True)
    f = blend * (1.0 / 255.0)
    return {
        "tile_hist": (img, TILES, TILES, *geo),
        "tile_tables": (img, TILES, TILES, *geo,
                        *_clahe_scale(CLIP, *geo[:2])),
        "clahe_map": (img, tables, TILES, TILES, *geo, True),
        "enhance_tail": (f, RG, SIGMA, GF_R, GF_EPS),
        "gaussian": (f, RG, SIGMA),
        "guided": (f, gaussian_plain(f, RG, SIGMA), GF_R, GF_EPS),
        "guided_twopass": (f, gaussian_plain(f, RG, SIGMA), GF_R, GF_EPS,
                           "twopass"),
    }


def check_enhance_kernels(dev, card: str, errs: dict) -> None:
    """Phase 3, the kernels of the fused enhance path."""
    for h, w in SHAPES:
        img = torch.from_numpy(make_frame(h, w, SEED)).to(dev)
        args = kernel_args(img)
        got = tile_hist(*args["tile_hist"])
        ref = tile_hist_plain(*args["tile_hist"])
        check(torch.equal(got, ref), f"tile_hist {h}x{w} bit-exact")
        check(int(got.sum()) == TILES * TILES * args["tile_hist"][3]
              * args["tile_hist"][4], f"tile_hist {h}x{w} counts every pixel")
        hist_err = max_err(got, ref)
        got = tile_tables(*args["tile_tables"])
        check(torch.equal(got, args["clahe_map"][1]),
              f"tile_tables {h}x{w} equal the plain tables bit for bit")
        tables_err = max_err(got, args["clahe_map"][1])
        got = clahe_map(*args["clahe_map"])
        map_err = max_err(got, clahe_map_plain(*args["clahe_map"]))
        check(map_err <= 1e-3, f"clahe_map f32 {h}x{w}: {map_err} <= 1e-3")
        u8_args = args["clahe_map"][:-1] + (False,)
        step = int((clahe_map(*u8_args).int()
                    - clahe_map_plain(*u8_args).int()).abs().max())
        check(step <= 1, f"clahe_map u8 {h}x{w}: {step} <= 1 step")
        got = enhance_tail(*args["enhance_tail"])
        tail_err = max_err(got, enhance_tail_plain(*args["enhance_tail"]))
        check(bool(torch.isfinite(got).all()), f"enhance_tail {h}x{w} finite")
        check(tail_err <= 1e-4, f"enhance_tail {h}x{w}: {tail_err} <= 1e-4")
        # enhance's plan (one C call) against its wrappers' composition
        tables = tile_tables(*args["tile_tables"])
        f = clahe_map(img, tables, TILES, TILES, *args["tile_hist"][3:],
                      out_f32=True, scale=INV_255)
        want = enhance_tail(f, RG, SIGMA, GF_R, GF_EPS, out_u8=True)
        run_err = 0.0
        for impl in ("fused", "fused1"):
            got = enhance(img, CLIP, TILES, RG, SIGMA, GF_R, GF_EPS, impl)
            run_err = max(run_err, max_err(got, want))
            check(torch.equal(got, want), f"enhance {impl} {h}x{w}: the "
                  f"plan's C call equals the wrappers bit for bit")
        torch.cuda.synchronize()
        print(f"phase 3 kernels vs plain {h}x{w}: tile_hist exact, "
              f"tile_tables exact, clahe_map f32 {map_err:.3g} u8 {step} "
              f"step, enhance_tail {tail_err:.3g}; enhance's plan equals "
              f"the wrappers [{card}]")
        for name, err in (("tile_hist", hist_err),
                          ("tile_tables", tables_err), ("clahe_map", map_err),
                          ("enhance_tail", tail_err),
                          ("enhance_run", run_err)):
            errs[name] = max(errs.get(name, 0.0), err)


def check_filter_kernels(dev, card: str, errs: dict) -> None:
    """Phase 3, the gaussian and guided-filter kernels."""
    cases = [(shape, r, s) for shape in SHAPES for r, s in GAUSS]
    cases += [((3, 1080, 1920), 2, 1.5), ((3, 9), 4, 1.5)]
    cases += [(GAUSS_ROUTES_SHAPE, r, 0.3 * r + 0.8) for r in GAUSS_ROUTES_R]
    for shape, r, sigma in cases:
        f, _ = guide_pair(shape, SEED + r, dev)
        got = gaussian_kernel(f, r, sigma)
        ref = gaussian_plain(f, r, sigma)
        err = max_err(got, ref)
        label = "x".join(map(str, shape))
        check(bool(torch.isfinite(got).all()), f"gaussian {label} finite")
        check(torch.equal(got, ref), f"gaussian {label} r{r}: {err} from "
              f"the plain version, not equal")
        errs["gaussian"] = max(errs.get("gaussian", 0.0), err)
        print(f"phase 3 gaussian vs plain {label} r{r}: equal [{card}]")
    cases = [(shape, r) for shape in SHAPES for r in GUIDED_R]
    cases += [((6, 40), 8)]
    for shape, r in cases:
        I, p = guide_pair(shape, SEED + 10 + r, dev)
        general = guided_filter_plain(I, p, r, GF_EPS)
        runs = {
            "guided self": (guided_filter_kernel(I, I, r, GF_EPS,
                                                 self_guided=True),
                            guided_filter_plain(I, I, r, GF_EPS, True)),
            "guided general": (guided_filter_kernel(I, p, r, GF_EPS),
                               general),
            "guided_twopass": (guided_filter_kernel(I, p, r, GF_EPS,
                                                    variant="twopass"),
                               general),
        }
        label = f"{shape[0]}x{shape[1]} r{r}"
        line = []
        for what, (got, ref) in runs.items():
            err = max_err(got, ref)
            check(bool(torch.isfinite(got).all()), f"{what} {label} finite")
            check(err <= 1e-4, f"{what} {label}: {err} <= 1e-4")
            name = what.split()[0]
            errs[name] = max(errs.get(name, 0.0), err)
            line.append(f"{what} {err:.3g}")
        print(f"phase 3 guided vs plain {label}: {', '.join(line)} [{card}]")
    for shape, r in TWOPASS_LARGE:
        I, p = guide_pair(shape, SEED + 10 + r, dev)
        got = guided_filter_kernel(I, p, r, GF_EPS, variant="twopass")
        err = max_err(got, guided_filter_plain(I, p, r, GF_EPS))
        label = f"{shape[0]}x{shape[1]} r{r}"
        check(bool(torch.isfinite(got).all()),
              f"guided_twopass {label} finite")
        check(err <= 1e-4, f"guided_twopass {label}: {err} <= 1e-4")
        errs["guided_twopass"] = max(errs["guided_twopass"], err)
        print(f"phase 3 guided_twopass vs plain {label}: {err:.3g} [{card}]")


def check_guided_shrink(dev, card: str, errs: dict) -> None:
    """Phase 3, guided_filter at its default border (shrink) as a user
    calls it: one launch of the twopass kernel's shrink entry a call and
    no other guided entry, within 1e-4 of the plain shrink chain."""
    guided = ("guided", "guided_twopass", "guided_ypadded",
              "guided_twopass_shrink")
    for shape, channels, r in SHRINK_CASES:
        if channels:
            I3, p = guide_pair((channels,) + shape, SEED + 30 + r, dev)
            I = I3[0].contiguous()
        else:
            I, p = guide_pair(shape, SEED + 30 + r, dev)
        self_g = channels is None
        src = I if self_g else p
        label = (f"guided_filter shrink {'x'.join(map(str, shape))} "
                 f"{'self' if self_g else f'C{channels or 1}'} r{r}")
        got, n = drive(label, ("guided_twopass_shrink",), guided_filter, I,
                       src, r, GF_EPS)
        ref = guided_filter_plain(I, src, r, GF_EPS, self_g, border="shrink")
        err = max_err(got, ref)
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"{label} shape and finite")
        check(pick(n, guided) == {**dict.fromkeys(guided, 0),
                                  "guided_twopass_shrink": 1},
              f"{label}: one launch of the shrink entry ({pick(n, guided)})")
        check(err <= 1e-4, f"{label}: {err} <= 1e-4")
        errs["guided_twopass_shrink"] = max(
            errs.get("guided_twopass_shrink", 0.0), err)
        print(f"phase 3 {label} vs plain: {err:.3g}, launches "
              f"{n['guided_twopass_shrink']} [{card}]")


def twopass_launch_ms(fn, calls: int = 20) -> tuple:
    """Device ms a call of fn() in the twopass kernel's first and second
    launches (template argument kAB true, false), from the profiler's kernel
    records over ``calls`` calls: both launches are one C call, which no
    event pair can split. The profiler loses kernel records now and then
    (PERF.md section 6), so a trace missing either launch is taken again,
    up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = {True: 0.0, False: 0.0}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and "guided_twopass_kernel<" in e.name):
                first = "guided_twopass_kernel<true" in e.name
                us[first] += e.time_range.end - e.time_range.start
        if us[True] and us[False]:
            break
    check(us[True] > 0 and us[False] > 0,
          f"a trace of {calls} twopass calls holds both launches: {us}")
    return us[True] / calls * 1e-3, us[False] / calls * 1e-3


def time_shrink_channels(dev, card: str) -> None:
    """Phase 4, the guided-rgb-shrink-4k cell's call two ways: the 3
    channels in one call and in three calls of one channel, equal within
    1e-5; the call by event pairs (time_cuda), each launch by the
    profiler."""
    _, p3 = guide_pair((3, 2160, 3840), SEED + 4, dev)
    I = (0.299 * p3[0] + 0.587 * p3[1] + 0.114 * p3[2]).contiguous()
    planes = [p3[c].contiguous() for c in range(3)]

    def one_call():
        return guided_filter(I, p3, 15, GF_EPS)

    def a_call_a_channel():
        return [guided_filter(I, pc, 15, GF_EPS) for pc in planes]

    diff = max_err(one_call(), torch.stack(a_call_a_channel()))
    check(diff <= 1e-5, f"guided 4K C3 r15 shrink, one call vs a call a "
          f"channel: {diff} <= 1e-5")
    for label, fn in (("one call", one_call),
                      ("a call a channel x3", a_call_a_channel)):
        ms = time_cuda(fn, card=card).ms
        l1, l2 = twopass_launch_ms(fn)
        print(f"phase 4 guided 4K C3 r15 shrink {label}: {ms:.4f} ms "
              f"(event pairs), launch 1 {l1:.4f} ms, launch 2 {l2:.4f} ms "
              f"(profiler); the two {diff:.3g} apart [{card}]")


def classes(x):
    """0 finite, 1 +inf, 2 -inf, 3 NaN."""
    return torch.where(torch.isnan(x), 3, torch.where(
        torch.isposinf(x), 1, torch.where(torch.isneginf(x), 2, 0)))


def planted_err(got, ref, y: int, x: int, r: int) -> float:
    """got has ref's non-finite outputs (NaN for NaN, the same infinities);
    returns its largest difference from ref outside the (4r + 1)^2 block
    around (y, x)."""
    check(torch.equal(classes(got), classes(ref)),
          "the same non-finite outputs as the plain version")
    far = torch.ones_like(got, dtype=torch.bool)
    far[max(0, y - 2 * r):y + 2 * r + 1, max(0, x - 2 * r):x + 2 * r + 1] = 0
    keep = far & torch.isfinite(ref)
    return max_err(got[keep], ref[keep]) if bool(keep.any()) else 0.0


def check_walker_planted(dev, card: str, errs: dict) -> None:
    """Phase 3, the guided walkers' repaired running sums: a NaN, an
    infinity or a large value planted at one pixel of I, then of p, of a
    70x150 frame reaches only the outputs whose windows hold it, as in the
    plain version's direct sums, and leaves no residue elsewhere (1e-4):
    onepass frame entry (self-guided and general) and twopass at r 2 and 8,
    the row-padded entry at r 8 and at r 80 (its scratch route)."""
    g = np.random.default_rng(SEED)
    I0 = g.random(PLANT_SHAPE, dtype=np.float32)
    p0 = np.clip(I0 + 0.1 * g.standard_normal(PLANT_SHAPE), 0, 1).astype(
        np.float32)

    def frame_entry(what, r):
        def run(I, p):
            if what == "guided self":
                return (guided_filter_kernel(I, I, r, GF_EPS,
                                             self_guided=True),
                        guided_filter_plain(I, I, r, GF_EPS, True))
            variant = "twopass" if what == "guided_twopass" else "onepass"
            return (guided_filter_kernel(I, p, r, GF_EPS, variant=variant),
                    guided_filter_plain(I, p, r, GF_EPS))
        return run

    def ypadded(self_g, r):
        def run(I, p):
            pp = I if self_g else p
            return (guided_ypadded_kernel(I, pp, r, GF_EPS, self_g),
                    guided_ypadded_plain(I, pp, r, GF_EPS, self_g))
        return run

    entries = [(f"{what} r{r}", what.split()[0], frame_entry(what, r), r, 0,
                what != "guided self")
               for what in ("guided self", "guided general", "guided_twopass")
               for r in (2, 8)]
    entries += [(f"guided_ypadded{' self' if sg else ''} r{r}",
                 "guided_ypadded", ypadded(sg, r), r, 2 * r, not sg)
                for r in (8, 80) for sg in (False, True)]
    for label, name, run, r, pad, general in entries:
        Ib = torch.from_numpy(np.pad(I0, ((pad, pad), (0, 0)),
                                     mode="reflect")).to(dev)
        pb = torch.from_numpy(np.pad(p0, ((pad, pad), (0, 0)),
                                     mode="reflect")).to(dev)
        worst = 0.0
        for plane in ("I", "p") if general else ("I",):
            for y, x in PLANT_AT:
                for value in PLANTED:
                    I, p = Ib.clone(), pb.clone()
                    (I if plane == "I" else p)[y + pad, x] = value
                    got, ref = run(I, p)
                    err = planted_err(got, ref, y, x, r)
                    check(err <= 1e-4, f"{label} {plane}[{y}, {x}] = {value}: "
                          f"{err} <= 1e-4 outside its windows")
                    worst = max(worst, err)
        errs[name] = max(errs.get(name, 0.0), worst)
        torch.cuda.synchronize()
        print(f"phase 3 {label} planted NaN, +-inf, 1e3, 1e8, 1e20 at "
              f"{len(PLANT_AT)} pixels of {'I and p' if general else 'I'}: "
              f"the plain version's non-finite outputs, {worst:.3g} outside "
              f"the planted pixel's windows [{card}]")


def check_clahe_grids(dev, card: str, errs: dict) -> None:
    """Phase 3, the CLAHE mapping at tile grids from 2 to 64 (tiles one
    column wide at width 7), on widths whose rows start unaligned, and in
    bands starting on either side of a tile-row centre: f32 within 1e-3 and
    u8 within 1 step of the plain version, each band equal to the whole
    frame's rows."""
    h = 300
    for tiles, w in CLAHE_GRIDS:
        img = torch.from_numpy(make_frame(h, w, SEED + 90)).to(dev)
        geo, tables = front_at(img, tiles)
        th, pad_top = geo[0], geo[2]
        centre = next(c for c in (int((t + 0.5) * th) - pad_top
                                  for t in range(tiles)) if c >= 1)
        for f32 in (True, False):
            full = clahe_map(img, tables, tiles, tiles, *geo, f32)
            ref = clahe_map_plain(img, tables, tiles, tiles, *geo, f32)
            err = max_err(full, ref)
            check(err <= (1e-3 if f32 else 1.0), f"clahe_map tiles {tiles} "
                  f"{h}x{w} {'f32' if f32 else 'u8'}: {err}")
            if f32:
                errs["clahe_map"] = max(errs["clahe_map"], err)
            for y0 in (centre - 1, centre, centre + 1):
                band = clahe_band_map(img[y0:], tables, tiles, tiles, *geo,
                                      y0, out_f32=f32)
                check(torch.equal(band, full[y0:]), f"clahe_band_map tiles "
                      f"{tiles} {h}x{w} y0 {y0} equals clahe_map's rows")
    print(f"phase 3 clahe_map and clahe_band_map, {h} rows, tiles and "
          f"widths {CLAHE_GRIDS}: f32 and u8 within the contract, bands at "
          f"a tile-row centre and either side equal to the frame's rows "
          f"[{card}]")


def kernels_a_call(fn, *args) -> list:
    """The CUDA kernels one call runs, by the profiler (a memset shows as
    one), after a warm-up call. A trace that caught no kernel at all (the
    profiler drops one now and then) is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def check_hist_cases(dev, card: str, errs: dict) -> None:
    """Phase 3, the histogram kernel's grids and workspace: frames of one
    value over many blocks and over one, frames whose groups fall at every
    alignment, more groups than a grid dimension holds, calls interleaved
    on two streams (a workspace each), each call one kernel (no memset) by
    the profiler, and every workspace left zeroed. Counts exact."""
    from tpuimg_torch.kernels import hist as khist

    for value in (0, 77, 255):
        for shape, g in ((SHAPES[0], 1), ((16, 270, 480), 16),
                         ((64, 8161), 64)):
            x = torch.full(shape, value, dtype=torch.uint8, device=dev)
            got = hist256_groups(x.reshape(g, -1))
            check(bool((got[:, value] == x.numel() // g).all())
                  and int(got.sum()) == x.numel(),
                  f"hist256 of one value {value} {shape}")
    rng = np.random.default_rng(SEED + 91)
    for offset in (1, 5, 15):
        buf = torch.from_numpy(rng.integers(0, 256, 64 * 8161 + offset,
                                            dtype=np.uint8)).to(dev)
        groups = buf[offset:].reshape(64, 8161)
        exact(f"hist256_groups 64x8161 at offset {offset}",
              hist256_groups(groups), hist256_groups_plain(groups), errs,
              "hist256")
    many = torch.from_numpy(rng.integers(0, 256, (70000, 3),
                                         dtype=np.uint8)).to(dev)
    exact("hist256_groups 70000x3", hist256_groups(many),
          hist256_groups_plain(many), errs, "hist256")
    frames = [torch.from_numpy(make_frame(*s, SEED + 92)).to(dev).reshape(
        1, -1) for s in (SHAPES[0], SHAPES[2])]
    frames.append(torch.from_numpy(batch_frames((4, 540, 960), SEED + 93))
                  .to(dev).reshape(4, -1))
    want = [hist256_groups_plain(x) for x in frames]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs += [(i, hist256_groups(x)) for i, x in enumerate(frames)]
    torch.cuda.synchronize()
    for i, out in outs:
        exact("hist256 on two streams", out, want[i], errs, "hist256")
    check(all(int(ws.abs().sum()) == 0 for ws in khist._WORKSPACES.values()),
          "every histogram workspace left zeroed")
    per_call = []
    for x in frames + [many]:
        names = kernels_a_call(hist256_groups, x)
        check(len(names) == 1 and "hist256" in names[0],
              f"one hist256 kernel a call, got {names}")
        per_call.append(len(names))
    print(f"phase 3 hist256: one-value frames over many blocks and one, "
          f"64x8161 groups at offsets 1, 5, 15, 70000 groups, {len(outs)} "
          f"calls on two streams exact; workspaces left zeroed; kernels a "
          f"call by the profiler {per_call} [{card}]")


def unaligned(n: int, offset: int, seed: int, dev):
    """n random u8 pixels on the card whose base lies ``offset`` bytes past
    a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(0, 256, n + offset,
                                        dtype=np.uint8)).to(dev)
    return buf[offset:]


def gather_tables(seed: int) -> list:
    """256-entry tables of every kind lut_gather takes: u8; int32 and
    float32 of random bits (-0.0, inf and a NaN with a payload planted);
    int16, float16 and bool through the 4-byte round trip."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(-2 ** 31, 2 ** 31, 256).astype(np.int32)
    f32 = bits.view(np.float32).copy()
    f32[:3] = (-0.0, np.inf, np.nan)
    f32[3] = np.array([0x7FC00123], dtype=np.uint32).view(np.float32)[0]
    with np.errstate(over="ignore"):
        f16 = np.where(np.isnan(f32), 1.5, f32).astype(np.float16)
    return [torch.from_numpy(t) for t in (
        rng.integers(0, 256, 256, dtype=np.uint8), bits, f32,
        bits.astype(np.int16), f16, rng.integers(0, 2, 256).astype(bool))]


def check_tile_hist_lut_cases(dev, card: str, errs: dict) -> None:
    """Phase 3, the tile-histogram and gather kernels: tile_hist on flat
    frames, frames of one value a tile, widths 7, 1917 and 3839, 64x64
    tiles at 4K and grids whose pads reach past a tile; lut_gather at input
    offsets 0-15 and lengths 1, 15, 16, 17 and 4K + 1 with every table
    kind, lut_gather_frames on (70000, 1, 3) and (3, 1081, 1917) frames;
    calls of both on two streams at once, and each call one kernel (no
    memset) by the profiler. Counts and bits exact."""
    def hist_case(img, yt, xt):
        h, w = img.shape
        geo = _clahe_geometry(h, w, xt, yt)
        args = (img, yt, xt, *geo)
        exact(f"tile_hist {h}x{w} grid {yt}x{xt}", tile_hist(*args),
              tile_hist_plain(*args), errs, "tile_hist")
        return args

    hist_args = []
    for value in (0, 77, 255):
        for tiles in (8, 64):
            hist_case(torch.full(SHAPES[0], value, dtype=torch.uint8,
                                 device=dev), tiles, tiles)
    h, w = SHAPES[1]
    for tiles in (2, 8, 64):
        th, tw, pt, pl = _clahe_geometry(h, w, tiles, tiles)
        ty = (torch.arange(h, device=dev) + pt) // th
        tx = (torch.arange(w, device=dev) + pl) // tw
        img = ((ty[:, None] * tiles + tx[None, :]) * 37 % 256).to(
            torch.uint8).contiguous()
        hist_case(img, tiles, tiles)
    for tiles, width in CLAHE_GRIDS:
        img = torch.from_numpy(make_frame(300, width, SEED + 94)).to(dev)
        hist_args.append(hist_case(img, tiles, tiles))
    for (fh, fw), grid in (((2160, 3840), (64, 64)), ((9, 9), (8, 8)),
                           ((5, 7), (4, 6)), ((70, 1000), (64, 64))):
        img = torch.from_numpy(make_frame(fh, fw, SEED + 95)).to(dev)
        hist_args.append(hist_case(img, *grid))
    for n in (1, 15, 16, 17, SHAPES[0][0] * SHAPES[0][1] + 1):
        for offset in range(16):
            img = unaligned(n, offset, SEED + 96, dev).reshape(1, n)
            for table in gather_tables(SEED + 97):
                table = table.to(dev)
                exact(f"lut_gather {table.dtype} n {n} offset {offset}",
                      lut_gather(table, img), lut_gather_plain(table, img),
                      errs, "lut_gather")
    rng = np.random.default_rng(SEED + 98)
    frames_args = []
    for shape in ((70000, 1, 3), (3, 1081, 1917)):
        imgs = torch.from_numpy(rng.integers(0, 256, shape,
                                             dtype=np.uint8)).to(dev)
        tables = torch.from_numpy(rng.integers(0, 256, (shape[0], 256),
                                               dtype=np.uint8)).to(dev)
        exact(f"lut_gather_frames {shape}", lut_gather_frames(tables, imgs),
              lut_gather_frames_plain(tables, imgs), errs, "lut_gather")
        frames_args.append((tables, imgs))

    img4k = unaligned(SHAPES[0][0] * SHAPES[0][1], 3, SEED + 99,
                      dev).reshape(SHAPES[0])
    f32 = gather_tables(SEED + 97)[2].to(dev)
    calls = [(tile_hist, a, tile_hist_plain) for a in (
        hist_args[0], hist_args[-4], (img4k, TILES, TILES, *_clahe_geometry(
            *SHAPES[0], TILES, TILES)))]
    calls += [(lut_gather, (frames_args[1][0][0], img4k), lut_gather_plain),
              (lut_gather, (f32, img4k), lut_gather_plain),
              (lut_gather_frames, frames_args[1], lut_gather_frames_plain)]
    want = [plain(*a) for _, a, plain in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs += [(i, fn(*a)) for i, (fn, a, _) in enumerate(calls)]
    torch.cuda.synchronize()
    for i, out in outs:
        exact(f"{calls[i][0].__name__} on two streams", out, want[i], errs,
              calls[i][0].__name__.replace("_frames", ""))
    per_call = []
    for fn, a, _ in calls:
        names = kernels_a_call(fn, *a)
        check(len(names) == 1 and fn.__name__.replace("_frames", "")
              in names[0], f"one {fn.__name__} kernel a call, got {names}")
        per_call.append(len(names))
    print(f"phase 3 tile_hist: flat 4K at 8 and 64 tiles, one value a tile "
          f"2161x3839 at 2, 8, 64 tiles, 300-row frames at {CLAHE_GRIDS}, "
          f"64x64 tiles at 4K, pads past a tile (9x9 at 8x8, 5x7 at 4x6, "
          f"70x1000 at 64x64) exact; lut_gather at offsets 0-15, n 1, 15, "
          f"16, 17, 4K + 1, six table kinds, frames (70000, 1, 3) and "
          f"(3, 1081, 1917) exact; {len(outs)} calls on two streams exact; "
          f"kernels a call by the profiler {per_call} [{card}]")


def he_numpy(frame: np.ndarray) -> np.ndarray:
    """The HE formula in NumPy (tpuimg's hist_equalize_ref): table[v] =
    rint(min(255, cdf[v] * float32(256 / N))), indexed by the frame."""
    cdf = np.cumsum(np.bincount(frame.ravel(), minlength=256))
    factor = np.float32(256.0 / frame.size)
    table = np.rint(np.minimum(np.float32(255.0),
                               cdf.astype(np.float32) * factor))
    return table.astype(np.uint8)[frame]


def integral_numpy(frames: np.ndarray) -> np.ndarray:
    """The integral in NumPy: int64 cumsums on both axes, wrapped to
    int32."""
    wide = np.cumsum(np.cumsum(frames.astype(np.int64), axis=-1), axis=-2)
    return wide.astype(np.int32)


def he_plain(img):
    """hist_equalize(img) composed from the kernels' plain versions."""
    h, w = img.shape[-2:]
    if img.ndim == 2:
        hist = hist256_groups_plain(img.reshape(1, -1))[0]
        return lut_gather_plain(_he_tables(hist, h * w), img)
    tables = _he_tables(hist256_groups_plain(img), h * w)
    return lut_gather_frames_plain(tables, img)


def batch_frames(shape, seed: int) -> np.ndarray:
    b, h, w = shape
    return np.stack([make_frame(h, w, seed + i) for i in range(b)])


def exact(what: str, got, ref, errs: dict, name: str) -> None:
    """got equals ref bit for bit (float tensors compared as integers of
    their width, so NaN payloads and -0.0 count); records the measured
    max_abs_err."""
    if got.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
        got, ref = got.view(bits), ref.view(bits)
    check(got.shape == ref.shape and got.dtype == ref.dtype
          and torch.equal(got, ref), f"{what} bit-exact")
    errs[name] = max(errs.get(name, 0.0), max_err(got, ref))


def check_he_kernels(dev, card: str, errs: dict, batch: np.ndarray) -> None:
    """Phase 3, the histogram and table-lookup kernels, and hist_equalize
    against the NumPy formula at 8K and on a flat frame."""
    frames = [(f"{h}x{w}", make_frame(h, w, SEED), False) for h, w in SHAPES]
    frames += [(f"{UHD8K[0]}x{UHD8K[1]}", make_frame(*UHD8K, SEED), True),
               (f"flat {SHAPES[0][0]}x{SHAPES[0][1]}",
                np.full(SHAPES[0], 77, np.uint8), True)]
    for label, frame, whole_op in frames:
        img = torch.from_numpy(frame).to(dev)
        hist = hist256(img)
        exact(f"hist256 {label}", hist,
              hist256_groups_plain(img.reshape(1, -1))[0], errs, "hist256")
        check(int(hist.sum()) == img.numel(),
              f"hist256 {label} counts every pixel")
        line = f"phase 3 hist256 vs plain {label}: exact"
        if whole_op:
            out = hist_equalize(img)
            check(np.array_equal(out.cpu().numpy(), he_numpy(frame)),
                  f"hist_equalize {label} vs the NumPy formula")
            line += "; hist_equalize equals the NumPy formula"
        print(f"{line} [{card}]")

    rng = np.random.default_rng(SEED)
    bits = rng.integers(-2 ** 31, 2 ** 31, 256).astype(np.int32)
    f32 = bits.view(np.float32).copy()
    f32[:2] = (-0.0, np.nan)
    for h, w in SHAPES:
        img = torch.from_numpy(make_frame(h, w, SEED)).to(dev)
        u8 = _he_tables(hist256_groups_plain(img.reshape(1, -1))[0], h * w)
        for kind, table in (("u8", u8), ("int32", torch.from_numpy(bits)),
                            ("float32", torch.from_numpy(f32))):
            table = table.to(dev)
            exact(f"lut_gather {kind} table {h}x{w}", lut_gather(table, img),
                  lut_gather_plain(table, img), errs, "lut_gather")
        print(f"phase 3 lut_gather vs plain {h}x{w}: u8, int32 and float32 "
              f"tables exact [{card}]")

    stack = torch.from_numpy(batch).to(dev)
    odd = torch.from_numpy(batch_frames((3, 1081, 1917), SEED + 20)).to(dev)
    for fr in (stack, odd):
        label = "x".join(map(str, fr.shape))
        exact(f"hist256_frames {label}", hist256_frames(fr),
              hist256_groups_plain(fr), errs, "hist256")
        print(f"phase 3 hist256_frames vs plain {label}: exact [{card}]")
    groups = torch.from_numpy(
        rng.integers(0, 256, (64, 8161), dtype=np.uint8)).to(dev)
    exact("hist256_groups 64x8161", hist256_groups(groups),
          hist256_groups_plain(groups), errs, "hist256")
    # packed words: a 4K frame seen as int32 words, a row a group, and random
    # words, many with the top bit set
    words = torch.from_numpy(make_frame(*SHAPES[0], SEED)).to(dev).view(
        torch.int32)
    signed = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, (64, 2041), dtype=np.int64).astype(np.int32)).to(dev)
    check(bool((signed < 0).any()), "packed words with the top bit set")
    for x in (words, signed):
        exact(f"hist256_packed {tuple(x.shape)}", hist256_groups_packed(x),
              hist256_groups_packed_plain(x), errs, "hist256_packed")
    print(f"phase 3 hist256_groups_packed vs plain, {tuple(words.shape)} "
          f"words of a 4K frame and {tuple(signed.shape)} random words: "
          f"exact [{card}]")
    tables = _he_tables(hist256_groups_plain(stack), stack[0].numel())
    exact("lut_gather_frames", lut_gather_frames(tables, stack),
          lut_gather_frames_plain(tables, stack), errs, "lut_gather")
    print(f"phase 3 hist256_groups 64x8161 and lut_gather_frames "
          f"{'x'.join(map(str, BATCH))} vs plain: exact [{card}]")
    # HE's tables from the histogram launch: the cell's stack (split groups,
    # the last block builds each table), a flat 4K frame (every entry from
    # 77 on is 255) and odd-sized frames (bases off alignment)
    flat = torch.full((1,) + SHAPES[0], 77, dtype=torch.uint8, device=dev)
    for fr in (stack, flat, odd):
        label = "x".join(map(str, fr.shape))
        want = _he_tables(hist256_groups_plain(fr), fr[0].numel())
        exact(f"he_tables {label}", he_tables_frames(fr), want, errs,
              "he_tables")
        print(f"phase 3 he_tables vs plain {label}: exact [{card}]")
    check(bool((he_tables_frames(flat)[0, 77:] == 255).all()),
          "he_tables of a flat frame: 255 from its value on")


def check_integral_kernel(dev, card: str, errs: dict,
                          batch: np.ndarray) -> None:
    """Phase 3, the scan kernel, against its plain version and NumPy."""
    cases = [(f"{h}x{w}", make_frame(h, w, SEED)) for h, w in SHAPES[:2]]
    cases.append(("x".join(map(str, batch[:3].shape)), batch[:3]))
    cases.append(("x".join(map(str, batch.shape)), batch))
    cases.append((f"all-255 {UHD8K[0]}x{UHD8K[1]}",
                  np.full(UHD8K, 255, np.uint8)))
    for label, frame in cases:
        img = torch.from_numpy(frame).to(dev)
        got = integral_kernel(img)
        # a second call on another frame, and one on a slice that starts 3
        # bytes into its storage: nothing of a call may linger in the next
        again = integral_kernel(torch.flip(img, (-1,)).contiguous())
        exact(f"integral {label} flipped, the call after",
              again, integral_plain(torch.flip(img, (-1,))), errs,
              "integral")
        off = torch.cat((img.reshape(-1)[:3], img.reshape(-1)))[3:]
        exact(f"integral {label} at a storage offset of 3 bytes",
              integral_kernel(off.view(img.shape)), got, errs, "integral")
        exact(f"integral {label}", got, integral_plain(img), errs,
              "integral")
        want = integral_numpy(frame)
        check(np.array_equal(got.cpu().numpy(), want),
              f"integral {label} vs the wrapped int64 cumsum")
        print(f"phase 3 integral vs plain and NumPy {label}: exact, last sum "
              f"{int(want.reshape(-1)[-1])} [{card}]")
    check(int(want[-1, -1]) < 0, "the all-255 8K sums wrap past 2^31")


def morph_frame(shape, dtype: str, seed: int) -> np.ndarray:
    """A morphology input: u8, the synthetic scene (a stack of them for a
    batch); int32 over its whole range with INT_MIN and INT_MAX planted;
    float32 noise with -0.0 planted often and a few NaNs and infinities,
    sparse enough that r31 leaves most pixels finite."""
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return (make_frame(*shape, seed) if len(shape) == 2
                else batch_frames(shape, seed))
    if dtype == "int32":
        x = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
            np.int32)
        x.flat[::997] = np.iinfo(np.int32).min
        x.flat[13::991] = np.iinfo(np.int32).max
        return x
    x = rng.standard_normal(shape).astype(np.float32)
    x.flat[::101] = -0.0
    k = max(1, x.size // 400_000)
    x.flat[rng.integers(0, x.size, 3 * k)] = np.repeat(
        np.float32([np.nan, np.inf, -np.inf]), k)
    return x


def same_values(what: str, got, ref, errs: dict, name: str) -> None:
    """got equals ref in dtype, shape and value, NaNs in the same places
    (+0 equals -0: min and max keep either); records the measured
    max_abs_err over the finite pixels."""
    check(got.dtype == ref.dtype and got.shape == ref.shape,
          f"{what} dtype and shape")
    if got.is_floating_point():
        nan = torch.isnan(ref)
        check(torch.equal(torch.isnan(got), nan),
              f"{what} NaNs in the same places")
        got, ref = got[~nan], ref[~nan]
    check(torch.equal(got, ref), f"{what} equal values")
    if ref.is_floating_point():
        finite = torch.isfinite(ref)
        got, ref = got[finite], ref[finite]
    err = max_err(got, ref) if ref.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)


def two_pass_since(before: int, x, r: int,
                   entry: str = "tpuimg_morphology") -> int:
    """The launches of ``entry`` since its count was ``before``, each at
    radius ``r`` on ``x``, that took the two-pass route: those for which
    kernels/sep_stencil.py::morph_tile plans no tile. A frame's radius
    clamps to its longer side; a row-padded block's is its halo."""
    if entry == "tpuimg_morphology":
        r = min(r, max(x.shape[-2:]) - 1)
    split = morph_tile(r, x.element_size()) is None
    return (kernels.launches[entry] - before) * split


def check_morph_kernels(dev, card: str, errs: dict) -> None:
    """Phase 3, the morphology and open/close kernels, in every dtype."""
    cases = [(shape, MORPH_R, OPEN_CLOSE_R) for shape in SHAPES]
    cases += [(shape, [r], [r]) for shape, r in MORPH_TINY]
    cases += [(MORPH_BATCH, [MORPH_PATH_R], [MORPH_PATH_R]),
              (SHAPES[0], [200], [200])]
    for shape, radii, oc_radii in cases:
        label = "x".join(map(str, shape))
        split = 0
        for dtype in ("uint8", "int32", "float32"):
            x = torch.from_numpy(morph_frame(shape, dtype, SEED + 30)).to(dev)
            for r in radii:
                before = kernels.launches["tpuimg_morphology"]
                for mode in (0, 1):
                    same_values(f"morphology {label} {dtype} r{r} mode {mode}",
                                morphology_kernel(x, r, mode),
                                morphology_plain(x, r, mode), errs,
                                "morphology")
                split += two_pass_since(before, x, r)
            for r in oc_radii:
                before = kernels.launches["tpuimg_morphology"]
                for mode in (0, 1):
                    same_values(f"open_close {label} {dtype} r{r} mode {mode}",
                                open_close_kernel(x, r, mode),
                                open_close_plain(x, r, mode), errs,
                                "open_close")
                split += two_pass_since(before, x, r)
        torch.cuda.synchronize()
        print(f"phase 3 morphology vs plain {label}: erode and dilate r "
              f"{radii}, open and close r {oc_radii}, u8, int32 and float32 "
              f"equal, NaNs in place; two-pass route {split} times [{card}]")
    # r200: the two-pass route past each dtype's tile ceiling, for erode and
    # dilate and the two morphology launches of open and close each
    want = sum(6 * (200 > morph_max_radius(getattr(torch, d)))
               for d in ("uint8", "int32", "float32"))
    check(split == want, f"r200 at 4K takes the two-pass route {split} "
          f"times, not {want}")


def check_morph_limits(dev, card: str, errs: dict) -> None:
    """Phase 3, erode and dilate at each dtype's tile ceiling (one launch)
    and one past it (the two-pass route), on an unaligned frame and on a
    row-padded block of the same width."""
    h, w = SHAPES[1]
    for dtype in ("uint8", "int32", "float32"):
        x = torch.from_numpy(morph_frame((h, w), dtype, SEED + 33)).to(dev)
        top = morph_max_radius(x.dtype)
        for r in (top, top + 1):
            blk = torch.from_numpy(morph_frame((7 + 2 * r, w), dtype,
                                               SEED + 34)).to(dev)
            before = (kernels.launches["tpuimg_morphology"],
                      kernels.launches["tpuimg_morphology_ypadded"])
            for mode in (0, 1):
                same_values(f"morphology {h}x{w} {dtype} r{r} mode {mode}",
                            morphology_kernel(x, r, mode),
                            morphology_plain(x, r, mode), errs, "morphology")
                same_values(f"morph_ypadded {tuple(blk.shape)} {dtype} r{r} "
                            f"mode {mode}", morph_ypadded_kernel(blk, r, mode),
                            morph_ypadded_plain(blk, r, mode), errs,
                            "morph_ypadded")
            got = (two_pass_since(before[0], x, r),
                   two_pass_since(before[1], blk, r,
                                  "tpuimg_morphology_ypadded"))
            want = (0, 0) if r <= top else (2, 2)
            check(got == want, f"morphology {dtype} r{r}: two-pass routes "
                  f"{got}, not {want}")
        torch.cuda.synchronize()
        print(f"phase 3 morphology and morph_ypadded vs plain {h}x{w} "
              f"{dtype} at the tile ceiling {top}: r{top} one launch, "
              f"r{top + 1} two-pass route, equal, NaNs in place [{card}]")


def check_open_close_limits(dev, card: str, errs: dict) -> None:
    """Phase 3, open_close at each dtype's ceiling (one fused launch) and one
    past it (two morphology launches), on frames narrower than a tile or of
    one row or column, and at r16 (2r + 1 = 33 divides no line)."""
    h, w = SHAPES[1]
    for dtype in ("uint8", "int32", "float32"):
        x = torch.from_numpy(morph_frame((h, w), dtype, SEED + 31)).to(dev)
        top = open_close_max_radius(x.dtype)
        line = []
        for r in (top, top + 1):
            before = (kernels.launches["tpuimg_open_close"],
                      kernels.launches["tpuimg_morphology"])
            for mode in (0, 1):
                same_values(f"open_close {h}x{w} {dtype} r{r} mode {mode}",
                            open_close_kernel(x, r, mode),
                            open_close_plain(x, r, mode), errs, "open_close")
            got = (kernels.launches["tpuimg_open_close"] - before[0],
                   kernels.launches["tpuimg_morphology"] - before[1])
            want = (2, 0) if r <= top else (0, 4)
            check(got == want, f"open_close {dtype} r{r}: (fused, morphology) "
                  f"launches {got}, not {want}")
            line.append(f"r{r} {'fused' if r <= top else 'two launches'}")
        torch.cuda.synchronize()
        print(f"phase 3 open_close vs plain {h}x{w} {dtype} at its ceiling "
              f"{top}: {', '.join(line)}, equal, NaNs in place [{card}]")
    for shape in OPEN_CLOSE_NARROW:
        for dtype in ("uint8", "int32", "float32"):
            x = torch.from_numpy(morph_frame(shape, dtype, SEED + 32)).to(dev)
            for r in (MORPH_PATH_R, 16):
                for mode in (0, 1):
                    same_values(f"open_close {shape} {dtype} r{r} mode {mode}",
                                open_close_kernel(x, r, mode),
                                open_close_plain(x, r, mode), errs,
                                "open_close")
        torch.cuda.synchronize()
        print(f"phase 3 open_close vs plain {shape[0]}x{shape[1]}: r15 and "
              f"r16, u8, int32 and float32 equal, NaNs in place [{card}]")


def tail_sigma(rg: int) -> float:
    return 1.5 if rg <= 2 else 5.0


def check_tail_radii(dev, card: str, errs: dict) -> None:
    """Phase 3, both tails over their radius range (gf r TAIL_R by gaussian
    r TAIL_RG, walk 1's scratch route where its rings pass a block's shared
    memory) at the three sizes and on frames just above enhance's gate: the
    f32 tail within 1e-4 of its plain version, the fused1 tail within 5e-6
    of it on the card's own blend and within 1e-4 of its plain version."""
    cases = [((h, w), r, rg) for h, w in SHAPES for r in TAIL_R
             for rg in TAIL_RG]
    cases += [((2 * (2 * GF_R + RG) + 1, 53), GF_R, RG),
              ((2 * (2 * 64 + 16) + 1, 300), 64, 16)]
    frames = {}
    for shape, r, rg in cases:
        if shape not in frames:
            img = torch.from_numpy(make_frame(*shape, SEED + 33)).to(dev)
            geo, tables = front_at(img, TILES)
            args = (img, tables, TILES, TILES, *geo)
            frames[shape] = (args, clahe_map(*args, True) * INV_255)
        args, f = frames[shape]
        sigma = tail_sigma(rg)
        got = enhance_tail(f, rg, sigma, r, GF_EPS)
        err = max_err(got, enhance_tail_plain(f, rg, sigma, r, GF_EPS))
        fused1 = enhance_tail_clahe(*args, rg, sigma, r, GF_EPS)
        diff = max_err(fused1, got)
        err1 = max_err(fused1, enhance_tail_clahe_plain(*args, rg, sigma, r,
                                                        GF_EPS))
        label = f"{shape[0]}x{shape[1]} r{r} rg{rg}"
        check(bool(torch.isfinite(got).all()), f"enhance_tail {label} finite")
        check(err <= 1e-4, f"enhance_tail {label}: {err} <= 1e-4")
        check(diff <= 5e-6, f"enhance_tail_clahe {label} vs enhance_tail: "
              f"{diff} <= 5e-6")
        check(err1 <= 1e-4, f"enhance_tail_clahe {label}: {err1} <= 1e-4")
        errs["enhance_tail"] = max(errs["enhance_tail"], err)
        errs["enhance_tail_clahe"] = max(errs.get("enhance_tail_clahe", 0.0),
                                         err1)
        torch.cuda.synchronize()
        route = ("shared" if kernels.load().tpuimg_enhance_tail_shared(rg, r)
                 else "scratch")
        print(f"phase 3 tails {label} ({route} route): enhance_tail vs plain "
              f"{err:.3g}, enhance_tail_clahe vs enhance_tail {diff:.3g} vs "
              f"plain {err1:.3g} [{card}]")


def check_tail_clahe_kernel(dev, card: str, errs: dict) -> None:
    """Phase 3, the fused1 tail against the f32 tail on the card's own
    blend, and against its plain version."""
    for h, w in SHAPES:
        img = torch.from_numpy(make_frame(h, w, SEED)).to(dev)
        line = []
        for yt, xt in TAIL_GRIDS:
            th, tw, pt, pl = _clahe_geometry(h, w, xt, yt)
            tables = _clahe_tables(
                tile_hist_plain(img, yt, xt, th, tw, pt, pl), CLIP, th, tw)
            geo = (yt, xt, th, tw, pt, pl)
            got = enhance_tail_clahe(img, tables, *geo, RG, SIGMA, GF_R,
                                     GF_EPS)
            blend = clahe_map(img, tables, *geo, True)
            tail = enhance_tail(blend * INV_255, RG, SIGMA, GF_R, GF_EPS)
            diff, ndiff = max_err(got, tail), int((got != tail).sum())
            err = max_err(got, enhance_tail_clahe_plain(
                img, tables, *geo, RG, SIGMA, GF_R, GF_EPS))
            label = f"enhance_tail_clahe {h}x{w} tiles {yt}x{xt}"
            check(bool(torch.isfinite(got).all()), f"{label} finite")
            check(diff <= 5e-6, f"{label} vs enhance_tail: {diff} <= 5e-6")
            check(err <= 1e-4, f"{label} vs plain: {err} <= 1e-4")
            errs["enhance_tail_clahe"] = max(
                errs.get("enhance_tail_clahe", 0.0), err)
            line.append(f"{yt}x{xt} vs tail {diff:.3g} ({ndiff} px differ) "
                        f"vs plain {err:.3g}")
        print(f"phase 3 enhance_tail_clahe {h}x{w}: {'; '.join(line)} "
              f"[{card}]")


def check_ypadded_kernels(dev, card: str, errs: dict) -> None:
    """Phase 3, the row-padded kernels at the blocks the sharded paths give
    them: an enhance_sharded shard of 4K over sp = 4 (540 rows with the
    tail's 2*reach halo rows), an unaligned 541x3839 one and a one-row one,
    and morphology blocks of 2x4K over (2, 4)."""
    for rows in SHARD_ROWS:
        w = SHAPES[1][1] if rows == SHARD_ROWS[1] else SHAPES[0][1]
        fp, p = guide_pair((rows + 2 * REACH, w), SEED + 40 + rows, dev)
        smooth = gaussian_ypadded_kernel(fp, RG, SIGMA)
        ref_g = gaussian_ypadded_plain(fp, RG, SIGMA)
        err_g = max_err(smooth, ref_g)
        check(smooth.shape == (rows + 4 * GF_R, w), f"gaussian_ypadded shape "
              f"{tuple(smooth.shape)}")
        Ip = fp[RG:fp.shape[0] - RG]
        line = [f"gaussian r{RG} {err_g:.3g}"]
        check(torch.equal(smooth, ref_g), f"gaussian_ypadded {rows}x{w}: "
              f"{err_g} from the plain version, not equal")
        errs["gaussian_ypadded"] = max(errs.get("gaussian_ypadded", 0.0),
                                       err_g)
        for what, pp, self_g in (("general", smooth, False),
                                 ("self", Ip, True)):
            got = guided_ypadded_kernel(Ip, pp, GF_R, GF_EPS, self_g)
            err = max_err(got, guided_ypadded_plain(Ip, pp, GF_R, GF_EPS,
                                                    self_g))
            check(got.shape == (rows, w) and bool(torch.isfinite(got).all()),
                  f"guided_ypadded {what} {rows}x{w} shape and finite")
            check(err <= 1e-4, f"guided_ypadded {what} {rows}x{w}: {err} "
                  f"<= 1e-4")
            errs["guided_ypadded"] = max(errs.get("guided_ypadded", 0.0), err)
            line.append(f"guided r{GF_R} {what} {err:.3g}")
        torch.cuda.synchronize()
        print(f"phase 3 ypadded vs plain, {rows}x{w} shard "
              f"({rows + 2 * REACH} rows in): {', '.join(line)} [{card}]")
    one, _ = guide_pair((1 + 2 * RG, SHAPES[0][1]), SEED + 45, dev)
    check(torch.equal(gaussian_ypadded_kernel(one, RG, SIGMA),
                      gaussian_ypadded_plain(one, RG, SIGMA)),
          "gaussian_ypadded one-row block equals its plain version")
    check_guided_ypadded_large(dev, card, errs)

    w = SHAPES[0][1]
    cases = [((2, SHARD_ROWS[0]), w, YPAD_MORPH_R),
             ((SHARD_ROWS[1],), SHAPES[1][1], YPAD_MORPH_R),
             ((1,), w, YPAD_MORPH_R), ((30,), 600, [120])]
    for lead_rows, w, radii in cases:
        *lead, rows = lead_rows
        for r in radii:
            shape = (*lead, rows + 2 * r, w)
            split = 0
            for dtype in ("uint8", "int32", "float32"):
                x = torch.from_numpy(morph_frame(shape, dtype, SEED + 50)).to(
                    dev)
                before = kernels.launches["tpuimg_morphology_ypadded"]
                for mode in (0, 1):
                    got = morph_ypadded_kernel(x, r, mode)
                    check(got.shape == (*lead, rows, w),
                          f"morph_ypadded shape {tuple(got.shape)}")
                    same_values(f"morph_ypadded {shape} {dtype} r{r} mode "
                                f"{mode}", got,
                                morph_ypadded_plain(x, r, mode), errs,
                                "morph_ypadded")
                split += two_pass_since(before, x, r,
                                        "tpuimg_morphology_ypadded")
            torch.cuda.synchronize()
            want = sum(2 * (r > morph_max_radius(getattr(torch, d)))
                       for d in ("uint8", "int32", "float32"))
            check(split == want, f"morph_ypadded r{r} took the two-pass "
                  f"route {split} times, not {want}")
            print(f"phase 3 morph_ypadded vs plain {'x'.join(map(str, shape))}"
                  f" r{r}: u8, int32 and float32 equal, NaNs in place; "
                  f"two-pass route {split} times [{card}]")

    img = torch.from_numpy(make_frame(*SHAPES[0], SEED + 60)).to(dev)
    for tiles in BAND_GRIDS:
        geo, tables = front_at(img, tiles)
        full = clahe_map(img, tables, tiles, tiles, *geo, True)
        line = []
        for y0 in BAND_Y0:
            band = img[y0:y0 + SHARD_ROWS[0]]
            args = (band, tables, tiles, tiles, *geo, y0)
            f32 = clahe_band_map(*args, out_f32=True)
            err = max_err(f32, clahe_band_map_plain(*args, out_f32=True))
            step = int((clahe_band_map(*args).int()
                        - clahe_band_map_plain(*args).int()).abs().max())
            check(err <= 1e-3, f"clahe_band_map f32 y0 {y0}: {err} <= 1e-3")
            check(step <= 1, f"clahe_band_map u8 y0 {y0}: {step} <= 1 step")
            check(torch.equal(f32, full[y0:y0 + SHARD_ROWS[0]]),
                  f"clahe_band_map y0 {y0} equals the frame's clahe_map rows")
            errs["clahe_band_map"] = max(errs.get("clahe_band_map", 0.0), err)
            line.append(f"y0 {y0}: f32 {err:.3g}, u8 {step} step")
        print(f"phase 3 clahe_band_map vs plain, {SHARD_ROWS[0]}-row bands "
              f"of {SHAPES[0][0]}x{SHAPES[0][1]} tiles {tiles}: "
              f"{'; '.join(line)}; each equals clahe_map's rows [{card}]")


def check_guided_ypadded_large(dev, card: str, errs: dict) -> None:
    """Phase 3, the row-padded guided entry past r = 16 (tpuimg has no
    ceiling there): a 4K shard's block (540 output rows) and a one-row block
    at each radius, general and self-guided; r80 on the scratch route."""
    w = SHAPES[0][1]
    for r in YPAD_GUIDED_R:
        for rows in (SHARD_ROWS[0], 1):
            I, p = guide_pair((rows + 4 * r, w), SEED + 80 + r + rows, dev)
            entry = "tpuimg_guided_onepass_ypadded_scratch"
            scratch = kernels.launches[entry]
            line = []
            for what, pp, self_g in (("general", p, False), ("self", I, True)):
                got = guided_ypadded_kernel(I, pp, r, GF_EPS, self_g)
                err = max_err(got, guided_ypadded_plain(I, pp, r, GF_EPS,
                                                        self_g))
                label = f"guided_ypadded r{r} {what} {rows}x{w}"
                check(got.shape == (rows, w)
                      and bool(torch.isfinite(got).all()),
                      f"{label} shape and finite")
                check(err <= 1e-4, f"{label}: {err} <= 1e-4")
                errs["guided_ypadded"] = max(errs["guided_ypadded"], err)
                line.append(f"{what} {err:.3g}")
            torch.cuda.synchronize()
            scratch = kernels.launches[entry] - scratch
            want = 2 if r > kernels.GUIDED_SMEM_MAX_RADIUS else 0
            check(scratch == want, f"guided_ypadded r{r} took the scratch "
                  f"route {scratch} times, not {want}")
            print(f"phase 3 guided_ypadded r{r} vs plain, {rows}x{w} block "
                  f"({rows + 4 * r} rows in): {', '.join(line)}; scratch "
                  f"route {scratch} times [{card}]")


def front_at(img, tiles: int, clip: float = CLIP):
    """CLAHE geometry and tables of a frame on a tiles x tiles grid."""
    h, w = img.shape
    th, tw, pt, pl = _clahe_geometry(h, w, tiles, tiles)
    hists = tile_hist_plain(img, tiles, tiles, th, tw, pt, pl)
    return (th, tw, pt, pl), _clahe_tables(hists, clip, th, tw)


def counts() -> dict:
    return {name: kernels.launches[entry] for name, entry, _, _ in KERNELS}


def drive(label: str, expected, fn, *args):
    """One run of a main path: the launches of each kernel's C entry
    during it, every expected kernel launched. Returns the output and the
    counts."""
    before = counts()
    out = fn(*args)
    torch.cuda.synchronize()
    got = {k: n - before[k] for k, n in counts().items()}
    for name in expected:
        check(got[name] > 0, f"{name} launched during {label} ({got[name]})")
    return out, got


def check_enhance_out(label, out, img, frame, impl, card) -> None:
    h, w = frame.shape
    check(out.shape == (h, w) and out.dtype == torch.uint8,
          f"{label} output {tuple(out.shape)} {out.dtype}")
    step = int((out.int() - enhance_plain(img, impl).int()).abs().max())
    check(step <= 1, f"{label} vs plain composition: {step} <= 1 step")
    crop = frame[:270, :480].copy()
    cpu = enhance(torch.from_numpy(crop), impl=impl).int()
    card_out = enhance(torch.from_numpy(crop).to(img.device), impl=impl)
    crop_step = int((card_out.cpu().int() - cpu).abs().max())
    check(crop_step <= 1, f"{label} {crop.shape} crop card vs CPU: "
          f"{crop_step} <= 1")
    print(f"phase 4 {label}: vs plain composition {step} step, "
          f"{crop.shape[0]}x{crop.shape[1]} crop vs CPU {crop_step} step, "
          f"mean {float(out.float().mean()):.2f} [{card}]")


def run_main_paths(dev, card: str, batch: np.ndarray) -> dict:
    """Phase 4; returns each kernel's launches summed over the runs."""
    total = dict.fromkeys(counts(), 0)
    clahe_kernels = ("tile_tables", "clahe_map")
    h, w = SHAPES[0]
    outs = {}
    for label, shape, impl, expected in (
            (f"enhance {h}x{w} fused", (h, w), "fused", ("enhance_run",)),
            (f"enhance {h}x{w} fused1", (h, w), "fused1", ("enhance_run",)),
            (f"enhance {h}x{w} staged", (h, w), "staged",
             clahe_kernels + ("gaussian", "guided")),
            (f"enhance {SMALL[0]}x{SMALL[1]} fused", SMALL, "fused",
             clahe_kernels + ("gaussian", "guided"))):
        frame = make_frame(*shape, SEED + 1)
        img = torch.from_numpy(frame).to(dev)
        out, got = drive(label, expected, enhance, img, CLIP,
                         TILES, RG, SIGMA, GF_R, GF_EPS, impl)
        print(f"phase 4 {label}: launches {got} [{card}]")
        planned = expected == ("enhance_run",)
        check(got["tile_hist"] == 0 and got["enhance_run"] == planned
              and got["tile_tables"] == (not planned),
              f"{label}: the tables leave one tile kernel launch, in the "
              f"plan's C call above the gate")
        check_enhance_out(label, out, img, frame, impl, card)
        outs[(shape, impl)] = out
        total = {k: total[k] + got[k] for k in total}
        if impl == "staged":
            fused = outs[(shape, "fused")]
            step = int((out.int() - fused.int()).abs().max())
            check(step <= 1, f"{label} vs fused: {step} <= 1 step")
            print(f"phase 4 {label} vs fused: {int((out != fused).sum())} "
                  f"pixels differ, max {step} step [{card}]")
        if impl == "fused1":
            check(got["clahe_map"] == 0, f"{label} launches no clahe_map")
            fused = outs[(shape, "fused")]
            step = int((out.int() - fused.int()).abs().max())
            ndiff = int((out != fused).sum())
            check(step <= 1, f"{label} vs fused: {step} <= 1 step")
            print(f"phase 4 {label} vs fused: {ndiff} pixels differ, max "
                  f"{step} step [{card}]")

    # the stand-alone filters at the JAX package's bench rows (bench.py:54,
    # :72-81) and guided's twopass rung (tpuimg/cli.py:523-531)
    f1080, _ = guide_pair((1080, 1920), SEED + 2, dev)
    I, p = guide_pair((h, w), SEED + 3, dev)

    def filters():
        return (gaussian(f1080, 2, 1.5),
                guided_filter(I, I, 8, GF_EPS, border="reflect101"),
                guided_filter(I, p, 8, GF_EPS, border="reflect101"),
                guided_filter_kernel(I, p, 8, GF_EPS, variant="twopass"),
                guided_filter(I, p3, 15, GF_EPS))

    # the guided-rgb-shrink-4k cell's call: a 3-channel source by one guide
    # at the default (shrink) border, r 15
    _, p3 = guide_pair((3, h, w), SEED + 4, dev)
    outs, got = drive("the stand-alone filters",
                      ("gaussian", "guided", "guided_twopass",
                       "guided_twopass_shrink"), filters)
    refs = (gaussian_plain(f1080, 2, 1.5),
            guided_filter_plain(I, I, 8, GF_EPS, True),
            guided_filter_plain(I, p, 8, GF_EPS),
            guided_filter_plain(I, p, 8, GF_EPS),
            guided_filter_plain(I, p3, 15, GF_EPS, border="shrink"))
    errs = [max_err(o, r) for o, r in zip(outs, refs)]
    check(errs[0] <= 1e-5, f"gaussian 1080p r2: {errs[0]} <= 1e-5")
    check(max(errs[1:]) <= 1e-4, f"guided 4K: {errs[1:]} <= 1e-4")
    check(got["guided_twopass_shrink"] == 1,
          "guided 4K C3 r15 shrink: one launch of its entry")
    print(f"phase 4 stand-alone filters: launches {got}; gaussian 1080p r2 "
          f"{errs[0]:.3g}, guided 4K r8 self {errs[1]:.3g} general "
          f"{errs[2]:.3g} twopass {errs[3]:.3g}, C3 r15 shrink "
          f"{errs[4]:.3g} [{card}]")
    total = {k: total[k] + got[k] for k in total}
    time_shrink_channels(dev, card)
    he = run_he_integral_paths(dev, card, batch)
    morph = run_morph_paths(dev, card)
    return {k: total[k] + he[k] + morph[k] for k in total}


def run_morph_paths(dev, card: str) -> dict:
    """Phase 4 for the four morphology ops at morph_31x31_4k_batch2
    (bench.py:84); returns the launches summed."""
    total = dict.fromkeys(counts(), 0)
    frames = morph_frame(MORPH_BATCH, "uint8", SEED + 6)
    x = torch.from_numpy(frames).to(dev)
    r = MORPH_PATH_R
    crop = np.ascontiguousarray(frames[..., :270, :480])
    for fn, kernel, plain in (
            (erode, "morphology", lambda v: morphology_plain(v, r, 0)),
            (dilate, "morphology", lambda v: morphology_plain(v, r, 1)),
            (morph_open, "open_close", lambda v: open_close_plain(v, r, 0)),
            (morph_close, "open_close", lambda v: open_close_plain(v, r, 1))):
        label = f"{fn.__name__} r{r} {'x'.join(map(str, MORPH_BATCH))}"
        out, got = drive(label, (kernel,), fn, x, r)
        check(got[kernel] == 1 and sum(got.values()) == 1,
              f"{label}: one {kernel} launch and no other ({got})")
        check(out.shape == x.shape and out.dtype == torch.uint8
              and torch.equal(out, plain(x)), f"{label} vs plain composition")
        card_out = fn(torch.from_numpy(crop).to(dev), r).cpu()
        check(torch.equal(card_out, fn(torch.from_numpy(crop), r)),
              f"{label} {crop.shape} crop card vs CPU")
        print(f"phase 4 {label}: launches {{'{kernel}': {got[kernel]}}}; "
              f"equals the plain composition, and the CPU run on a "
              f"{'x'.join(map(str, crop.shape))} crop [{card}]")
        total = {k: total[k] + got[k] for k in total}
    return total


def run_he_integral_paths(dev, card: str, batch: np.ndarray) -> dict:
    """Phase 4 for hist_equalize at its two bench rows (bench.py:58-66) and
    integral at integral_4k (bench.py:56); returns the launches summed."""
    total = dict.fromkeys(counts(), 0)
    h, w = SHAPES[0]
    frame = make_frame(h, w, SEED + 4)
    he = ("he_tables", "lut_gather")
    for label, expected, fn, arr in (
            (f"hist_equalize {h}x{w}", he, hist_equalize, frame),
            (f"hist_equalize {'x'.join(map(str, BATCH))}", he, hist_equalize,
             batch),
            (f"integral {h}x{w}", ("integral",), integral, frame)):
        x = torch.from_numpy(arr).to(dev)
        out, got = drive(label, expected, fn, x)
        check(all(got[k] == 1 for k in expected),
              f"{label}: one launch of each kernel ({got})")
        if fn is integral:
            plain, want = integral_plain(x), integral_numpy(arr)
        else:
            plain = he_plain(x)
            want = np.stack([he_numpy(f) for f in arr.reshape(
                (-1,) + arr.shape[-2:])]).reshape(arr.shape)
        check(out.shape == x.shape and out.dtype == plain.dtype
              and torch.equal(out, plain), f"{label} vs plain composition")
        check(np.array_equal(out.cpu().numpy(), want),
              f"{label} vs the NumPy formula")
        crop = np.ascontiguousarray(arr[..., :270, :480])
        card_out = fn(torch.from_numpy(crop).to(dev)).cpu()
        check(torch.equal(card_out, fn(torch.from_numpy(crop))),
              f"{label} {crop.shape} crop card vs CPU")
        mine = {k: got[k] for k in expected}
        print(f"phase 4 {label}: launches {mine}; equals the plain "
              f"composition and the NumPy formula, and the CPU run on a "
              f"{'x'.join(map(str, crop.shape))} crop [{card}]")
        total = {k: total[k] + got[k] for k in total}
    # a caller that holds the frame as packed words (tpuimg has none: its
    # packed kernel is an entry of its own)
    img = torch.from_numpy(frame).to(dev)
    words = img.view(torch.int32).reshape(1, -1)
    label = f"hist256_groups_packed {tuple(words.shape)} words of {h}x{w}"
    out, got = drive(label, ("hist256_packed",), hist256_groups_packed, words)
    check(got["hist256_packed"] == 1 and sum(got.values()) == 1,
          f"{label}: one hist256_packed launch and no other ({got})")
    check(torch.equal(out[0], hist256(img)), f"{label} equals hist256")
    check(torch.equal(out[0].cpu(), torch.from_numpy(np.bincount(
        frame.ravel(), minlength=256).astype(np.int32))),
          f"{label} equals NumPy's bincount")
    print(f"phase 4 {label}: launches {{'hist256_packed': 1}}; equals "
          f"hist256 of the frame and NumPy's bincount [{card}]")
    total["hist256_packed"] += 1
    return total


def meshes(dev) -> dict:
    """Meshes of the one card repeated: a single controller runs the shards
    one after another on its current stream."""
    return {shape: make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
            for shape in ((1, 4), (2, 4), (4, 2))}


def run_sharded_paths(dev, card: str, batch: np.ndarray) -> dict:
    """Phase 4 for the sharded path (parallel/sharding.py) against the
    port's unsharded ops on the card; returns the launches summed."""
    total = dict.fromkeys(counts(), 0)
    mesh = meshes(dev)
    h, w = SHAPES[0]
    ypad = ("clahe_band_map", "gaussian_ypadded", "guided_ypadded")

    def add(got):
        for k in total:
            total[k] += got[k]

    for label, shape in ((f"enhance_sharded {h}x{w} (1, 4)", (h, w)),
                         (f"enhance_sharded {UHD8K[0]}x{UHD8K[1]} (1, 4)",
                          UHD8K),
                         (f"enhance_sharded {h + 1}x{w} (1, 4)", (h + 1, w))):
        img = torch.from_numpy(make_frame(*shape, SEED + 7)).to(dev)
        op = enhance_sharded(mesh[(1, 4)], CLIP, TILES, RG, SIGMA, GF_R,
                             GF_EPS)
        out, got = drive(label, ypad, op, img)
        add(got)
        out = out.gather()
        ref = enhance(img, CLIP, TILES, RG, SIGMA, GF_R, GF_EPS, "staged")
        step = int((out.int() - ref.int()).abs().max())
        check(out.shape == ref.shape and out.dtype == torch.uint8,
              f"{label} output {tuple(out.shape)} {out.dtype}")
        check(step <= 1, f"{label} vs enhance staged: {step} <= 1 step")
        print(f"phase 4 {label}: launches {pick(got, ypad)}; vs enhance "
              f"staged {step} step, {int((out != ref).sum())} pixels differ "
              f"[{card}]")

    frames = torch.from_numpy(batch_frames(MORPH_BATCH, SEED + 8)).to(dev)
    f2 = frames.to(torch.float32) * (1.0 / 255.0)
    for label, kernel, op, x, ref, tol in (
            (f"stencil_sharded gaussian r{RG} {MORPH_BATCH} (2, 4)",
             "gaussian_ypadded", stencil_sharded(
                 lambda p: gaussian_ypadded(p, RG, SIGMA), RG, "reflect101",
                 mesh[(2, 4)]), f2, lambda: gaussian(f2, RG, SIGMA), 1e-6),
            (f"stencil_sharded erode r{MORPH_PATH_R} {MORPH_BATCH} (2, 4)",
             "morph_ypadded", stencil_sharded(
                 lambda p: morph_ypadded(p, MORPH_PATH_R, 0), MORPH_PATH_R,
                 "replicate", mesh[(2, 4)]), shard_batch(mesh[(2, 4)], frames),
             lambda: erode(frames, MORPH_PATH_R), 0.0)):
        out, got = drive(label, (kernel,), op, x)
        add(got)
        check(got[kernel] == 8, f"{label}: one {kernel} launch a shard")
        err = max_err(out.gather(), ref())
        check(err <= tol, f"{label} vs unsharded: {err} <= {tol}")
        print(f"phase 4 {label}: launches {pick(got, (kernel,))}; vs the "
              f"unsharded op {err:.3g} [{card}]")

    I, p = guide_pair((h, w), SEED + 9, dev)
    for label, args, ref in (
            (f"guided_filter_sharded r{GF_R} general {h}x{w} (1, 4)",
             (shard_rows(mesh[(1, 4)], I), p),
             lambda: guided_filter(I, p, GF_R, GF_EPS, "reflect101")),
            (f"guided_filter_sharded r{GF_R} self {h}x{w} (1, 4)", (I, I),
             lambda: guided_filter(I, I, GF_R, GF_EPS, "reflect101"))):
        op = guided_filter_sharded(mesh[(1, 4)], GF_R, GF_EPS)
        out, got = drive(label, ("guided_ypadded",), op, *args)
        add(got)
        err = max_err(out.gather(), ref())
        check(err <= 1e-5, f"{label} vs unsharded: {err} <= 1e-5")
        print(f"phase 4 {label}: launches {pick(got, ('guided_ypadded',))};"
              f" vs guided_filter {err:.3g} [{card}]")
    add(run_sharded_large_radius(dev, card, mesh[(1, 4)], I, p))

    frame = torch.from_numpy(make_frame(h, w, SEED + 10)).to(dev)
    stack = torch.from_numpy(batch).to(dev)
    he = ("hist256", "lut_gather")
    for label, expected, op, x, ref in (
            (f"integral_sharded {h}x{w} (1, 4)", ("integral",),
             integral_sharded(mesh[(1, 4)]), frame, integral),
            (f"hist_equalize_sharded {h}x{w} (1, 4)", he,
             hist_equalize_sharded(mesh[(1, 4)]), frame, hist_equalize),
            (f"hist_equalize_sharded {'x'.join(map(str, BATCH))} (4, 2)", he,
             hist_equalize_sharded(mesh[(4, 2)]), stack, hist_equalize),
            (f"clahe_sharded {h}x{w} tiles {TILES} (1, 4)",
             ("clahe_band_map",),
             clahe_sharded(mesh[(1, 4)], CLIP, TILES, TILES), frame,
             lambda v: clahe(v, CLIP, TILES, TILES)),
            (f"clahe_sharded {h + 1}x{w} tiles {TILES} (1, 4)",
             ("clahe_band_map",),
             clahe_sharded(mesh[(1, 4)], CLIP, TILES, TILES),
             torch.from_numpy(make_frame(h + 1, w, SEED + 11)).to(dev),
             lambda v: clahe(v, CLIP, TILES, TILES))):
        out, got = drive(label, expected, op, x)
        add(got)
        out, want = out.gather(), ref(x)
        check(out.shape == want.shape and out.dtype == want.dtype,
              f"{label} shape and dtype")
        diff = int((out.long() - want.long()).abs().max())
        limit = 1 if "clahe" in label else 0
        check(diff <= limit, f"{label} vs unsharded: {diff} <= {limit}")
        print(f"phase 4 {label}: launches {pick(got, expected)}; vs the "
              f"unsharded op {diff} (<= {limit}) [{card}]")
    return total


def run_sharded_large_radius(dev, card: str, mesh, I, p) -> dict:
    """Phase 4 for guided_filter_sharded and enhance_sharded at gf_radius
    GF_R_LARGE (> 16) on 4K over (1, 4), through the row-padded kernel.
    guided_filter and enhance send r > 16 to the plain chain (cumsum
    differences in f32, as tpuimg sends it to XLA), so the sharded guided
    filter is held to the unsharded frame kernel (1e-5) and to that chain
    (1e-3), and enhance_sharded to enhance(impl="staged") (1 step)."""
    r = GF_R_LARGE
    h, w = I.shape
    counts = []
    for label, args, self_g in (
            (f"guided_filter_sharded r{r} general {h}x{w} (1, 4)",
             (shard_rows(mesh, I), p), False),
            (f"guided_filter_sharded r{r} self {h}x{w} (1, 4)", (I, I), True)):
        op = guided_filter_sharded(mesh, r, GF_EPS)
        out, got = drive(label, ("guided_ypadded",), op, *args)
        counts.append(got)
        out = out.gather()
        q = args[1]
        err_k = max_err(out, guided_filter_kernel(I, q, r, GF_EPS,
                                                  self_guided=self_g))
        err_op = max_err(out, guided_filter(I, q, r, GF_EPS, "reflect101"))
        check(err_k <= 1e-5, f"{label} vs the unsharded kernel: {err_k} "
              f"<= 1e-5")
        check(err_op <= 1e-3, f"{label} vs guided_filter's chain: {err_op} "
              f"<= 1e-3")
        print(f"phase 4 {label}: launches {pick(got, ('guided_ypadded',))}; "
              f"vs the unsharded kernel {err_k:.3g}, vs guided_filter (plain "
              f"chain past r16) {err_op:.3g} [{card}]")
    img = torch.from_numpy(make_frame(h, w, SEED + 12)).to(dev)
    label = f"enhance_sharded gf_radius {r} {h}x{w} (1, 4)"
    ypad = ("clahe_band_map", "gaussian_ypadded", "guided_ypadded")
    out, got = drive(label, ypad, enhance_sharded(
        mesh, CLIP, TILES, RG, SIGMA, r, GF_EPS), img)
    counts.append(got)
    out = out.gather()
    ref = enhance(img, CLIP, TILES, RG, SIGMA, r, GF_EPS, "staged")
    step = int((out.int() - ref.int()).abs().max())
    check(out.shape == ref.shape and out.dtype == torch.uint8,
          f"{label} output {tuple(out.shape)} {out.dtype}")
    check(step <= 1, f"{label} vs enhance staged: {step} <= 1 step")
    print(f"phase 4 {label}: launches {pick(got, ypad)}; vs enhance staged "
          f"{step} step, {int((out != ref).sum())} pixels differ [{card}]")
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def pick(got: dict, names) -> dict:
    return {k: got[k] for k in names}


# phase 6: the CLI (python -m tpuimg_torch), colour, metrics, profiling and
# the native frame stream. Each CLI call at 4K, the CLI's defaults: its
# argv and the kernels it must launch.
CLI_RUNS = [
    (["enhance", "--nreps", "5"],
     ("enhance_run", "tile_tables", "clahe_map", "gaussian", "guided")),
    (["gaussian", "3840", "2160", "1", "1.0", "5"], ("gaussian",)),
    (["integral", "--nreps", "5"], ("integral",)),
    (["guided", "--nreps", "5"], ("guided", "guided_twopass")),
    (["morphology", "--radius", "5", "--nreps", "5"], ("morphology",)),
    (["morphology", "--op", "open", "--radius", "15", "--nreps", "5"],
     ("open_close",)),
    (["sweep", "morphology", "--radii", "1,15", "--nreps", "5"],
     ("morphology",)),
]
# the seven autotest families at their default --max-size, two runs of
# seed 0: the kernels they launch, and a res.log line's tolerance (guided:
# 1e-4 on the reflect-101 path, 1e-3 on the shrink and CN1 class paths)
AUTOTESTS = [
    ("integral-autotest", ("integral",), 0.0),
    ("he-autotest", ("he_tables", "lut_gather"), 0.0),
    ("morph-autotest", ("morphology",), 0.0),
    ("clahe-autotest", ("tile_tables", "clahe_map"), 1.0),
    ("gaussian-autotest", ("gaussian",), 1e-5),
    ("guided-autotest", ("guided", "guided_twopass_shrink"), 1e-4),
    ("enhance-autotest", ("enhance_run",), 2.0),
]
AUTOTEST_RUNS = 2
STREAM_FRAMES = 16  # 1920x1080, stream's defaults
FUSED = ("enhance_run",)
# csrc/enhance_tail.cu's two walks in a trace: tail::tail_kernel<FrameSrc,
# ...>
TAIL_KERNEL = ("tail_kernel", "FrameSrc")


def run_cli(argv) -> list:
    """``tpuimg_torch.cli.main(argv)`` in-process on the card; its stdout
    lines. The CLI must return 0 and print no [FAIL] row."""
    from tpuimg_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().splitlines()
    check(rc == 0, f"python -m tpuimg_torch {' '.join(argv)} returned {rc}")
    check(not any("[FAIL]" in line for line in lines),
          f"{' '.join(argv)}: a row failed: {lines}")
    return lines


def drive_cli(card: str, argv, expected, label=None) -> list:
    """One CLI call as a main path: counters reset before, read after,
    every expected kernel launched; each line printed beside the card."""
    label = label or " ".join(argv)
    lines, got = drive(f"cli {label}", expected, run_cli, argv)
    for line in lines:
        print(f"phase 6 cli {label}: {line} [{card}]")
    print(f"phase 6 cli {label}: launches {pick(got, expected)} [{card}]")
    return lines


def cli_ms(lines, name: str) -> float:
    """The ms a CLI report row gives for ``name``."""
    row = next(line for line in lines if line.startswith(name))
    return float(row[len(name):].split("ms")[0])


def probe_io() -> dict:
    """What the IO-dependent commands need: cv2 or PIL (image files),
    and the native loader (g++, -lpng16, -ljpeg)."""
    from tpuimg_torch import native

    have = {}
    for mod in ("cv2", "PIL"):
        try:
            have[mod] = importlib.import_module(mod).__version__
        except ImportError:
            have[mod] = None
    have["g++"] = shutil.which("g++")
    t0 = time.perf_counter()
    try:
        native.load()
        have["loader"] = f"built in {time.perf_counter() - t0:.1f} s"
    except (OSError, native.NativeBuildError) as e:
        lines = str(e).strip().splitlines()
        have["loader"] = None  # the compiler's first error names the cause
        have["loader_error"] = next(
            (line.split(": ", 1)[-1] for line in lines if "error" in line),
            lines[-1])[:200]
    return have


def check_cli_commands(dev, card: str) -> None:
    """Phase 6, the CLI's demos at 4K and its seven autotest families."""
    for argv, expected in CLI_RUNS:
        lines = drive_cli(card, argv, expected)
        if argv[0] == "enhance":
            # the CLI's frame: uniform noise from seed 0 (cli._load_or_random)
            img = torch.from_numpy(np.random.default_rng(0).integers(
                0, 256, (2160, 3840), dtype=np.uint8)).to(dev)
            for impl in ("fused", "fused1", "staged"):
                t = time_cuda(enhance, img, CLIP, TILES, RG, SIGMA, GF_R,
                              GF_EPS, impl, iters=ITERS, card=card)
                print(f"phase 6 enhance[{impl}] 2160x3840: the CLI's row "
                      f"{cli_ms(lines, f'enhance[{impl}]'):.4f} ms (median "
                      f"of 8), events on its frame {t.ms:.4f} ms (min "
                      f"{t.ms_min:.4f}, median of {ITERS}) [{card}]")
    for family, expected, tol in AUTOTESTS:
        if os.path.exists("res.log"):
            os.remove("res.log")
        drive_cli(card, [family, "--runs", str(AUTOTEST_RUNS)], expected)
        with open("res.log") as f:
            logged = f.read().strip().splitlines()
        check(len(logged) == AUTOTEST_RUNS, f"{family}: {logged}")
        for line in logged:
            diff = float(line.rsplit(": ", 1)[1])
            loose = family == "guided-autotest" and (
                "-cn1" in line or "shrink" in line)
            check(diff <= (1e-3 if loose else tol), f"{family}: {line}")


def check_colour_metrics(dev, card: str) -> None:
    """Phase 6, colour on a 4K RGB frame and the metrics, card vs CPU."""
    rgb = torch.from_numpy(np.stack(
        [make_frame(2160, 3840, SEED + 20 + c) for c in range(3)], axis=-1))
    for name, fn, x in (("rgb_to_lab", rgb_to_lab, rgb),
                        ("lab_to_rgb", lab_to_rgb, rgb_to_lab(rgb)),
                        ("rgb_to_gray", rgb_to_gray, rgb)):
        got = fn(x.to(dev)).cpu()
        ref = fn(x)
        check(got.shape == ref.shape and got.dtype == torch.uint8,
              f"{name} {tuple(got.shape)} {got.dtype}")
        steps = int((got.int() - ref.int()).abs().max())
        check(steps <= 1, f"{name} card vs CPU: {steps} <= 1 step")
        print(f"phase 6 colour {name} 2160x3840: card vs CPU {steps} step, "
              f"{int((got != ref).sum())} of {ref.numel()} values differ "
              f"[{card}]")
    rng = np.random.default_rng(SEED + 23)
    a = rng.integers(2**24, 2**30, (2160, 3840)).astype(np.int32)
    b = a + rng.integers(-3, 4, a.shape).astype(np.int32)
    b[1234, 2345] = a[1234, 2345] + 1000
    b[2000, 10] = a[2000, 10] - 1000  # a tie, later in row-major order
    cases = {"int32 above 2^24": (a, b),
             "uint8 0 vs 255": (np.zeros((2160, 3840), np.uint8),
                                np.full((2160, 3840), 255, np.uint8))}
    for label, (x, y) in cases.items():
        d = np.abs(x.astype(np.int64) - y.astype(np.int64))
        i = int(d.argmax())
        want = (int(d.max()), i // x.shape[1], i % x.shape[1])
        tx, ty = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        m = max_abs_diff(tx, ty)
        loc = max_abs_diff_loc(tx, ty)
        check(m.device == tx.device and m.ndim == 0,
              f"max_abs_diff {label}: 0-d on the inputs' device")
        got = tuple(int(t) for t in loc)
        check(int(m) == want[0] and got == want,
              f"max_abs_diff(_loc) {label}: {int(m)}, {got} == {want}")
        print(f"phase 6 metrics {label} 2160x3840: max_abs_diff {int(m)}, "
              f"loc {got[1:]}, equal to NumPy [{card}]")


def check_profiling(dev, card: str, tmp: str) -> None:
    """Phase 6, ``profiling.trace`` around one 4K enhance call: the kernels
    and the program's spans in one Chrome trace."""
    img = torch.from_numpy(make_frame(*SHAPES[0], SEED)).to(dev)
    enhance(img)
    torch.cuda.synchronize()
    for attempt in range(3):  # the profiler drops a trace now and then
        logdir = os.path.join(tmp, f"trace{attempt}")
        with trace(logdir):
            enhance(img)
        (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events
                 if e.get("cat") == "kernel"]
        if names:
            break
    tails = [n for n in names if all(k in n for k in TAIL_KERNEL)]
    check(len(tails) == 2, f"the trace names the enhance tail's two walks: "
          f"{names}")
    spans = [e["name"] for e in events if e.get("cat") == "tpuimg_span"]
    check(spans.count("pipeline.enhance") == 1
          and spans.count("kernels.launch") == 1 and len(names) == 4,
          f"the trace holds one enhance call's spans, one launch of its "
          f"plan's 4 kernels: {spans}, {names}")
    print(f"phase 6 trace enhance 2160x3840: {os.path.basename(path)}, "
          f"{len(names)} kernels, the tail as {tails[0][:60]} and "
          f"{tails[1][:60]}, {len(spans)} "
          f"spans [{card}]")


def check_io_commands(dev, card: str, have: dict, tmp: str) -> None:
    """Phase 6, the commands that read and write image files: he, clahe
    (gray and colour) and morphology --color rgb|lab on PNGs written by
    cv2 or PIL, and stream --op enhance over 16 1080p PNGs through the
    native loader. What the machine lacks is named on one line."""
    from tpuimg_torch import native

    skipped = []
    if have["cv2"] or have["PIL"]:
        from tpuimg_torch.utils import imread_rgb, imwrite

        gray = os.path.join(tmp, "gray.png")
        color = os.path.join(tmp, "color.png")
        imwrite(gray, make_frame(*SHAPES[0], SEED + 24))
        imwrite(color, np.stack([make_frame(1080, 1920, SEED + 25 + c)
                                 for c in range(3)], axis=-1))
        drive_cli(card, ["he", gray, "--nreps", "5"],
                  ("he_tables", "lut_gather"), "he gray 2160x3840")
        drive_cli(card, ["clahe", gray, "--nreps", "5"], ("tile_tables",
                                                         "clahe_map"),
                  "clahe gray 2160x3840")
        drive_cli(card, ["clahe", color, "--nreps", "5"], ("tile_tables",
                                                          "clahe_map"),
                  "clahe colour 1080x1920")
        for form in ("rgb", "lab"):
            drive_cli(card, ["morphology", "--color", form, "--radius", "5",
                             "--src", color], ("morphology",),
                      f"morphology --color {form} 1080x1920")
        rgb = torch.from_numpy(imread_rgb(color)).to(dev)
        want = erode(rgb.permute(2, 0, 1), 5).permute(1, 2, 0).cpu().numpy()
        got = imread_rgb(color.replace(".png", "_morph_erode_rgb.png"))
        check(np.array_equal(got, want), "morphology --color rgb's file "
              "equals erode of the three channels")
    else:
        skipped.append("he, clahe and morphology --color (neither cv2 nor "
                       "PIL is installed to read and write image files)")
    if have["loader"]:
        frames = os.path.join(tmp, "frames")
        out = os.path.join(tmp, "stream_out")
        os.makedirs(frames)
        for i in range(STREAM_FRAMES):
            native.write_png(os.path.join(frames, f"f{i:02d}.png"),
                             make_frame(1080, 1920, SEED + 30 + i))
        lines = drive_cli(card, ["stream", os.path.join(frames, "*.png"),
                                 "--op", "enhance", "--out", out], FUSED,
                          f"stream --op enhance {STREAM_FRAMES}x1920x1080")
        check(any(f"processed {STREAM_FRAMES} frames" in line
                  for line in lines), f"stream: {lines}")
        written = sorted(glob.glob(os.path.join(out, "*.png")))
        check(len(written) == STREAM_FRAMES, f"stream wrote {len(written)}")
        first = torch.from_numpy(make_frame(1080, 1920, SEED + 30)).to(dev)
        check(np.array_equal(native.read_image(written[0]),
                             enhance(first).cpu().numpy()),
              "stream's first frame equals enhance on the card")
    else:
        skipped.append(f"stream (the native loader does not build: "
                       f"{have['loader_error']})")
    if skipped:
        print(f"phase 6 not run: {'; '.join(skipped)}")


def run_phase6(dev, card: str) -> None:
    """Phase 6 in a temporary working directory (the CLI writes res.log,
    sweep JSON and PNGs where it runs)."""
    have = probe_io()
    print("phase 6 probe: " + ", ".join(
        f"{k} {v if v else 'missing'}" for k, v in have.items()
        if k != "loader_error")
        + (f" ({have['loader_error']})" if not have["loader"] else ""))
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        check_cli_commands(dev, card)
        check_colour_metrics(dev, card)
        # a process that has run the phases before this one drops kernel
        # records from a short trace (0 to 36 of a 4K enhance call's 36
        # kernels a trace, and 3 of 8, where a fresh process holds them all;
        # NVIDIA H100 80GB HBM3): the check runs in a fresh one
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--profiling", tmp], check=True)
        check_io_commands(dev, card, have, tmp)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_label()
    print(card)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(kernels.BUILD_DIR.parent.parent)}")
    log = lib.with_suffix(".log")
    for line in log.read_text().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"phase 2 ptxas: {line.strip()}")

    errs = {}
    t0 = time.perf_counter()
    batch = batch_frames(BATCH, SEED + 5)
    check_enhance_kernels(dev, card, errs)
    check_filter_kernels(dev, card, errs)
    check_guided_shrink(dev, card, errs)
    check_he_kernels(dev, card, errs, batch)
    check_integral_kernel(dev, card, errs, batch)
    check_morph_kernels(dev, card, errs)
    check_morph_limits(dev, card, errs)
    check_open_close_limits(dev, card, errs)
    check_tail_clahe_kernel(dev, card, errs)
    check_tail_radii(dev, card, errs)
    check_ypadded_kernels(dev, card, errs)
    check_walker_planted(dev, card, errs)
    check_clahe_grids(dev, card, errs)
    check_hist_cases(dev, card, errs)
    check_tile_hist_lut_cases(dev, card, errs)
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = run_main_paths(dev, card, batch)
    sharded = run_sharded_paths(dev, card, batch)
    launches = {k: launches[k] + sharded[k] for k in launches}
    print(f"phase 4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_phase6(dev, card)
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s")

    rows = [{"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": launches[name], "max_abs_err": errs[name]}
            for name, _, src, tpu in KERNELS]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profiling"]:  # phase 6's profiling check alone
        check_profiling(torch.device("cuda"), card_label(), sys.argv[2])
        sys.exit(0)
    sys.exit(main())
