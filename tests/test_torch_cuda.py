"""tpuimg_torch's CUDA kernels against their plain PyTorch versions, on the
card, over shapes and parameters that chip_smoke.py does not reach: tiny
tiles and frames, unaligned frames and frame bases, batches, other radii and
table dtypes, wrapping sums, the shared-memory limits, the error paths.

Every test needs a CUDA card and skips without one. On the card, run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use and the card's machine need not have).
"""

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpuimg_torch
from tpuimg_torch import kernels
from tpuimg_torch.core.validate import ParamError
from tpuimg_torch.kernels import (
    GAUSS_MAX_RADIUS, GUIDED_SMEM_MAX_RADIUS, MAX_TAPS, TAIL_MAX_RADIUS,
    launch, load)
from tpuimg_torch.kernels.boxsum import (
    INV_255, enhance_tail, enhance_tail_clahe, enhance_tail_clahe_plain,
    enhance_tail_plain, guided_filter_kernel, guided_filter_plain,
    guided_ypadded_kernel, guided_ypadded_plain)
from tpuimg_torch.kernels.hist import (
    he_tables, he_tables_frames, hist256, hist256_frames, hist256_groups,
    hist256_groups_packed, hist256_groups_packed_plain, hist256_groups_plain,
    tile_hist, tile_hist_plain, tile_tables)
from tpuimg_torch.kernels.lut import (
    clahe_band_map, clahe_band_map_plain, clahe_map, clahe_map_plain,
    lut_gather, lut_gather_frames, lut_gather_frames_plain, lut_gather_plain)
from tpuimg_torch.kernels.scan2d import integral_kernel, integral_plain
from tpuimg_torch.kernels.sep_stencil import (
    gaussian_kernel, gaussian_plain, gaussian_ypadded_kernel,
    gaussian_ypadded_plain, morph_max_radius, morph_tile, morph_ypadded_kernel,
    morph_ypadded_plain, morphology_kernel, morphology_plain,
    open_close_kernel, open_close_max_radius, open_close_plain,
    open_close_tile)
from tpuimg_torch.ops.histogram import (
    _blend_to_u8, _clahe_geometry, _clahe_scale, _clahe_tables, _he_tables)
from tpuimg_torch.pipeline import _to_u8, enhance

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frame(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _geometry_and_tables(img, ytiles, xtiles, clip=2.0):
    h, w = img.shape
    th, tw, pt, pl = _clahe_geometry(h, w, xtiles, ytiles)
    hists = tile_hist_plain(img, ytiles, xtiles, th, tw, pt, pl)
    return (th, tw, pt, pl), _clahe_tables(hists, clip, th, tw)


CLAHE_CASES = [((90, 110), (8, 8)), ((257, 511), (3, 5)), ((64, 64), (16, 16)),
               ((33, 1000), (1, 1)), ((2161, 3839), (8, 8))]


@pytest.mark.parametrize("shape,grid", CLAHE_CASES)
def test_tile_hist_exact(card, shape, grid):
    yt, xt = grid
    img = torch.from_numpy(_frame(shape)).to(card)
    geo, _ = _geometry_and_tables(img, yt, xt)
    got = tile_hist(img, yt, xt, *geo)
    assert torch.equal(got, tile_hist_plain(img, yt, xt, *geo))
    assert bool((got.sum(dim=1) == geo[0] * geo[1]).all())


@pytest.mark.parametrize("shape,grid", CLAHE_CASES)
def test_clahe_map_matches_plain(card, shape, grid):
    yt, xt = grid
    img = torch.from_numpy(_frame(shape, 1)).to(card)
    geo, tables = _geometry_and_tables(img, yt, xt)
    for out_f32 in (True, False):
        got = clahe_map(img, tables, yt, xt, *geo, out_f32=out_f32)
        ref = clahe_map_plain(img, tables, yt, xt, *geo, out_f32=out_f32)
        assert got.dtype == ref.dtype
        assert float((got.float() - ref.float()).abs().max()) <= (
            1e-3 if out_f32 else 1.0)


@pytest.mark.parametrize("shape,rg,sigma,r,eps", [
    ((96, 150), 2, 1.5, 8, 1e-3), ((75, 77), 1, 0.8, 1, 1e-2),
    ((200, 131), 3, 2.0, 4, 1e-3), ((150, 170), 2, 1.5, 16, 1e-3),
    ((300, 300), 16, 5.0, 1, 1e-3)])
def test_enhance_tail_matches_plain(card, shape, rg, sigma, r, eps):
    g = np.random.default_rng(2)
    f = torch.from_numpy(g.random(shape, dtype=np.float32)).to(card)
    got = enhance_tail(f, rg, sigma, r, eps)
    ref = enhance_tail_plain(f, rg, sigma, r, eps)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-4


def test_enhance_tail_shared_memory_limit_raises(card):
    """Past the tail's ceilings (gf radius TAIL_MAX_RADIUS, gaussian radius
    MAX_TAPS // 2) both tails raise ParamError before any launch; at them
    they run (the largest on the scratch route)."""
    f = torch.zeros((400, 400), device=card)
    img = torch.from_numpy(_frame((400, 400), 5)).to(card)
    geo, tables = _geometry_and_tables(img, 4, 4)
    tails = ("tpuimg_enhance_tail", "tpuimg_enhance_tail_clahe")
    before = _count(*tails)
    for r, rg in ((TAIL_MAX_RADIUS + 1, 2), (8, MAX_TAPS // 2 + 1)):
        with pytest.raises(ParamError):
            enhance_tail(f, rg, 5.0, r, 1e-3)
        with pytest.raises(ParamError):
            enhance_tail_clahe(img, tables, 4, 4, *geo, rg, 5.0, r, 1e-3)
    assert _count(*tails) == before
    assert load().tpuimg_enhance_tail_shared(MAX_TAPS // 2,
                                             TAIL_MAX_RADIUS) == 0
    got = enhance_tail(f + 0.5, MAX_TAPS // 2, 5.0, TAIL_MAX_RADIUS, 1e-3)
    assert _count(*tails) == (before[0] + 1, before[1])
    assert float((got - 0.5).abs().max()) <= 1e-5


@pytest.mark.parametrize("rg,r", [(0, 1), (2, 8), (16, 16), (2, 44), (2, 45),
                                  (16, 39), (16, 40), (2, 53), (2, 54),
                                  (16, 48), (16, 49), (0, 64), (16, 64)])
def test_enhance_tails_radius_range_unaligned(card, rg, r):
    """Both tails on an unaligned 2161x3839 frame across the radius range,
    either side of walk 1's shared-memory route's ceiling (r 44 / 45 at rg
    2, 39 / 40 at rg 16), at the compile-time gaussian radius (2) and at
    run-time ones: the f32 tail within 1e-4 of its plain version, the fused1
    tail within 5e-6 of it on the card's own blend."""
    frame = _frame((2161, 3839), 6)
    img = torch.from_numpy(frame).to(card)
    geo, tables = _geometry_and_tables(img, 8, 8)
    blend = clahe_map(img, tables, 8, 8, *geo, out_f32=True)
    f = blend * INV_255
    got = enhance_tail(f, rg, 2.0, r, 1e-3)
    assert bool(torch.isfinite(got).all())
    assert float((got - enhance_tail_plain(f, rg, 2.0, r, 1e-3))
                 .abs().max()) <= 1e-4
    fused1 = enhance_tail_clahe(img, tables, 8, 8, *geo, rg, 2.0, r, 1e-3)
    assert float((fused1 - got).abs().max()) <= 5e-6


@pytest.mark.parametrize("shape,tiles,radius,gf_radius", [
    ((270, 480), 8, 2, 8), ((301, 203), 4, 1, 2), ((512, 512), 16, 2, 4)])
def test_enhance_on_card_matches_cpu(card, shape, tiles, radius, gf_radius):
    frame = _frame(shape, 3)
    hist_before = kernels.launches["tpuimg_tile_hist"]
    before = _count(*PLAN_ENTRIES)
    got = enhance(torch.from_numpy(frame).to(card), 2.0, tiles, radius, 1.5,
                  gf_radius, 1e-3)
    assert _count(*PLAN_ENTRIES) == (before[0] + 1, *before[1:])
    assert kernels.launches["tpuimg_tile_hist"] == hist_before
    ref = enhance(torch.from_numpy(frame), 2.0, tiles, radius, 1.5,
                  gf_radius, 1e-3)
    assert got.dtype == torch.uint8 and got.shape == shape
    assert int((got.cpu().int() - ref.int()).abs().max()) <= 1


def test_clahe_on_card_within_one_step_of_cpu(card):
    frame = _frame((300, 420), 4)
    got = tpuimg_torch.clahe(torch.from_numpy(frame).to(card), 3.0, 6, 5)
    ref = tpuimg_torch.clahe(torch.from_numpy(frame), 3.0, 6, 5)
    assert int((got.cpu().int() - ref.int()).abs().max()) <= 1


def _count(*entries):
    """The launches of each C entry so far in this process."""
    return tuple(kernels.launches[e] for e in entries)


# enhance's plan's C call first, then the wrappers' entries it replaces
PLAN_ENTRIES = ("tpuimg_enhance_run", "tpuimg_tile_tables", "tpuimg_clahe_map",
                "tpuimg_enhance_tail", "tpuimg_enhance_tail_clahe")


def _launches():
    return _count("tpuimg_gaussian", "tpuimg_guided_onepass",
                  "tpuimg_guided_twopass")


def test_unported_paths_raise_on_card(card):
    """What raised NotPortedError before the filters were ported now
    launches their kernels: staged enhance, enhance under the tail kernel's
    gate, gaussian and guided_filter."""
    img = torch.from_numpy(_frame((64, 64))).to(card)
    f = img.float() / 255
    small = torch.from_numpy(_frame((30, 40))).to(card)
    for call in (lambda: enhance(img, impl="staged"),
                 lambda: enhance(small),  # 30 <= 2*(2*8 + 2)
                 lambda: tpuimg_torch.gaussian(f, 2, 1.5),
                 lambda: tpuimg_torch.guided_filter(f, f, 4, 1e-3,
                                                    border="reflect101")):
        before = _launches()
        out = call()
        torch.cuda.synchronize()
        after = _launches()
        assert out.is_cuda
        assert after[0] + after[1] > before[0] + before[1]


GAUSS_CASES = [((1, 7), 2), ((2, 5), 2), ((3, 9), 4), ((33, 1), 3),
               ((75, 77), 1), ((200, 131), 7), ((64, 64), 16), ((300, 257), 40),
               ((129, 130), GAUSS_MAX_RADIUS)]


@pytest.mark.parametrize("shape,radius", GAUSS_CASES)
def test_gaussian_matches_plain(card, shape, radius):
    g = np.random.default_rng(5)
    img = torch.from_numpy(g.random(shape, dtype=np.float32)).to(card)
    got = gaussian_kernel(img, radius, 0.3 * radius + 0.8)
    ref = gaussian_plain(img, radius, 0.3 * radius + 0.8)
    assert float((got - ref).abs().max()) <= 1e-5


def test_gaussian_batches_and_promotes(card):
    g = np.random.default_rng(6)
    frames = g.integers(0, 256, (2, 3, 50, 70), dtype=np.uint8)
    u8 = torch.from_numpy(frames).to(card)
    got = tpuimg_torch.gaussian(u8, 2, 1.5)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 50, 70)
    ref = gaussian_plain(u8.float(), 2, 1.5)
    assert float((got - ref).abs().max()) <= 1e-5 * 255
    f64 = u8.double() / 255
    ref = tpuimg_torch.gaussian(f64.cpu(), 2, 1.5)
    got = tpuimg_torch.gaussian(f64, 2, 1.5).cpu()
    assert float((got - ref).abs().max()) <= 1e-5
    strided = (u8.float() / 255)[..., ::2]
    assert not strided.is_contiguous()
    assert torch.equal(tpuimg_torch.gaussian(strided, 1, 1.0),
                       gaussian_kernel(strided.contiguous(), 1, 1.0))


@pytest.mark.parametrize("ypadded", [False, True])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 7, 9, 16, 17, 96])
def test_gaussian_entries_equal_plain(card, ypadded, radius):
    """Both entries, over each route (r 1-4 their own register windows, r
    5-16 the 8 and 16 windows, r 17-96 the tile body), equal their plain
    versions bit for bit."""
    g = np.random.default_rng(radius)
    rows = 77 + (2 * radius if ypadded else 0)
    x = torch.from_numpy(g.random((2, rows, 301), dtype=np.float32)).to(card)
    sigma = 0.3 * radius + 0.8
    if ypadded:
        got = gaussian_ypadded_kernel(x, radius, sigma)
        ref = gaussian_ypadded_plain(x, radius, sigma)
    else:
        got = gaussian_kernel(x, radius, sigma)
        ref = gaussian_plain(x, radius, sigma)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("width", [256, 259, 3839])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_gaussian_unaligned_inputs(card, width, offset):
    """Frames whose base is 4, 8 or 12 bytes past a 16-byte boundary (a
    contiguous slice with a storage offset) and widths that are not a
    multiple of 4 come in by the kernel's 4-byte copies where the 16-byte
    ones do not apply; both entries stay bit-equal to plain and the wrapper
    copies nothing."""
    g = np.random.default_rng(width + offset)
    rows = 70
    buf = torch.from_numpy(g.random(rows * width + 8, dtype=np.float32)).to(
        card)
    x = buf[offset:offset + rows * width].view(rows, width)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    for r in (1, 2, 5):
        assert torch.equal(gaussian_kernel(x, r, 1.5),
                           gaussian_plain(x, r, 1.5))
        assert torch.equal(gaussian_ypadded_kernel(x, r, 1.5),
                           gaussian_ypadded_plain(x, r, 1.5))


def test_gaussian_radius_ceiling_raises(card):
    f = torch.zeros((300, 300), device=card)
    with pytest.raises(ParamError, match="227 KB"):
        gaussian_kernel(f, GAUSS_MAX_RADIUS + 1, 30.0)


GUIDED_CASES = [((6, 40), 8), ((1, 7), 2), ((3, 9), 4), ((75, 77), 1),
                ((200, 131), 4), ((150, 170), 8), ((96, 300), 16),
                ((33, 33), 16)]


@pytest.mark.parametrize("variant", ["onepass", "twopass"])
@pytest.mark.parametrize("shape,radius", GUIDED_CASES)
def test_guided_matches_plain(card, shape, radius, variant):
    g = np.random.default_rng(7)
    I = torch.from_numpy(g.random(shape, dtype=np.float32)).to(card)
    p = torch.clamp(I + 0.1 * torch.from_numpy(
        g.standard_normal(shape).astype(np.float32)).to(card), 0, 1)
    for q, self_guided in ((p, False), (I, True)):
        got = guided_filter_kernel(I, q, radius, 1e-3, variant=variant,
                                   self_guided=self_guided)
        ref = guided_filter_plain(I, q, radius, 1e-3, self_guided)
        assert bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("shape,radius", [((33, 33), 20), ((96, 300), 32),
                                          ((150, 170), 64), ((5, 700), 40)])
def test_guided_onepass_large_radius_matches_plain(card, shape, radius):
    """The frame entry past tpuimg's dispatch ceiling of 16, up to its own
    of GUIDED_MAX_RADIUS["onepass"] = 64."""
    g = np.random.default_rng(radius)
    I = torch.from_numpy(g.random(shape, dtype=np.float32)).to(card)
    p = torch.from_numpy(g.random(shape, dtype=np.float32)).to(card)
    for q, self_guided in ((p, False), (I, True)):
        got = guided_filter_kernel(I, q, radius, 1e-3,
                                   self_guided=self_guided)
        ref = guided_filter_plain(I, q, radius, 1e-3, self_guided)
        assert bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max()) <= 1e-4


def test_guided_self_equals_general_with_p_is_i(card):
    g = np.random.default_rng(8)
    I = torch.from_numpy(g.random((140, 230), dtype=np.float32)).to(card)
    for r in (1, 8, 16):
        self_guided = guided_filter_kernel(I, I, r, 1e-2, self_guided=True)
        general = guided_filter_kernel(I, I.clone(), r, 1e-2)
        assert torch.equal(self_guided, general)


def test_guided_batches_and_cn1_in_one_launch(card):
    g = np.random.default_rng(9)
    I = torch.from_numpy(g.random((2, 60, 90), dtype=np.float32)).to(card)
    p = torch.from_numpy(g.random((3, 2, 60, 90), dtype=np.float32)).to(card)
    before = _launches()
    cn1 = tpuimg_torch.guided_filter(I, p, 4, 1e-3, border="reflect101")
    batch = tpuimg_torch.guided_filter(I, p[0], 4, 1e-3, border="reflect101")
    assert _launches()[1] == before[1] + 2
    assert cn1.shape == (3, 2, 60, 90) and batch.shape == (2, 60, 90)
    ref = guided_filter_plain(I, p, 4, 1e-3)
    assert float((cn1 - ref).abs().max()) <= 1e-4
    assert float((batch - ref[0]).abs().max()) <= 1e-4
    twopass = guided_filter_kernel(I, p, 4, 1e-3, variant="twopass")
    assert float((twopass - ref).abs().max()) <= 1e-4


def test_guided_class_paths_run_plain_on_card(card):
    """radius > 16 is XLA in tpuimg and plain PyTorch here at both borders,
    on the card, within 1e-3 (shrink) / 1e-4 of the CPU run; border="shrink"
    at r <= 16, XLA in tpuimg, launches the twopass kernel's shrink
    instance, within 1e-4 of the CPU run."""
    g = np.random.default_rng(10)
    I = g.random((50, 70), dtype=np.float32)
    p = g.random((50, 70), dtype=np.float32)
    before = _launches()
    shrink = kernels.launches["tpuimg_guided_twopass_shrink"]
    for kwargs, tol in (({}, 1e-3), ({"border": "reflect101"}, 1e-4)):
        got = tpuimg_torch.guided_filter(
            torch.from_numpy(I).to(card), torch.from_numpy(p).to(card), 20,
            1e-3, **kwargs)
        ref = tpuimg_torch.guided_filter(torch.from_numpy(I),
                                         torch.from_numpy(p), 20, 1e-3,
                                         **kwargs)
        assert got.is_cuda
        assert float((got.cpu() - ref).abs().max()) <= tol
    assert _launches() == before
    assert kernels.launches["tpuimg_guided_twopass_shrink"] == shrink
    got = tpuimg_torch.guided_filter(torch.from_numpy(I).to(card),
                                     torch.from_numpy(p).to(card), 6, 1e-3)
    ref = tpuimg_torch.guided_filter(torch.from_numpy(I), torch.from_numpy(p),
                                     6, 1e-3)
    assert float((got.cpu() - ref).abs().max()) <= 1e-4
    assert kernels.launches["tpuimg_guided_twopass_shrink"] == shrink + 1


@pytest.mark.parametrize("shape,impl", [((270, 480), "staged"),
                                        ((2161, 3839), "staged"),
                                        ((32, 48), "fused"), ((8, 8), "fused"),
                                        ((6, 40), "staged")])
def test_enhance_filters_on_card_match_cpu(card, shape, impl):
    frame = _frame(shape, 11)
    before = _launches()
    got = enhance(torch.from_numpy(frame).to(card), impl=impl)
    after = _launches()
    assert after[0] == before[0] + 1 and after[1] == before[1] + 1
    ref = enhance(torch.from_numpy(frame), impl=impl)
    assert got.dtype == torch.uint8 and got.shape == shape
    assert int((got.cpu().int() - ref.int()).abs().max()) <= 1


def test_wrappers_check_their_inputs(card):
    img = torch.from_numpy(_frame((64, 96))).to(card)
    with pytest.raises(ValueError, match="contiguous"):
        tile_hist(img.t(), 4, 4, 24, 16, 0, 0)
    with pytest.raises(ValueError, match="uint8"):
        tile_hist(img.float(), 4, 4, 16, 24, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tile_tables(img.t(), 4, 4, 24, 16, 0, 0, 10, 0.5)
    with pytest.raises(ValueError, match="uint8"):
        tile_tables(img.float(), 4, 4, 16, 24, 0, 0, 10, 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tile_tables(img.cpu(), 4, 4, 16, 24, 0, 0, 10, 0.5)
    with pytest.raises(ValueError, match="reflect-101"):
        tile_tables(img, 4, 4, 16, 20, 0, 0, 10, 0.5)  # 80 of 96 columns
    with pytest.raises(ValueError, match="float32"):
        enhance_tail(img.double(), 2, 1.5, 8, 1e-3)
    with pytest.raises(ValueError, match="tables"):
        clahe_map(img, torch.zeros((3, 256), device=card), 4, 4, 16, 24, 0, 0)
    f = img.float()
    with pytest.raises(ValueError, match="contiguous"):
        gaussian_kernel(f.t(), 2, 1.5)
    with pytest.raises(ValueError, match="float32"):
        gaussian_kernel(img, 2, 1.5)
    with pytest.raises(ValueError, match="at least 2 dims"):
        gaussian_kernel(f[0], 2, 1.5)
    with pytest.raises(ValueError, match="contiguous"):
        guided_filter_kernel(f.t(), f.t(), 4, 1e-3)
    with pytest.raises(ValueError, match="float32"):
        guided_filter_kernel(f, img, 4, 1e-3)
    with pytest.raises(ValueError, match="shape of I"):
        guided_filter_kernel(f, f[:10], 4, 1e-3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        guided_filter_kernel(f, f.cpu(), 4, 1e-3)
    with pytest.raises(ParamError, match="radius <= 64"):
        guided_filter_kernel(f, f, 65, 1e-3)
    with pytest.raises(ParamError, match="radius <= 64"):
        guided_filter_kernel(f, f, 65, 1e-3, variant="twopass")
    with pytest.raises(ParamError, match="variant"):
        guided_filter_kernel(f, f, 4, 1e-3, variant="threepass")


@pytest.mark.parametrize("seed", range(12))
def test_random_shapes_kernels_match_plain(card, seed):
    """autoTestDemo-style fuzzing: a random frame size, tile grid and radii
    per seed, every kernel against its plain version."""
    g = np.random.default_rng(100 + seed)
    r, rg = int(g.integers(1, 9)), int(g.integers(1, 4))
    lo = 2 * (2 * r + rg) + 1
    h, w = (int(v) for v in g.integers(lo, 700, 2))
    img = torch.from_numpy(_frame((h, w), seed)).to(card)
    clip = float(g.uniform(0.5, 8.0))
    tiles = int(g.integers(1, 17))
    while True:  # the reflect-101 validity bound of the tile grid
        try:
            geo, tables = _geometry_and_tables(img, tiles, tiles, clip)
            break
        except ValueError:
            tiles -= 1
    assert torch.equal(tile_hist(img, tiles, tiles, *geo),
                       tile_hist_plain(img, tiles, tiles, *geo))
    blend = clahe_map(img, tables, tiles, tiles, *geo, out_f32=True)
    ref = clahe_map_plain(img, tables, tiles, tiles, *geo, out_f32=True)
    assert float((blend - ref).abs().max()) <= 1e-3
    f = ref * (1.0 / 255.0)
    sigma = float(g.uniform(0.5, 3.0))
    got = enhance_tail(f, rg, sigma, r, 1e-3)
    assert float((got - enhance_tail_plain(f, rg, sigma, r, 1e-3))
                 .abs().max()) <= 1e-4
    # the filters at their own random shapes, any size down to 1x1
    fh, fw = (int(v) for v in g.integers(1, 400, 2))
    f = torch.from_numpy(g.random((fh, fw), dtype=np.float32)).to(card)
    p = torch.from_numpy(g.random((fh, fw), dtype=np.float32)).to(card)
    got = gaussian_kernel(f, rg, sigma)
    assert float((got - gaussian_plain(f, rg, sigma)).abs().max()) <= 1e-5
    for variant in ("onepass", "twopass"):
        got = guided_filter_kernel(f, p, r, 1e-3, variant=variant)
        assert float((got - guided_filter_plain(f, p, r, 1e-3))
                     .abs().max()) <= 1e-4


def _unaligned(shape, offset, seed=0, card=None):
    """A contiguous u8 frame whose base lies ``offset`` bytes past an
    allocation's start, so it is 16-byte aligned only for offset 0."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(_frame((n + offset,), seed)).to(card)
    img = buf[offset:].reshape(shape)
    assert img.is_contiguous() and img.data_ptr() % 16 == offset % 16
    return img


def _he_numpy(frame):
    """rint(min(255, cdf * float32(256 / N))) indexed by the frame."""
    cdf = np.cumsum(np.bincount(frame.ravel(), minlength=256))
    factor = np.float32(256.0 / frame.size)
    table = np.rint(np.minimum(np.float32(255.0),
                               cdf.astype(np.float32) * factor))
    return table.astype(np.uint8)[frame]


def _integral_numpy(frames):
    wide = np.cumsum(np.cumsum(frames.astype(np.int64), axis=-1), axis=-2)
    return wide.astype(np.int32)


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (4, 4), (17, 33),
                                   (90, 110), (2161, 3839)])
def test_hist256_exact(card, shape, offset):
    img = _unaligned(shape, offset, 20, card)
    got = hist256(img)
    assert got.dtype == torch.int32 and got.shape == (256,)
    assert torch.equal(got, hist256_groups_plain(img.reshape(1, -1))[0])
    assert int(got.sum()) == img.numel()


def test_hist256_flat_frames(card):
    """Every atomic of a flat frame goes to one bin."""
    for v in (0, 77, 255):
        img = torch.full((1080, 1920), v, dtype=torch.uint8, device=card)
        got = hist256(img)
        assert int(got[v]) == img.numel() and int(got.sum()) == img.numel()


@pytest.mark.parametrize("shape", [(3, 1081, 1917), (5, 1, 7), (2, 300, 401),
                                   (70000, 1, 3)])
def test_hist256_frames_and_groups_exact(card, shape):
    """Odd frame sizes put every frame's base off alignment; 70000 frames
    are more than one grid dimension holds."""
    frames = torch.from_numpy(_frame(shape, 21)).to(card)
    got = hist256_frames(frames)
    assert torch.equal(got, hist256_groups_plain(frames))
    assert torch.equal(hist256_groups(frames.reshape(shape[0], -1)), got)
    assert bool((got.sum(dim=1) == shape[1] * shape[2]).all())


@pytest.mark.parametrize("shape,offset", [((1, 1), 0), ((6, 256), 1),
                                          ((3, 1001), 2), ((64, 2041), 3),
                                          ((2160, 960), 0), ((70000, 3), 1)])
def test_hist256_groups_packed_exact(card, shape, offset):
    """int32 words of four pixels, bit-exact against the plain version and
    against hist256_groups of the same bytes; ``offset`` words put the
    groups' bases off 16-byte alignment, and bytes >= 128 in the fourth
    place set the words' top bits."""
    g, p4 = shape
    pixels = torch.from_numpy(_frame((g * 4 * p4 + 4 * offset,), 31)).to(card)
    words = pixels.view(torch.int32)[offset:].reshape(g, p4)
    assert words.data_ptr() % 16 == 4 * offset
    before = kernels.launches["tpuimg_hist256_packed"]
    got = hist256_groups_packed(words)
    assert kernels.launches["tpuimg_hist256_packed"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (g, 256)
    assert torch.equal(got, hist256_groups_packed_plain(words))
    assert torch.equal(got, hist256_groups(
        pixels[4 * offset:].reshape(g, 4 * p4).contiguous()))
    assert bool((got.sum(dim=1) == 4 * p4).all())


def _tables(seed):
    """256-entry tables of every kind lut_gather takes: u8; int32 and float32
    from random bits (values > 255, negatives, NaN payloads, -0.0); int16,
    float16 and bool through tpuimg's round trip. The float16 table holds no
    NaN: PyTorch's CUDA float16 -> float32 -> float16 conversions do not keep
    a NaN's payload bits as its CPU ones do."""
    g = np.random.default_rng(seed)
    bits = g.integers(-2 ** 31, 2 ** 31, 256).astype(np.int32)
    f32 = bits.view(np.float32).copy()
    f32[:3] = (-0.0, np.inf, np.nan)
    f32[3] = np.array([0x7FC00123], dtype=np.uint32).view(np.float32)[0]
    with np.errstate(over="ignore"):  # large values become float16 inf
        f16 = np.where(np.isnan(f32), 1.5, f32).astype(np.float16)
    return [g.integers(0, 256, 256, dtype=np.uint8), bits, f32,
            bits.astype(np.int16), f16, g.integers(0, 2, 256).astype(bool)]


def _bits(x):
    return x.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[x.element_size()])


@pytest.mark.parametrize("shape,offset", [((1, 1), 0), ((17, 33), 3),
                                          ((1080, 1920), 0),
                                          ((2161, 3839), 1)])
def test_lut_gather_exact(card, shape, offset):
    img = _unaligned(shape, offset, 22, card)
    for table in _tables(23):
        t = torch.from_numpy(table).to(card)
        got = lut_gather(t, img)
        ref = lut_gather_plain(t, img)
        assert got.dtype == t.dtype and got.shape == shape
        assert torch.equal(_bits(got), _bits(ref))
        assert torch.equal(_bits(got.cpu()),
                           _bits(lut_gather_plain(t.cpu(), img.cpu())))


@pytest.mark.parametrize("shape", [(16, 108, 192), (3, 1081, 1917),
                                   (70000, 1, 3)])
def test_lut_gather_frames_exact(card, shape):
    imgs = torch.from_numpy(_frame(shape, 24)).to(card)
    tables = torch.from_numpy(_frame((shape[0], 256), 25)).to(card)
    got = lut_gather_frames(tables, imgs)
    assert got.dtype == torch.uint8 and got.shape == shape
    assert torch.equal(got, lut_gather_frames_plain(tables, imgs))


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (7, 1), (33, 1000),
                                   (5, 3000), (1100, 33), (2161, 3839),
                                   (2, 3, 40, 50), (70000, 2, 3)])
def test_integral_exact(card, shape):
    frame = _frame(shape, 26)
    got = integral_kernel(torch.from_numpy(frame).to(card))
    assert got.dtype == torch.int32 and got.shape == shape
    assert torch.equal(got, integral_plain(torch.from_numpy(frame).to(card)))
    assert np.array_equal(got.cpu().numpy(), _integral_numpy(frame))


@pytest.mark.parametrize("shape", [(3000, 3000), (4320, 7680)])
def test_integral_wraps(card, shape):
    """An all-255 frame of these sizes passes 2^31: the sums wrap mod 2^32,
    as tpuimg's int32 adds and integral_ref do."""
    frame = np.full(shape, 255, np.uint8)
    got = tpuimg_torch.integral(torch.from_numpy(frame).to(card))
    want = _integral_numpy(frame)
    assert int(want[-1, -1]) < 0
    assert np.array_equal(got.cpu().numpy(), want)


def test_integral_other_dtypes_run_plain_on_card(card):
    g = np.random.default_rng(27)
    before = kernels.launches["tpuimg_integral"]
    for dtype in (np.int8, np.int16, np.uint16, np.int32, bool):
        x = g.integers(-2 ** 31, 2 ** 31, (40, 50)).astype(dtype)
        got = tpuimg_torch.integral(torch.from_numpy(x).to(card))
        assert got.is_cuda and got.dtype == torch.int32
        assert torch.equal(got.cpu(), tpuimg_torch.integral(
            torch.from_numpy(x)))
    assert kernels.launches["tpuimg_integral"] == before


def _he_launches():
    return _count("tpuimg_he_tables", "tpuimg_lut_gather")


@pytest.mark.parametrize("shape", [(1, 1), (16, 32), (270, 480),
                                   (2161, 3839), (2, 3, 40, 50),
                                   (5, 1081, 1917)])
def test_hist_equalize_on_card_matches_numpy(card, shape):
    frame = _frame(shape, 28)
    before = _he_launches()
    got = tpuimg_torch.hist_equalize(torch.from_numpy(frame).to(card))
    assert _he_launches() == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.uint8 and got.shape == shape
    frames = frame.reshape((-1,) + shape[-2:])
    want = np.stack([_he_numpy(f) for f in frames]).reshape(shape)
    assert np.array_equal(got.cpu().numpy(), want)
    assert torch.equal(got.cpu(),
                       tpuimg_torch.hist_equalize(torch.from_numpy(frame)))


@pytest.mark.parametrize("shape", [(16, 1080, 1920), (1080, 1920)])
def test_hist_equalize_spans_its_two_launches(card, shape):
    """A call records one root ``ops.hist_equalize`` with one
    ``kernels.launch`` of each kernel inside its wrapper's span, and counts
    one launch of each C entry; the output is the one recording off gives.
    The tables leave the histogram kernel's launch: no ``he.tables`` glue
    on the card, and no launch of the histogram entry."""
    from tpuimg_torch import profiling

    img = torch.from_numpy(_frame(shape, 31)).to(card)
    off = tpuimg_torch.hist_equalize(img)
    calls = 2
    before = _he_launches()
    hists = kernels.launches["tpuimg_hist256"]
    with profiling.recording() as rec:
        outs = [tpuimg_torch.hist_equalize(img) for _ in range(calls)]
    assert _he_launches() == (before[0] + calls, before[1] + calls)
    assert kernels.launches["tpuimg_hist256"] == hists
    assert all(torch.equal(out, off) for out in outs)
    sp = rec.spans
    roots = [s for s in sp if s.parent is None]
    assert [r.name for r in roots] == ["ops.hist_equalize"] * calls
    names = {s.id: s.name for s in sp}
    for root in roots:
        tree = [s for s in sp if s.root == root.id and s is not root]
        assert [(s.name, names[s.parent], s.layer, s.detail)
                for s in tree] == [
            ("he.hist", "ops.hist_equalize", "entry", None),
            ("kernels.launch", "he.hist", "launch", "tpuimg_he_tables"),
            ("he.map", "ops.hist_equalize", "entry", None),
            ("kernels.launch", "he.map", "launch", "tpuimg_lut_gather")]


def test_hist_equalize_flat_and_8k(card):
    """A flat frame maps to 255 (min before rounding); an 8K frame has more
    than 2^24 pixels, so its cdf rounds on the way to float32."""
    flat = torch.full((2160, 3840), 40, dtype=torch.uint8, device=card)
    assert bool((tpuimg_torch.hist_equalize(flat) == 255).all())
    frame = _frame((4320, 7680), 29) // 3 + 40  # a cdf with odd steps
    got = tpuimg_torch.hist_equalize(torch.from_numpy(frame).to(card))
    assert np.array_equal(got.cpu().numpy(), _he_numpy(frame))


def test_bincount256_and_apply_lut_use_the_kernels(card):
    from tpuimg_torch.ops.histogram import apply_lut, bincount256

    frames = torch.from_numpy(_frame((3, 50, 70), 30)).to(card)
    before = _count("tpuimg_hist256", "tpuimg_lut_gather")
    assert torch.equal(bincount256(frames),
                       hist256_groups_plain(frames.reshape(1, -1))[0])
    assert torch.equal(bincount256(frames, per_leading=True),
                       hist256_groups_plain(frames))
    table = torch.arange(256, dtype=torch.float32, device=card) * 0.5
    got = apply_lut(table, frames)
    assert got.shape == frames.shape and got.dtype == torch.float32
    assert torch.equal(got, frames.float() * 0.5)
    assert _count("tpuimg_hist256", "tpuimg_lut_gather") == (
        before[0] + 2, before[1] + 1)


def test_slice3_wrappers_check_their_inputs(card):
    img = torch.from_numpy(_frame((64, 96))).to(card)
    with pytest.raises(ValueError, match="contiguous"):
        hist256_groups(img.t())
    with pytest.raises(ValueError, match="uint8"):
        hist256_groups(img.int())
    with pytest.raises(ValueError, match="int32"):
        hist256_groups_packed(img)
    with pytest.raises(ValueError, match="contiguous"):
        hist256_groups_packed(img.int().t())
    with pytest.raises(ValueError, match="table must be"):
        lut_gather(torch.zeros(255, device=card), img)
    with pytest.raises(ValueError, match="uint8"):
        lut_gather(torch.zeros(256, device=card), img.float())
    with pytest.raises(ValueError, match="tables"):
        lut_gather_frames(torch.zeros((2, 256), dtype=torch.uint8,
                                      device=card), img[None])
    with pytest.raises(ValueError, match="contiguous"):
        integral_kernel(img.t())
    with pytest.raises(ValueError, match="uint8"):
        integral_kernel(img.int())


@pytest.mark.parametrize("seed", range(8))
def test_random_shapes_he_and_integral(card, seed):
    """autoTestDemo-style: a random frame size and batch per seed, HE and
    the integral against the NumPy formulas."""
    g = np.random.default_rng(200 + seed)
    h, w = (int(v) for v in g.integers(1, 1500, 2))
    b = int(g.integers(1, 4))
    frames = _frame((b, h, w), seed)
    got = tpuimg_torch.hist_equalize(torch.from_numpy(frames).to(card))
    want = np.stack([_he_numpy(f) for f in frames])
    assert np.array_equal(got.cpu().numpy(), want)
    got = tpuimg_torch.integral(torch.from_numpy(frames).to(card))
    assert np.array_equal(got.cpu().numpy(), _integral_numpy(frames))


def _morph_frames(shape, dtype, seed):
    """u8 noise; int32 over its whole range with INT_MIN and INT_MAX
    planted; float32 noise with -0.0 planted often and a few NaNs and
    infinities."""
    g = np.random.default_rng(seed)
    if dtype == "uint8":
        return g.integers(0, 256, shape, dtype=np.uint8)
    if dtype == "int32":
        x = g.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
            np.int32)
        x.flat[::97] = np.iinfo(np.int32).min
        x.flat[7::89] = np.iinfo(np.int32).max
        return x
    x = g.standard_normal(shape).astype(np.float32)
    x.flat[5::101] = -0.0
    # sparse enough that large radii leave most pixels finite
    x.flat[g.integers(0, x.size, 6)] = (np.nan, np.nan, np.inf, np.inf,
                                        -np.inf, np.nan)
    return x


def _same_values(got, ref):
    """Same dtype, shape and values, NaNs in the same places."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.is_floating_point():
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(got), nan)
        got, ref = got[~nan], ref[~nan]
    assert torch.equal(got, ref)


MORPH_CASES = [((1, 1), 3), ((5, 6), 40), ((10, 200), 15), ((33, 1000), 7),
               ((300, 257), 31), ((129, 130), 96), ((250, 260), 97),
               ((400, 300), 200), ((2, 3, 40, 50), 2), ((70, 1), 1)]


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("shape,radius", MORPH_CASES)
def test_morphology_matches_plain(card, shape, radius, dtype):
    x = torch.from_numpy(_morph_frames(shape, dtype, 40)).to(card)
    for mode in (0, 1):
        before = kernels.launches["tpuimg_morphology"]
        got = morphology_kernel(x, radius, mode)
        _same_values(got, morphology_plain(x, radius, mode))
        r = min(radius, max(shape[-2:]) - 1)
        assert kernels.launches["tpuimg_morphology"] == before + 1
        assert (morph_tile(r, x.element_size()) is None) == (
            r > morph_max_radius(x.dtype))


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
def test_morphology_tile_ceiling(card, dtype):
    """One launch at the dtype's tile ceiling (226 u8, 108 int32 and
    float32), the two-launch route one past it, both entries; tiles cut
    by an unaligned frame's edges."""
    x = torch.from_numpy(_morph_frames((250, 261), dtype, 46)).to(card)
    top = morph_max_radius(x.dtype)
    for r in (top, top + 1):
        blk = torch.from_numpy(_morph_frames((5 + 2 * r, 261), dtype,
                                             47)).to(card)
        for mode in (0, 1):
            entries = ("tpuimg_morphology", "tpuimg_morphology_ypadded")
            before = _count(*entries)
            _same_values(morphology_kernel(x, r, mode),
                         morphology_plain(x, r, mode))
            _same_values(morph_ypadded_kernel(blk, r, mode),
                         morph_ypadded_plain(blk, r, mode))
            assert _count(*entries) == (before[0] + 1, before[1] + 1)
            assert (morph_tile(r, x.element_size()) is None) == (r > top)


def test_morph_tile_matches_the_c_planner(card):
    """csrc/morphology.cu's morph_tile, which picks the tile the C entry
    launches, is kernels/sep_stencil.py::morph_tile, which decides the
    route and the scratch."""
    lib = load()
    for size in (1, 4):
        for r in range(0, 260):
            assert lib.tpuimg_morph_tile(r, size) == (morph_tile(r, size)
                                                      or 0)


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("radius", [1, 15, 31, 44])
def test_open_close_equals_two_morphology_launches(card, dtype, radius):
    """open_close.cu, whose window pass now lives in csrc/morph.cuh beside
    the erode/dilate tiles that use it too, equals the composition of two
    morphology launches."""
    x = torch.from_numpy(_morph_frames((2, 301, 517), dtype, 49)).to(card)
    for mode in (0, 1):
        _same_values(open_close_kernel(x, radius, mode),
                     morphology_kernel(morphology_kernel(x, radius, mode),
                                       radius, 1 - mode))


OPEN_CLOSE_CASES = [((1, 1), 3), ((5, 6), 40), ((15, 33), 8),
                    ((97, 201), 15), ((300, 257), 39), ((300, 257), 44),
                    ((260, 250), 45), ((400, 390), 93), ((400, 390), 94),
                    ((200, 230), 60), ((2, 2, 40, 70), 3), ((1, 500), 7),
                    ((500, 1), 7), ((300, 20), 15), ((170, 131), 16)]


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("shape,radius", OPEN_CLOSE_CASES)
def test_open_close_matches_plain(card, shape, radius, dtype):
    """One fused launch up to the dtype's ceiling (93 u8, 44 int32 and
    float32); two morphology launches above it. Frames of one row or
    column, narrower than a tile, and radii whose 2r + 1 divides no line."""
    x = torch.from_numpy(_morph_frames(shape, dtype, 41)).to(card)
    r = min(radius, max(shape[-2:]) - 1)
    fused = open_close_tile(r, x.element_size()) is not None
    assert fused == (r <= open_close_max_radius(x.dtype))
    for mode in (0, 1):
        entries = ("tpuimg_open_close", "tpuimg_morphology")
        before = _count(*entries)
        got = open_close_kernel(x, radius, mode)
        _same_values(got, open_close_plain(x, radius, mode))
        assert _count(*entries) == (before[0] + fused,
                                    before[1] + 2 * (not fused))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_open_close_batch_over_grid_z(card, dtype):
    """More frames than a grid's z extent (65535): the blocks loop over
    frames."""
    x = torch.from_numpy(_morph_frames((65537, 3, 5), dtype, 48)).to(card)
    for mode in (0, 1):
        _same_values(open_close_kernel(x, 2, mode),
                     open_close_plain(x, 2, mode))


@pytest.mark.parametrize("frames", ["scenes", "noise"])
def test_morph_open_4k_pair_matches_the_cell_reference(card, frames):
    """The morph-open-4k-b2 cell's call: ``morph_open`` of a (2, 2160, 3840)
    u8 stack at r 15 equals the cell's plain reference (pooling windows in
    float64) bit for bit, in one launch of open_close.cu and none of
    morphology.cu; a radius past ``open_close_max_radius`` takes two
    morphology launches and equals it too."""
    from bench_torch import harness

    mod = harness.load_module(harness.HERE / "configs"
                              / "morph-open-4k-b2.py")
    if frames == "scenes":
        cfg = {"ring": 1, "batch": 2, "height": 2160, "width": 3840}
        x = mod.make_args(cfg, 2**31 + 5, card)[0][0]
    else:
        x = torch.from_numpy(_frame((2, 2160, 3840), 52)).to(card)
    entries = ("tpuimg_open_close", "tpuimg_morphology")
    for radius, launches in ((15, (1, 0)),
                             (open_close_max_radius(torch.uint8) + 1, (0, 2))):
        before = _count(*entries)
        got = tpuimg_torch.morph_open(x, radius)
        assert _count(*entries) == (before[0] + launches[0],
                                    before[1] + launches[1])
        want = mod.reference({"params": {"radius": radius}}, x, torch.float64)
        assert got.dtype == torch.uint8 and torch.equal(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_random_shapes_morphology_match_plain(card, seed):
    """autoTestDemo-style: a random frame size, batch, dtype and radius per
    seed (either side of both shared-memory ceilings), both kernels
    against their plain versions."""
    g = np.random.default_rng(400 + seed)
    h, w = (int(v) for v in g.integers(1, 700, 2))
    b = int(g.integers(1, 4))
    dtype = ("uint8", "int32", "float32")[seed % 3]
    radius = int(g.integers(1, 130))
    x = torch.from_numpy(_morph_frames((b, h, w), dtype, seed)).to(card)
    for mode in (0, 1):
        _same_values(morphology_kernel(x, radius, mode),
                     morphology_plain(x, radius, mode))
        _same_values(open_close_kernel(x, radius, mode),
                     open_close_plain(x, radius, mode))


def test_morphology_storage_offsets_and_public_ops(card):
    """Frames that start past their storage's first element (u8 at odd
    byte offsets), narrowed dtypes, and the public ops on the card against
    the CPU run."""
    g = np.random.default_rng(42)
    for dtype in ("uint8", "int32", "float32"):
        big = torch.from_numpy(_morph_frames((3, 61, 77), dtype, 43)).to(card)
        x = big.reshape(-1)[5:5 + 2 * 61 * 77].reshape(2, 61, 77)
        assert x.is_contiguous() and x.storage_offset() == 5
        for op in ("erode", "dilate", "morph_open", "morph_close"):
            got = getattr(tpuimg_torch, op)(x, 4)
            _same_values(got.cpu(), getattr(tpuimg_torch, op)(x.cpu(), 4))
    f64 = torch.from_numpy(g.random((30, 40))).to(card)
    got = tpuimg_torch.erode(f64, 2)
    assert got.dtype == torch.float32 and got.is_cuda
    _same_values(got.cpu(), tpuimg_torch.erode(f64.cpu(), 2))
    strided = torch.from_numpy(_frame((40, 60), 44)).to(card)[:, ::2]
    _same_values(tpuimg_torch.dilate(strided, 3),
                 morphology_plain(strided.contiguous(), 3, 1))


def test_morphology_error_paths(card):
    x = torch.zeros((20, 30), dtype=torch.int16, device=card)
    for fn in (morphology_kernel, open_close_kernel):
        with pytest.raises(ValueError, match="uint8 or torch.int32"):
            fn(x, 2, 0)
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.to(torch.uint8).t(), 2, 0)
        with pytest.raises(ParamError, match="mode"):
            fn(x.to(torch.uint8), 2, 3)
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            fn(torch.zeros((4, 4), device="meta"), 2, 0)
    with pytest.raises(tpuimg_torch.core.validate.DTypeError):
        tpuimg_torch.morph_open(x, 2)
    empty = torch.zeros((0, 5, 6), dtype=torch.uint8, device=card)
    assert morphology_kernel(empty, 2, 0).shape == (0, 5, 6)
    assert open_close_kernel(empty, 2, 1).shape == (0, 5, 6)


def _tail_clahe_args(frame, ytiles, xtiles, card):
    img = torch.from_numpy(frame).to(card)
    geo, tables = _geometry_and_tables(img, ytiles, xtiles)
    return img, tables, geo


@pytest.mark.parametrize("shape,grid,rg,r", [
    ((37, 37), (1, 1), 2, 8), ((37, 40), (2, 3), 2, 8), ((150, 200), (4, 4),
                                                        1, 2),
    ((256, 256), (16, 16), 2, 8), ((301, 203), (3, 5), 3, 4),
    ((75, 77), (8, 8), 1, 1)])
def test_enhance_tail_clahe_matches_plain(card, shape, grid, rg, r):
    """Against its plain version within 5e-6 and against the f32 tail on
    the card's own blend, at the tail's gate (37 = 2*(2*8 + 2) + 1) and
    over tile grids from 1x1 to 16x16."""
    yt, xt = grid
    img, tables, geo = _tail_clahe_args(_frame(shape, 45), yt, xt, card)
    got = enhance_tail_clahe(img, tables, yt, xt, *geo, rg, 1.5, r, 1e-3)
    ref = enhance_tail_clahe_plain(img, tables, yt, xt, *geo, rg, 1.5, r,
                                   1e-3)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 5e-6
    blend = clahe_map(img, tables, yt, xt, *geo, out_f32=True)
    tail = enhance_tail(blend * INV_255, rg, 1.5, r, 1e-3)
    assert float((got - tail).abs().max()) <= 5e-6


def test_enhance_tail_clahe_checks_its_inputs(card):
    img, tables, geo = _tail_clahe_args(_frame((64, 96), 46), 4, 4, card)
    with pytest.raises(ValueError, match="tables"):
        enhance_tail_clahe(img, tables[:3], 4, 4, *geo, 2, 1.5, 8, 1e-3)
    with pytest.raises(ValueError, match="uint8"):
        enhance_tail_clahe(img.float(), tables, 4, 4, *geo, 2, 1.5, 8, 1e-3)
    with pytest.raises(ValueError, match="2\\*radius"):
        enhance_tail_clahe(img[:18], tables, 4, 4, *geo, 2, 1.5, 8, 1e-3)
    with pytest.raises(ParamError, match="gaussian radius"):
        enhance_tail_clahe(img, tables, 4, 4, *geo, 17, 5.0, 1, 1e-3)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        enhance_tail_clahe(img, tables.cpu(), 4, 4, *geo, 2, 1.5, 8, 1e-3)


@pytest.mark.parametrize("shape,tiles", [((270, 480), 8), ((37, 60), 2),
                                         ((512, 512), 16), ((301, 203), 4),
                                         ((36, 60), 2)])
def test_enhance_fused1_on_card(card, shape, tiles):
    """Above the gate: the plan's one C call (the tile kernel and the
    CLAHE-fused tail's walks, no clahe_map), the values of impl="fused"; at
    or under it (36 <= 2*(2*8 + 2)) the fused composition, tile_tables and
    clahe_map. Within 1 step of the CPU run."""
    frame = _frame(shape, 47)
    img = torch.from_numpy(frame).to(card)

    def counts():
        return _count("tpuimg_enhance_run", "tpuimg_tile_tables",
                      "tpuimg_clahe_map", "tpuimg_enhance_tail_clahe")

    before = counts()
    got = enhance(img, tiles=tiles, impl="fused1")
    gated = min(shape) > 36
    assert counts() == (before[0] + gated, before[1] + (not gated),
                        before[2] + (not gated), before[3])
    assert got.dtype == torch.uint8 and got.shape == shape
    fused = enhance(img, tiles=tiles)
    assert int((got.int() - fused.int()).abs().max()) <= 1
    cpu = enhance(torch.from_numpy(frame), tiles=tiles, impl="fused1")
    assert int((got.cpu().int() - cpu.int()).abs().max()) <= 1


# --- the row-padded kernels and the sharded path ----------------------------


@pytest.mark.parametrize("out_shape,radius", [
    ((1, 7), 1), ((1, 3840), 2), ((37, 1000), 2), ((2, 70, 129), 7),
    ((3, 40, 33), 4), ((64, 64), GAUSS_MAX_RADIUS)])
def test_gaussian_ypadded_matches_plain(card, out_shape, radius):
    *lead, h, w = out_shape
    shape = (*lead, h + 2 * radius, w)
    p = torch.from_numpy(np.random.default_rng(h + w).random(
        shape, dtype=np.float32)).to(card)
    got = gaussian_ypadded_kernel(p, radius, 1.5)
    assert got.shape == out_shape
    ref = gaussian_ypadded_plain(p, radius, 1.5)
    assert float((got - ref).abs().max()) <= 1e-5


YPAD_MORPH_CASES = [((1, 1), 3), ((5, 6), 40), ((10, 200), 15),
                    ((33, 1000), 7), ((2, 3, 40, 50), 2), ((20, 130), 96),
                    ((7, 300), 100), ((3, 129), 120)]


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("out_shape,radius", YPAD_MORPH_CASES)
def test_morph_ypadded_matches_plain(card, out_shape, radius, dtype):
    *lead, h, w = out_shape
    x = torch.from_numpy(_morph_frames((*lead, h + 2 * radius, w), dtype,
                                       41)).to(card)
    for mode in (0, 1):
        before = kernels.launches["tpuimg_morphology_ypadded"]
        got = morph_ypadded_kernel(x, radius, mode)
        assert got.shape == out_shape
        _same_values(got, morph_ypadded_plain(x, radius, mode))
        assert kernels.launches["tpuimg_morphology_ypadded"] == before + 1
        assert (morph_tile(radius, x.element_size()) is None) == (
            radius > morph_max_radius(x.dtype))


@pytest.mark.parametrize("out_shape,radius", [
    ((1, 40), 8), ((6, 40), 8), ((37, 1000), 1), ((2, 70, 129), 4),
    ((64, 300), 16), ((1, 200), 20), ((40, 250), 32), ((9, 130), 64),
    ((3, 100), 80)])
@pytest.mark.parametrize("self_guided", [False, True])
def test_guided_ypadded_matches_plain(card, out_shape, radius, self_guided):
    """r 80 takes the scratch route (past GUIDED_SMEM_MAX_RADIUS)."""
    *lead, h, w = out_shape
    g = np.random.default_rng(h * w)
    shape = (*lead, h + 4 * radius, w)
    I = torch.from_numpy(g.random(shape, dtype=np.float32)).to(card)
    p = torch.from_numpy(g.random(shape, dtype=np.float32)).to(card)
    before = kernels.launches["tpuimg_guided_onepass_ypadded_scratch"]
    got = guided_ypadded_kernel(I, p, radius, 1e-3, self_guided)
    ref = guided_ypadded_plain(I, p, radius, 1e-3, self_guided)
    assert got.shape == out_shape and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-4
    assert kernels.launches["tpuimg_guided_onepass_ypadded_scratch"] - (
        before) == (radius > GUIDED_SMEM_MAX_RADIUS)


@pytest.mark.parametrize("self_guided", [False, True])
def test_guided_ypadded_scratch_route_equals_shared(card, self_guided):
    """The scratch route is the shared-memory route's arithmetic with the
    workspace in device memory: the same bits at a radius both take."""
    g = np.random.default_rng(12)
    r, h, w = 8, 300, 333
    I = torch.from_numpy(g.random((h + 4 * r, w), dtype=np.float32)).to(card)
    p = I if self_guided else torch.from_numpy(
        g.random((h + 4 * r, w), dtype=np.float32)).to(card)
    want = guided_ypadded_kernel(I, p, r, 1e-3, self_guided)
    floats = load().tpuimg_guided_onepass_scratch_floats(1, h, w, r,
                                                         int(self_guided))
    scratch = torch.empty(floats, dtype=torch.float32, device=card)
    got = torch.empty_like(want)
    launch("tpuimg_guided_onepass_ypadded_scratch", card, I.data_ptr(), 1,
           p.data_ptr(), 1, h, w, r, 1e-3, int(self_guided),
           scratch.data_ptr(), got.data_ptr())
    assert torch.equal(got, want)


def test_guided_ypadded_cn1(card):
    # C channels of p guided by one I, in one launch
    g = np.random.default_rng(5)
    I = torch.from_numpy(g.random((2, 50, 90), dtype=np.float32)).to(card)
    p = torch.from_numpy(g.random((3, 2, 50, 90), dtype=np.float32)).to(card)
    got = guided_ypadded_kernel(I, p, 4, 1e-3)
    assert got.shape == (3, 2, 34, 90)
    ref = guided_ypadded_plain(I, p, 4, 1e-3)
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("shape,grid", CLAHE_CASES)
def test_clahe_band_map_matches_plain(card, shape, grid):
    yt, xt = grid
    img = torch.from_numpy(_frame(shape, 2)).to(card)
    geo, tables = _geometry_and_tables(img, yt, xt)
    h = shape[0]
    full = clahe_map(img, tables, yt, xt, *geo, out_f32=True)
    for y0, y1 in ((0, h), (h // 3, h // 3 + max(1, h // 4)), (h - 1, h)):
        band = img[y0:y1]
        for out_f32 in (True, False):
            got = clahe_band_map(band, tables, yt, xt, *geo, y0,
                                 out_f32=out_f32)
            ref = clahe_band_map_plain(band, tables, yt, xt, *geo, y0,
                                       out_f32=out_f32)
            diff = float((got.float() - ref.float()).abs().max())
            assert diff <= (1e-3 if out_f32 else 1)
        assert torch.equal(clahe_band_map(band, tables, yt, xt, *geo, y0,
                                          out_f32=True), full[y0:y1])


def test_ypadded_wrappers_check_their_inputs(card):
    f = torch.zeros((40, 30), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        gaussian_ypadded_kernel(f.t(), 2, 1.5)
    with pytest.raises(ValueError, match="float32"):
        gaussian_ypadded_kernel(f.double(), 2, 1.5)
    with pytest.raises(ValueError, match="shape of I"):
        guided_ypadded_kernel(f, torch.zeros((41, 30), device=card), 2, 1e-3)
    with pytest.raises(ParamError, match="mode"):
        morph_ypadded_kernel(f, 2, 2)
    img = torch.from_numpy(_frame((64, 80))).to(card)
    geo, tables = _geometry_and_tables(img, 4, 4)
    with pytest.raises(ValueError, match="does not cover rows"):
        clahe_band_map(img[:10], tables, 4, 4, *geo, 60)
    with pytest.raises(ValueError, match="does not cover rows"):
        clahe_band_map(img[:10], tables, 4, 4, *geo, -1)
    assert morph_ypadded_kernel(torch.zeros((0, 9, 5), dtype=torch.uint8,
                                            device=card), 2, 0).shape == (
        0, 5, 5)


def _mesh(card, n_data, n_sp):
    from tpuimg_torch.parallel import make_mesh
    return make_mesh(n_data, n_sp, devices=[card] * (n_data * n_sp))


def test_sharded_paths_on_card(card, monkeypatch):
    """The sharded ops on a mesh of the card repeated against the unsharded
    ops on the card, through the row-padded kernels."""
    import functools

    from tpuimg_torch import parallel as tpar
    from tpuimg_torch.kernels import lut
    from tpuimg_torch.ops.gaussian import gaussian_ypadded
    from tpuimg_torch.ops.morphology import morph_ypadded

    mesh = _mesh(card, 1, 4)
    img = torch.from_numpy(_frame((270, 480), 6)).to(card)
    entries = ("tpuimg_gaussian_ypadded", "tpuimg_guided_onepass_ypadded")
    counts = _count(*entries)
    bands = []

    def band_map(*args, **kwargs):
        bands.append(args[0].shape)
        return clahe_band_map(*args, **kwargs)

    monkeypatch.setattr(lut, "clahe_band_map", band_map)
    for frame in (img, img[:269].contiguous()):
        out = tpar.enhance_sharded(mesh, 2.0, 8, 2, 1.5, 8, 1e-3)(frame)
        ref = tpuimg_torch.enhance(frame, 2.0, 8, 2, 1.5, 8, 1e-3,
                                   impl="staged")
        got = out.gather()
        assert got.is_cuda and got.shape == ref.shape
        assert int((got.int() - ref.int()).abs().max()) <= 1
    assert _count(*entries) == tuple(c + 8 for c in counts)
    assert len(bands) == 8  # clahe_band_map, once a shard
    mesh24 = _mesh(card, 2, 4)
    frames = torch.from_numpy(_frame((2, 64, 96), 7)).to(card)
    er = tpar.stencil_sharded(functools.partial(
        morph_ypadded, radius=5, mode=0), 5, "replicate", mesh24)(
        tpar.shard_batch(mesh24, frames))
    assert torch.equal(er.gather(), tpuimg_torch.erode(frames, 5))
    f = frames.float() / 255
    ga = tpar.stencil_sharded(functools.partial(
        gaussian_ypadded, radius=3, sigma=1.2), 3, "reflect101", mesh24)(f)
    assert float((ga.gather() - tpuimg_torch.gaussian(f, 3, 1.2)).abs()
                 .max()) <= 1e-6
    assert torch.equal(tpar.integral_sharded(mesh)(img[:268]).gather(),
                       tpuimg_torch.integral(img[:268]))
    assert torch.equal(tpar.hist_equalize_sharded(mesh24)(frames).gather(),
                       tpuimg_torch.hist_equalize(frames))
    cl = tpar.clahe_sharded(mesh, 3.0, 6, 5)(img[:269])
    assert int((cl.gather().int() - tpuimg_torch.clahe(
        img[:269], 3.0, 6, 5).int()).abs().max()) <= 1
    # 16 rows a shard cover r = 7's reach of 14 rows (+ 1 for reflect-101)
    q = tpar.guided_filter_sharded(mesh, 7, 1e-3, self_guided=True)(f[0])
    assert float((q.gather() - tpuimg_torch.guided_filter(
        f[0], f[0], 7, 1e-3, "reflect101")).abs().max()) <= 1e-5


def test_numpy_input_lands_on_the_card(card):
    """A NumPy frame, what tpuimg's users pass, runs on the card."""
    from tpuimg_torch.core.params import carry_enhance_state
    from tpuimg_torch.ops.histogram import _clahe_front

    a = _frame((64, 96), 8)
    f = a.astype(np.float32) / 255
    for out in (tpuimg_torch.enhance(a), tpuimg_torch.hist_equalize(a),
                tpuimg_torch.integral(a), tpuimg_torch.erode(a, 2),
                tpuimg_torch.clahe(a), tpuimg_torch.gaussian(f, 2, 1.5),
                tpuimg_torch.guided_filter(f, f, 2, 1e-3)):
        assert out.is_cuda
    tables, th, tw, pt, pl = _clahe_front(torch.from_numpy(a), 2.0, 8, 8)
    st = carry_enhance_state(tables.numpy(), th, tw, pt, pl, h=64, w=96)
    assert st.tables.is_cuda


# ---- the band scan (integral.cu) and the twopass walks (guided.cu) --------

# frames that end one row short of the shortest band (8 rows), on one, one
# row past one and five rows into a fourth, and the same around 16 rows;
# one column, a partial 4-column run, one past a 2048-column chunk; 8K; a
# batch of 1080p frames; bands held to 256 rows
INTEGRAL_BANDS = [(7, 17), (8, 3), (9, 1), (29, 4099), (15, 17), (16, 3),
                  (17, 1), (53, 4099), (1, 4099), (4099, 1), (4320, 7680),
                  (16, 1080, 1920), (3, 53, 17), (40000, 100)]


@pytest.mark.parametrize("shape", INTEGRAL_BANDS)
def test_integral_band_scan_exact(card, shape):
    frame = _frame(shape, 31)
    before = kernels.launches["tpuimg_integral"]
    got = integral_kernel(torch.from_numpy(frame).to(card))
    assert kernels.launches["tpuimg_integral"] == before + 1
    assert got.dtype == torch.int32 and got.shape == shape
    assert torch.equal(got, integral_plain(torch.from_numpy(frame).to(card)))
    assert np.array_equal(got.cpu().numpy(), _integral_numpy(frame))


@pytest.mark.parametrize("offset", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("shape", [(2160, 3840), (37, 1000)])
def test_integral_storage_offsets(card, shape, offset):
    """A contiguous slice that starts ``offset`` bytes into its storage:
    4-byte loads only where the base and the rows are 4-byte aligned."""
    img = _unaligned(shape, offset, 32, card)
    want = _integral_numpy(img.cpu().numpy())
    assert np.array_equal(integral_kernel(img).cpu().numpy(), want)


def test_integral_calls_back_to_back_and_on_two_streams(card):
    """Nothing of one call lingers in the next: calls on different frames
    back to back, then interleaved on two streams."""
    frames = [torch.from_numpy(_frame(s, 33 + i)).to(card)
              for i, s in enumerate([(2160, 3840), (1080, 1920), (2160, 3840),
                                     (53, 4099)])]
    outs = [integral_kernel(x) for x in frames]
    for x, out in zip(frames, outs):
        assert torch.equal(out, integral_plain(x))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for s, x in zip(streams, frames[:2]):
            with torch.cuda.stream(s):
                outs.append((x, integral_kernel(x)))
    torch.cuda.synchronize()
    for x, out in outs:
        assert torch.equal(out, integral_plain(x))


def test_integral_sharded_4k_over_four(card):
    from tpuimg_torch import parallel as tpar

    img = torch.from_numpy(_frame((2160, 3840), 34)).to(card)
    got = tpar.integral_sharded(_mesh(card, 1, 4))(img).gather()
    assert torch.equal(got, integral_plain(img))


def test_integral_all_255_3000_wraps_once_per_call(card):
    frame = torch.full((3000, 3000), 255, dtype=torch.uint8, device=card)
    for _ in range(2):
        got = integral_kernel(frame)
        assert int(got[-1, -1]) == -1999967296
        assert torch.equal(got, integral_plain(frame))


@pytest.mark.parametrize("radius", [1, 8, 16, 17, 32, 64])
def test_twopass_radii_match_plain(card, radius):
    """twopass up to its ceiling of 64 (the tile kernel it replaced took 16),
    on a batch and in the CN1 form (one guide for 2 channels)."""
    g = np.random.default_rng(40 + radius)
    I = torch.from_numpy(g.random((2, 150, 300), dtype=np.float32)).to(card)
    p = torch.from_numpy(g.random((2, 2, 150, 300),
                                  dtype=np.float32)).to(card)
    before = kernels.launches["tpuimg_guided_twopass"]
    for q in (p[0], p):
        got = guided_filter_kernel(I, q, radius, 1e-3, variant="twopass")
        assert got.shape == q.shape and bool(torch.isfinite(got).all())
        ref = guided_filter_plain(I, q, radius, 1e-3)
        assert float((got - ref).abs().max()) <= 1e-4
    assert kernels.launches["tpuimg_guided_twopass"] == before + 2


@pytest.mark.parametrize("shape,radius", [((1, 1), 1), ((1, 7), 2),
                                          ((3, 9), 4), ((6, 40), 17),
                                          ((5, 700), 64), ((700, 3), 32),
                                          ((130, 129), 64)])
def test_twopass_small_frames_match_plain(card, shape, radius):
    """Frames narrower or shorter than the halo, through the iterated
    reflect-101 map, and frames just past one 128-column strip."""
    g = np.random.default_rng(50 + radius)
    I = torch.from_numpy(g.random(shape, dtype=np.float32)).to(card)
    p = torch.from_numpy(g.random(shape, dtype=np.float32)).to(card)
    got = guided_filter_kernel(I, p, radius, 1e-3, variant="twopass")
    assert bool(torch.isfinite(got).all())
    ref = guided_filter_plain(I, p, radius, 1e-3)
    assert float((got - ref).abs().max()) <= 1e-4


def _rgb_shrink_reference(I, p, radius, eps=1e-3):
    """The rgb shrink cell's plain float64 reference (bench_torch)."""
    from bench_torch import harness

    mod = harness.load_module(
        harness.HERE / "configs" / "guided-rgb-shrink-4k.py")
    cfg = {"params": {"radius": radius, "eps": eps}}
    return mod.reference(cfg, I, p, torch.float64)


def _shrink_both(I, p, radius, self_guided=False):
    """The shrink kernel's q, checked against its plain version and the
    float64 reference within 1e-4, and one C call of it counted."""
    before = kernels.launches["tpuimg_guided_twopass_shrink"]
    got = guided_filter_kernel(I, p, radius, 1e-3, self_guided=self_guided,
                               border="shrink")
    assert kernels.launches["tpuimg_guided_twopass_shrink"] == before + 1
    assert got.shape == p.shape and bool(torch.isfinite(got).all())
    plain = guided_filter_plain(I, p, radius, 1e-3, self_guided, "shrink")
    assert float((got - plain).abs().max()) <= 1e-4
    ref = _rgb_shrink_reference(I, p, radius)
    assert float((got.double() - ref).abs().max()) <= 1e-4
    return got


def _rgb_pair(g, shape, channels=3):
    p = np.clip(g.random(shape, dtype=np.float32)[None]
                + 0.1 * g.standard_normal((channels,) + shape), 0,
                1).astype(np.float32)
    I = (0.299 * p[0] + 0.587 * p[1] + 0.114 * p[2]).astype(np.float32)
    return I, p


def test_shrink_4k_rgb_by_gray_runs_two_kernels_and_no_torch_kernel(card):
    """The rgb shrink cell's call, tpuimg_torch.guided_filter(I, p, 15,
    1e-3) at the default border on a 4K luma and its 3-channel source: one C
    call, whose two kernels (the twopass walks' shrink instance) are all the
    device work, within 1e-4 of the plain version and the float64
    reference."""
    I, p = (torch.from_numpy(x).to(card)
            for x in _rgb_pair(np.random.default_rng(60), (2160, 3840)))
    before = kernels.launches["tpuimg_guided_twopass_shrink"]
    got = tpuimg_torch.guided_filter(I, p, 15, 1e-3)
    assert kernels.launches["tpuimg_guided_twopass_shrink"] == before + 1
    plain = guided_filter_plain(I, p, 15, 1e-3, border="shrink")
    assert float((got - plain).abs().max()) <= 1e-4
    ref = _rgb_shrink_reference(I, p, 15)
    assert float((got.double() - ref).abs().max()) <= 1e-4
    del plain, ref
    # a walk a plane either way: the 3 channels' segments spread over
    # several waves, a channel's alone over one
    ones = torch.stack([tpuimg_torch.guided_filter(I, pc.contiguous(), 15,
                                                   1e-3) for pc in p])
    assert float((got - ones).abs().max()) <= 1e-5
    assert _queued_by(tpuimg_torch.guided_filter, I, p, 15,
                      1e-3) == ["launch"] * 2
    names = _kernels_in_a_fresh_process(
        "p = torch.rand((3, 2160, 3840), device=card)\n"
        "I = (0.299 * p[0] + 0.587 * p[1] + 0.114 * p[2]).contiguous()",
        "tpuimg_torch.guided_filter(I, p, 15, 1e-3)")
    assert len(names) == 2, names
    assert all("guided_twopass_kernel" in n for n in names), names


@pytest.mark.parametrize("width", [7, 1917, 3839])
def test_shrink_widths_match_plain_and_reference(card, width):
    """Widths inside one 128-column strip, unaligned across many, and one
    short of 4K, general and CN1, r 15."""
    g = np.random.default_rng(61 + width)
    I, p = (torch.from_numpy(x).to(card) for x in _rgb_pair(g, (96, width)))
    _shrink_both(I, p, 15)
    _shrink_both(I, p[1].contiguous(), 15)


@pytest.mark.parametrize("shape,radius", [((1, 1), 1), ((5, 7), 15),
                                          ((30, 200), 15), ((300, 31), 16),
                                          ((7, 5), 64), ((40, 3), 8)])
def test_shrink_small_frames_match_plain_and_reference(card, shape, radius):
    """Frames with min(H, W) <= 2r: windows clamped at both ends; general,
    self-guided and CN1."""
    g = np.random.default_rng(70 + radius)
    I, p = (torch.from_numpy(x).to(card) for x in _rgb_pair(g, shape))
    _shrink_both(I, p, radius)
    _shrink_both(I, I, radius, self_guided=True)
    _shrink_both(I, p[0].contiguous(), radius)


def test_shrink_batched_guides_match_plain_and_reference(card):
    """A batch of guides, each with its own sources: I (2, H, W) and p (2,
    H, W) or (3, 2, H, W)."""
    g = np.random.default_rng(80)
    I = torch.from_numpy(g.random((2, 150, 300), dtype=np.float32)).to(card)
    p = torch.from_numpy(g.random((3, 2, 150, 300),
                                  dtype=np.float32)).to(card)
    for q in (p[0], p):
        got = _shrink_both(I, q, 15)
        one = guided_filter_kernel(I[1], q[..., 1, :, :].contiguous(), 15,
                                   1e-3, border="shrink")
        assert float((got[..., 1, :, :] - one).abs().max()) <= 1e-5


# the guided kernels' contract with their plain chain, by border
_CONTRACT = {"reflect101": 1e-4, "shrink": 1e-3}


def _channels(g, shape, channels):
    """A guide and ``channels`` noisy copies of it as p, on the CPU."""
    I = g.random(shape, dtype=np.float32)
    p = np.clip(I + 0.1 * g.standard_normal((channels,) + shape), 0,
                1).astype(np.float32)
    return torch.from_numpy(I), torch.from_numpy(p)


def _one_call_and_a_call_a_channel(I, p, radius, border):
    """The twopass kernel's q of p's channels in one call and in one call a
    channel."""
    got = guided_filter_kernel(I, p, radius, 1e-3, variant="twopass",
                               border=border)
    ones = [guided_filter_kernel(I, pc.contiguous(), radius, 1e-3,
                                 variant="twopass", border=border)
            for pc in p]
    return got, torch.stack(ones)


@pytest.mark.parametrize("radius", [1, 15, 16, 17, 64])
@pytest.mark.parametrize("width", [7, 1917, 3839])
@pytest.mark.parametrize("channels", [2, 3, 4, 5])
@pytest.mark.parametrize("border", ["shrink", "reflect101"])
def test_twopass_channels_match_separate_calls(card, border, channels,
                                               width, radius):
    """One call of C channels by one guide equals C calls of one channel
    each: within 1e-5 at 600 rows, where the call's segments may spread
    over more waves than a channel's alone and so start at other rows, bit
    for bit on frames one segment high (30 rows); and within the border's
    contract of the plain chain: 1e-4 at reflect-101, 1e-3 at the shrink
    border (the reference's class path; at r 1 the walks read up to 1.3e-4
    there, a 2x2 to 3x3 window's variance in f32). r 17 and 64 take the
    row-buffer route, the others the ring."""
    g = np.random.default_rng(90 + 7 * channels + radius)
    for rows in (600, 30):
        I, p = (x.to(card) for x in _channels(g, (rows, width), channels))
        got, ones = _one_call_and_a_call_a_channel(I, p, radius, border)
        assert got.shape == p.shape and bool(torch.isfinite(got).all())
        if rows == 30:
            assert torch.equal(got, ones)
        else:
            assert float((got - ones).abs().max()) <= 1e-5
        plain = guided_filter_plain(I, p, radius, 1e-3, border=border)
        assert float((got - plain).abs().max()) <= _CONTRACT[border]


@pytest.mark.parametrize("radius", [1, 15, 17])
@pytest.mark.parametrize("border", ["shrink", "reflect101"])
def test_twopass_batched_guides_match_separate_calls(card, border, radius):
    """A batch of guides, each with 3 channels: I (2, H, W), p (3, 2, H,
    W), channel c of guide j in p[c, j]; one call equals a call a channel
    of both guides within 1e-5, and the plain chain within the border's
    contract."""
    g = np.random.default_rng(100 + radius)
    I, p = (x.to(card) for x in _channels(g, (2, 150, 300), 3))
    got, ones = _one_call_and_a_call_a_channel(I, p, radius, border)
    assert float((got - ones).abs().max()) <= 1e-5
    plain = guided_filter_plain(I, p, radius, 1e-3, border=border)
    assert float((got - plain).abs().max()) <= _CONTRACT[border]


def test_twopass_refuses_past_its_ceiling(card):
    f = torch.from_numpy(_frame((64, 96))).to(card).float() / 255
    before = kernels.launches["tpuimg_guided_twopass"]
    with pytest.raises(ParamError, match="radius <= 64"):
        guided_filter_kernel(f, f, 65, 1e-3, variant="twopass")
    assert kernels.launches["tpuimg_guided_twopass"] == before


def _walker_cases(card):
    """The guided walker's kernels (walker.cuh) and the tails' two strip
    walks (enhance_tail.cuh), on seeded inputs: (label, call)."""
    g = np.random.default_rng(60)
    I = torch.from_numpy(g.random((300, 517), dtype=np.float32)).to(card)
    p = torch.from_numpy(g.random((300, 517), dtype=np.float32)).to(card)
    img = torch.from_numpy(_frame((300, 517), 61)).to(card)
    geo, tables = _geometry_and_tables(img, 4, 4)
    return [
        ("onepass general r8", lambda: guided_filter_kernel(I, p, 8, 1e-3)),
        ("onepass self r5", lambda: guided_filter_kernel(
            I, I, 5, 1e-3, self_guided=True)),
        ("guided_ypadded general r8", lambda: guided_ypadded_kernel(
            I, p, 8, 1e-3)),
        ("guided_ypadded self r65 (scratch route)",
         lambda: guided_ypadded_kernel(I[:, :200].contiguous(),
                                       I[:, :200].contiguous(), 65, 1e-3,
                                       self_guided=True)),
        ("enhance_tail rg2 r8", lambda: enhance_tail(I, 2, 1.5, 8, 1e-3)),
        ("enhance_tail_clahe rg2 r8", lambda: enhance_tail_clahe(
            img, tables, 4, 4, *geo, 2, 1.5, 8, 1e-3)),
    ]


# SHA-256 of each output's bytes (NVIDIA H100 80GB HBM3): the self-guided
# entries' from the kernels before the twopass redesign moved the walker's
# grid planning; the general entries' from the walker whose running sums are
# rebuilt where a term much larger than the sum leaves it (p independent of
# I makes signed window sums of a that nearly cancel, and a few of them are
# now summed directly); the tails' from their two strip walks, whose f32
# sums along the rows run in 16- and 8-column parts of 128-column strips
WALKER_DIGESTS = {
    "onepass general r8":
        "00ce25e51eceb6acc1838731aa182dbfb3c0965bb5471fa8618e3f30058ea2c8",
    "onepass self r5":
        "3a4e1929de1a82da6eb572f3a89db4d94e59222b60b25fa6fa90a7b0b445103e",
    "guided_ypadded general r8":
        "21bf509cfd8f5214469b7724a565be347c882947a3e151f451abd812af3b2ccf",
    "guided_ypadded self r65 (scratch route)":
        "0e456b5d0434c35ec7ecf7215b7ae6b9eff12793637ea89953c48e1032332a09",
    "enhance_tail rg2 r8":
        "747546e1c7f5efbd7213f03dc4f0da7cb0e6ca1587c82911367c5383627d3f7d",
    "enhance_tail_clahe rg2 r8":
        "682087e3bce545f5e92d9ad297a11341de21718b8e580bdcc22eb2dfb73519a2",
}


def test_walker_outputs_match_recorded_digests(card):
    """The onepass entries and both tails give their recorded bits: the
    self-guided entries as before the twopass walk came to share the
    walker's grid planning and before the repair of its running sums, the
    tails as their two strip walks sum."""
    import hashlib

    for label, call in _walker_cases(card):
        out = call().contiguous().cpu().numpy().tobytes()
        assert hashlib.sha256(out).hexdigest() == WALKER_DIGESTS[label], label


# ---- the walker's repaired running sums (walker.cuh, guided.cu) -----------

PLANTED = [float("nan"), float("inf"), float("-inf"), 1e3, 1e8, 1e20]
# an inner pixel, one on a 32-row segment boundary and a 64-column strip
# edge, one on a 128-column (twopass) strip edge
PLANT_AT = [(5, 10), (32, 64), (50, 128)]


def _classes(x):
    """0 finite, 1 +inf, 2 -inf, 3 NaN."""
    return torch.where(torch.isnan(x), 3, torch.where(
        torch.isposinf(x), 1, torch.where(torch.isneginf(x), 2, 0)))


def _planted_close(got, ref, y, x, r):
    """got has ref's non-finite outputs (NaN for NaN, the same infinities)
    and is within 1e-4 of it outside the (4r + 1)^2 block around (y, x)."""
    assert torch.equal(_classes(got), _classes(ref))
    far = torch.ones_like(got, dtype=torch.bool)
    far[max(0, y - 2 * r):y + 2 * r + 1, max(0, x - 2 * r):x + 2 * r + 1] = 0
    keep = far & torch.isfinite(ref)
    if bool(keep.any()):
        assert float((got[keep] - ref[keep]).abs().max()) <= 1e-4


def _planted_pair(card, rows=70):
    g = np.random.default_rng(0)
    I = g.random((rows, 150), dtype=np.float32)
    p = np.clip(I + 0.1 * g.standard_normal(I.shape), 0, 1).astype(
        np.float32)
    return torch.from_numpy(I).to(card), torch.from_numpy(p).to(card)


@pytest.mark.parametrize("value", PLANTED)
@pytest.mark.parametrize("entry", ["onepass self", "onepass general",
                                   "twopass"])
@pytest.mark.parametrize("radius", [2, 8])
def test_walker_planted_value_frame_entries(card, entry, radius, value):
    """A NaN, an infinity or a large value at one pixel of I (and, for the
    general forms, of p) reaches only the outputs whose windows hold it, as
    in the plain version's direct sums, and leaves no residue elsewhere."""
    I0, p0 = _planted_pair(card)
    variant = "twopass" if entry == "twopass" else "onepass"
    self_g = entry == "onepass self"
    for plane in ("I",) if self_g else ("I", "p"):
        for y, x in PLANT_AT:
            I, p = I0.clone(), p0.clone()
            (I if plane == "I" else p)[y, x] = value
            if self_g:
                got = guided_filter_kernel(I, I, radius, 1e-3,
                                           self_guided=True)
                ref = guided_filter_plain(I, I, radius, 1e-3, True)
            else:
                got = guided_filter_kernel(I, p, radius, 1e-3,
                                           variant=variant)
                ref = guided_filter_plain(I, p, radius, 1e-3)
            _planted_close(got, ref, y, x, radius)


@pytest.mark.parametrize("value", PLANTED)
@pytest.mark.parametrize("self_guided", [False, True])
@pytest.mark.parametrize("radius", [8, 80])
def test_walker_planted_value_ypadded(card, radius, self_guided, value):
    """The row-padded entry on its shared-memory route (r 8) and its
    scratch route (r 80), planted values as above at output rows 5, 32 and
    50."""
    I0, p0 = _planted_pair(card, 70 + 4 * radius)
    before = kernels.launches["tpuimg_guided_onepass_ypadded_scratch"]
    for plane in ("I",) if self_guided else ("I", "p"):
        for y, x in PLANT_AT:
            I, p = I0.clone(), p0.clone()
            (I if plane == "I" else p)[y + 2 * radius, x] = value
            pp = I if self_guided else p
            got = guided_ypadded_kernel(I, pp, radius, 1e-3, self_guided)
            ref = guided_ypadded_plain(I, pp, radius, 1e-3, self_guided)
            _planted_close(got, ref, y, x, radius)
    assert (kernels.launches["tpuimg_guided_onepass_ypadded_scratch"]
            > before) == (radius > GUIDED_SMEM_MAX_RADIUS)


def test_walker_in_range_frames_keep_bits_across_segments(card):
    """A frame without non-finite values or outliers, the same frame with a
    NaN planted far from a window, and back: the outputs outside the NaN's
    windows are the in-range frame's bit for bit (nothing of the NaN is
    left in any running sum)."""
    I, p = _planted_pair(card, 300)
    want = guided_filter_kernel(I, p, 8, 1e-3)
    I2 = I.clone()
    I2[150, 75] = float("nan")
    got = guided_filter_kernel(I2, p, 8, 1e-3)
    far = torch.ones_like(got, dtype=torch.bool)
    far[150 - 16:150 + 17, 75 - 16:75 + 17] = 0
    assert bool(torch.isfinite(got[far]).all())
    assert float((got[far] - want[far]).abs().max()) <= 1e-4
    assert int((~torch.isfinite(got)).sum()) == int(
        (~torch.isfinite(guided_filter_plain(I2, p, 8, 1e-3))).sum())


# ---- the CLAHE mapping (clahe_map.cu) ---------------------------------------

# a 64-tile grid needs more reflect padding than 7 columns give; at width
# 1000 its 16-column tiles take the instance that reads the tables from
# global memory (a span's tables past the shared memory it stages)
@pytest.mark.parametrize("tiles,width", [
    (t, w) for t in (2, 8, 16, 64) for w in (3840, 1917, 1000, 7)
    if w > t or t < 64])
def test_clahe_map_tile_grids_and_widths(card, tiles, width):
    """Tile grids from 2 to 64 (tiles of 60 columns, and of one at width 7,
    narrower than a block's span of columns), widths whose rows start
    unaligned, and bands whose first row lies on either side of a tile-row
    centre: bit-exact against the rows of the whole frame's map, and within
    the usual tolerance of the plain version."""
    h = 300
    img = torch.from_numpy(_frame((h, width), 71)).to(card)
    geo, tables = _geometry_and_tables(img, tiles, tiles)
    th, pad_top = geo[0], geo[2]
    # the first tile-row centre inside the frame, past its first row
    centre = next(c for c in (int((t + 0.5) * th) - pad_top
                              for t in range(tiles)) if c >= 1)
    for out_f32 in (True, False):
        full = clahe_map(img, tables, tiles, tiles, *geo, out_f32=out_f32)
        ref = clahe_map_plain(img, tables, tiles, tiles, *geo,
                              out_f32=out_f32)
        assert full.dtype == ref.dtype
        assert float((full.float() - ref.float()).abs().max()) <= (
            1e-3 if out_f32 else 1.0)
        for y0 in (centre - 1, centre, centre + 1):
            band = img[y0:]
            got = clahe_band_map(band, tables, tiles, tiles, *geo, y0,
                                 out_f32=out_f32)
            assert torch.equal(got, full[y0:])


def _clahe_4k(card):
    img = torch.from_numpy(_frame((2160, 3840), 72)).to(card)
    geo, tables = _geometry_and_tables(img, 8, 8)
    return img, tables, geo


# SHA-256 of the mapping's outputs on _clahe_4k's frame, tiles 8, from the
# first CUDA design (a thread a pixel), NVIDIA H100 80GB HBM3
CLAHE_DIGESTS = {
    "f32": "6f9a60440e183516b3ad2bd586d0c5e90992254017e44fd9a3fbacca8733bc6f",
    "u8": "0a2ccf0265e63df4fb884bfa6c57e36e53b5ac110f511e57b9a87ae10dc0e552",
    "band u8 at y0 540":
        "b721925ead0faac491e7aafc8191d0c1ec7b662f872bb1d1ea1c37bb001b49ad",
}


@pytest.mark.parametrize("what", ["f32", "u8", "band u8 at y0 540"])
def test_clahe_map_4k_matches_recorded_digests(card, what):
    """The redesigned mapping gives the first design's bits at 4K."""
    import hashlib

    img, tables, geo = _clahe_4k(card)
    if what.startswith("band"):
        out = clahe_band_map(img[540:1080], tables, 8, 8, *geo, 540)
    else:
        out = clahe_map(img, tables, 8, 8, *geo, out_f32=what == "f32")
    got = hashlib.sha256(out.contiguous().cpu().numpy().tobytes()).hexdigest()
    assert got == CLAHE_DIGESTS[what]


# ---- the 256-bin histograms (hist256.cu) -----------------------------------

def test_hist256_one_launch_no_memset(card):
    """Each call is one kernel on the card and nothing else, at every grid:
    one block a group, and several with the workspace."""
    frames = [torch.from_numpy(_frame(s, 73)).to(card).reshape(g, -1)
              for s, g in (((2160, 3840), 1), ((64, 8161), 64),
                           ((16, 108, 192), 16))]
    for x in frames:
        before = kernels.launches["tpuimg_hist256"]
        assert _queued_by(hist256_groups, x) == ["launch"]
        assert kernels.launches["tpuimg_hist256"] == before + 2


def test_hist256_two_streams_at_once(card):
    """Calls interleaved on two streams keep their counts apart: each stream
    has a workspace of its own, and every call leaves it zeroed."""
    from tpuimg_torch.kernels import hist as khist

    frames = [torch.from_numpy(_frame(s, 74 + i)).to(card)
              for i, s in enumerate([(2160, 3840), (1080, 1920),
                                     (4, 540, 960)])]
    want = [hist256_groups_plain(x.reshape(x.shape[0] if x.ndim == 3 else 1,
                                           -1)) for x in frames]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(6):
        for s in streams:
            with torch.cuda.stream(s):
                for i, x in enumerate(frames):
                    g = x.shape[0] if x.ndim == 3 else 1
                    outs.append((i, hist256_groups(x.reshape(g, -1))))
    torch.cuda.synchronize()
    for i, out in outs:
        assert torch.equal(out, want[i])
    for ws in khist._WORKSPACES.values():
        assert int(ws.abs().sum()) == 0


@pytest.mark.parametrize("value", [0, 1, 128, 255])
def test_hist256_single_bin_frames_every_grid(card, value):
    """A frame of one value sends every count to one bin through the warp's
    one-atomic path: one frame over many blocks, frames over a few, and
    (64, 8161) groups of one block each."""
    for shape, g in (((2160, 3840), 1), ((16, 270, 480), 16),
                     ((64, 8161), 64)):
        x = torch.full(shape, value, dtype=torch.uint8, device=card)
        got = hist256_groups(x.reshape(g, -1))
        assert bool((got[:, value] == x.numel() // g).all())
        assert int(got.sum()) == x.numel()


@pytest.mark.parametrize("offset", [0, 1, 5, 15])
def test_hist256_groups_64x8161_and_8k(card, offset):
    """Groups whose bases fall at every alignment, and an 8K frame across
    the whole card, exact."""
    groups = _unaligned((64, 8161), offset, 75, card)
    assert torch.equal(hist256_groups(groups), hist256_groups_plain(groups))
    img = _unaligned((4320, 7680), offset, 76, card)
    assert torch.equal(hist256(img),
                       hist256_groups_plain(img.reshape(1, -1))[0])


def _tie_frame(seed):
    """A (1024, 2048) frame, N = 2^21, whose first bins hold 2^12 pixels
    each: its cdf * 256 / N runs 0.5, 1, 1.5, 2, 2.5, ..., halves that
    round to even both ways."""
    g = np.random.default_rng(seed)
    n = 1024 * 2048
    counts = np.full(8, 4096)
    rest = g.integers(0, 248, n - counts.sum()) + 8
    pixels = np.concatenate([np.repeat(np.arange(8), counts), rest])
    return g.permutation(pixels).astype(np.uint8).reshape(1, 1024, 2048)


# (shape, storage offset, seed): one block a frame (P of 3,000 bytes), the
# HE cell's 16 1080p frames and one 4K frame (split over blocks, the last
# builds the table), more groups than the workspace takes (a block each),
# a stack 3 bytes past alignment, and cdfs on halves over split blocks
HE_TABLE_CASES = [((1, 50, 60), 0, 81), ((3, 50, 60), 0, 82),
                  ((16, 1080, 1920), 0, 83), ((1, 2160, 3840), 0, 84),
                  ((1100, 17, 31), 0, 85), ((16, 108, 192), 3, 86),
                  ("ties", 0, 87)]


@pytest.mark.parametrize("shape,offset,seed", HE_TABLE_CASES)
def test_he_tables_exact(card, shape, offset, seed):
    """The histogram launch that ends in HE's tables equals the plain
    rule on the plain histograms bit for bit, at every grid form, and a
    second call gives the same tables: every call leaves the workspace
    zeroed. One launch of its entry a call, none of the histogram's."""
    from tpuimg_torch.kernels import hist as khist

    if shape == "ties":
        frames = torch.from_numpy(_tie_frame(seed)).to(card)
    else:
        frames = _unaligned(shape, offset, seed, card)
    groups = frames.reshape(frames.shape[0], -1)
    want = _he_tables(hist256_groups_plain(groups), groups.shape[1])
    before = _count("tpuimg_he_tables", "tpuimg_hist256")
    got = he_tables(groups)
    again = he_tables_frames(frames)
    assert _count("tpuimg_he_tables", "tpuimg_hist256") == (
        before[0] + 2, before[1])
    assert got.dtype == torch.uint8 and got.shape == (frames.shape[0], 256)
    assert torch.equal(got, want) and torch.equal(again, want)
    torch.cuda.synchronize()
    for ws in khist._WORKSPACES.values():
        assert int(ws.abs().sum()) == 0
    if shape == "ties":
        assert got[0, :8].tolist() == [0, 1, 2, 2, 2, 3, 4, 4]


@pytest.mark.parametrize("value", [0, 77, 255])
def test_he_tables_flat_frames(card, value):
    """A frame of one value: every entry below it 0, from it on 255 (cdf
    * factor = 256, min before rounding), over many blocks and over one."""
    want = torch.zeros(256, dtype=torch.uint8)
    want[value:] = 255
    for shape in ((1, 2160, 3840), (16, 270, 480), (1, 40, 50)):
        x = torch.full(shape, value, dtype=torch.uint8, device=card)
        got = he_tables_frames(x).cpu()
        assert bool((got == want).all()), (shape, got)


def test_he_tables_one_launch_no_memset(card):
    """Each call is one kernel on the card and nothing else, at every
    grid form."""
    frames = [torch.from_numpy(_frame(s, 88)).to(card)
              for s in ((1, 2160, 3840), (16, 1080, 1920), (1100, 17, 31))]
    for x in frames:
        before = kernels.launches["tpuimg_he_tables"]
        assert _queued_by(he_tables_frames, x) == ["launch"]
        assert kernels.launches["tpuimg_he_tables"] == before + 2


# ---- the tile histograms (tile_hist.cu) and the gather (lut_gather.cu) -----

# The one-kernel checks read the profiler's records of the runtime calls
# that queue device work, which carry the host's clock: in a process that
# has already run much device work the profiler loses most kernel records of
# a short trace, whatever its margins, but never these (PERF.md section 6).
_QUEUES = (("launch", ("cudaLaunchKernel", "cuLaunchKernel")),
           ("memset", ("cudaMemset", "cuMemset")),
           ("copy", ("cudaMemcpy", "cuMemcpy")))


def _queued_by(fn, *args):
    """What one call of fn(*args) queues on the card, after a warm-up call
    (two calls in all): "launch", "memset" or "copy" for each runtime call
    that queues device work, in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return [kind for e in prof.events() if e.device_type == DeviceType.CPU
            for kind, names in _QUEUES if e.name.startswith(names)]


def _in_a_fresh_process(script):
    """Run ``script`` in a fresh Python process at the repository's root,
    after ``import json, torch`` and with ``card`` the card, and return the
    JSON its last line prints. No device work comes before it there, so
    the profiler keeps every kernel record of a short trace."""
    head = "import json, torch\ncard = torch.device('cuda')\n"
    done = subprocess.run(
        [sys.executable, "-c", head + script], capture_output=True,
        text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.splitlines()[-1])


_KERNELS = """
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import tpuimg_torch
from tpuimg_torch.pipeline import enhance
{setup}
def call():
    {call}
call()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    call()
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]))
"""


def _kernels_in_a_fresh_process(setup, call):
    """The names of the CUDA kernels that the statement ``call`` runs (after
    ``setup``), by the profiler in a fresh process, after a warm-up call."""
    return _in_a_fresh_process(_KERNELS.format(setup=setup, call=call))


def _tile_hist_both(img, yt, xt):
    """tile_hist and its plain version of img at a (yt, xt) grid; both
    exact and every tile's counts summing to its pixels."""
    geo, _ = _geometry_and_tables(img, yt, xt)
    got = tile_hist(img, yt, xt, *geo)
    assert torch.equal(got, tile_hist_plain(img, yt, xt, *geo))
    assert bool((got.sum(dim=1) == geo[0] * geo[1]).all())
    return got


@pytest.mark.parametrize("value", [0, 77, 255])
def test_tile_hist_flat_frames(card, value):
    """Every atomic of a tile goes to one bin, at 4K over 8x8 (clusters of
    8) and 64x64 tiles (one block a tile), and at 1080p."""
    for shape, tiles in (((2160, 3840), 8), ((2160, 3840), 64),
                         ((1080, 1920), 8)):
        img = torch.full(shape, value, dtype=torch.uint8, device=card)
        got = _tile_hist_both(img, tiles, tiles)
        assert bool((got[:, value] == got.sum(dim=1)).all())


@pytest.mark.parametrize("tiles", [2, 8, 64])
def test_tile_hist_one_value_per_tile(card, tiles):
    """A frame whose every tile (of the frame, not the extension) holds one
    value: each count lands where the reflected runs put it."""
    h, w = 2161, 3839
    th, tw, pt, pl = _clahe_geometry(h, w, tiles, tiles)
    ty = (torch.arange(h, device=card) + pt) // th
    tx = (torch.arange(w, device=card) + pl) // tw
    img = ((ty[:, None] * tiles + tx[None, :]) * 37 % 256).to(torch.uint8)
    _tile_hist_both(img.contiguous(), tiles, tiles)


def _fits(h, w, grid):
    """Whether a (ytiles, xtiles) grid is a reflect-101 extension of an
    h x w frame (_clahe_geometry's bound)."""
    try:
        _clahe_geometry(h, w, grid[1], grid[0])
    except ParamError:
        return False
    return True


# 64 tiles need more padding than 7 columns give
TILE_WIDTHS = [(w, g) for w in (7, 1917, 3839)
               for g in ((2, 2), (8, 8), (16, 16), (64, 64), (3, 7))
               if _fits(300, w, g)]


@pytest.mark.parametrize("width,grid", TILE_WIDTHS)
def test_tile_hist_widths(card, width, grid):
    """Rows that start at every alignment (1917, 3839), tiles one column
    wide (7 columns over 7 or 16 tiles), grids up to 64x64."""
    yt, xt = grid
    img = torch.from_numpy(_frame((300, width), 80)).to(card)
    _tile_hist_both(img, yt, xt)


@pytest.mark.parametrize("shape,grid", [((2160, 3840), (64, 64)),
                                        ((9, 9), (8, 8)), ((5, 7), (4, 6)),
                                        ((70, 1000), (64, 64)),
                                        ((2, 300), (2, 64)),
                                        ((1, 1), (1, 1))])
def test_tile_hist_dense_grids_and_deep_pads(card, shape, grid):
    """64x64 tiles at 4K, and grids whose pads reach past a tile (9x9 at
    8x8: pads 3 and 4 rows of 2-row tiles), exact."""
    img = torch.from_numpy(_frame(shape, 81)).to(card)
    _tile_hist_both(img, *grid)


def test_tile_hist_one_launch_no_memset(card):
    """One kernel a call at every cluster size the plan picks (8 at 4K, 4
    at 1080p, 1 at 64x64 tiles), and no memset."""
    from tpuimg_torch.kernels import sm_count
    from tpuimg_torch.kernels.hist import tile_hist_plan

    clusters = set()
    for shape, tiles in (((2160, 3840), 8), ((1080, 1920), 8),
                         ((2160, 3840), 64)):
        img = torch.from_numpy(_frame(shape, 82)).to(card)
        geo, _ = _geometry_and_tables(img, tiles, tiles)
        clusters.add(tile_hist_plan(tiles, tiles, geo[0], geo[1],
                                    sm_count(img.device))[0])
        before = kernels.launches["tpuimg_tile_hist"]
        assert _queued_by(tile_hist, img, tiles, tiles, *geo) == ["launch"]
        assert kernels.launches["tpuimg_tile_hist"] == before + 2
    assert {1, 8} <= clusters


def test_tile_hist_two_streams_at_once(card):
    """Calls interleaved on two streams keep their counts apart."""
    cases = []
    for shape, tiles in (((2160, 3840), 8), ((1080, 1920), 16),
                         ((300, 1917), 64)):
        img = torch.from_numpy(_frame(shape, 83)).to(card)
        geo, _ = _geometry_and_tables(img, tiles, tiles)
        args = (img, tiles, tiles, *geo)
        cases.append((args, tile_hist_plain(*args)))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                outs += [(i, tile_hist(*args))
                         for i, (args, _) in enumerate(cases)]
    torch.cuda.synchronize()
    for i, out in outs:
        assert torch.equal(out, cases[i][1])


# ---- CLAHE's tables out of the tile-histogram launch (tile_tables) ---------

# 0.01 clips at 0 counts on the small frames (everything redistributed), 40
# is bench.py's CLAHE config, 1e9 clips nothing (the limit capped at th*tw)
TABLE_CLIPS = [0.01, 1.0, 2.0, 40.0, 1e9]


def _tables_both(img, yt, xt, clip):
    """tile_tables of img and _clahe_tables of its plain histograms at a
    (yt, xt) grid and a clip limit: the two equal bit for bit, and every
    tile's cdf ends at its pixels, whatever was redistributed."""
    geo = _clahe_geometry(*img.shape, xt, yt)
    limit, fr = _clahe_scale(clip, *geo[:2])
    got = tile_tables(img, yt, xt, *geo, limit, fr)
    want = _clahe_tables(tile_hist_plain(img, yt, xt, *geo), clip, *geo[:2])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    last = float(np.float32(geo[0] * geo[1]) * np.float32(fr))
    assert bool((got[:, -1] == last).all())


@pytest.mark.parametrize("clip", TABLE_CLIPS)
@pytest.mark.parametrize("shape,grid", CLAHE_CASES)
def test_tile_tables_equal_plain_tables(card, shape, grid, clip):
    img = torch.from_numpy(_frame(shape, 84)).to(card)
    _tables_both(img, *grid, clip)


@pytest.mark.parametrize("clip", [0.01, 2.0, 40.0])
@pytest.mark.parametrize("value", [0, 77, 255])
def test_tile_tables_flat_frames(card, value, clip):
    """All of a tile's excess in one bin: at 4K over 8x8 (clusters of 8)
    and 64x64 tiles (one block a tile), and at 1080p (clusters of 4)."""
    for shape, tiles in (((2160, 3840), 8), ((2160, 3840), 64),
                         ((1080, 1920), 8)):
        img = torch.full(shape, value, dtype=torch.uint8, device=card)
        _tables_both(img, tiles, tiles, clip)


@pytest.mark.parametrize("tiles", [2, 8, 64])
def test_tile_tables_one_value_per_tile(card, tiles):
    """One value a tile of the frame, so each tile's counts sit in a few
    bins: a residual of 0 and of other sizes across the tiles and the clip
    limits, at clusters of 8 (2 and 8 tiles) and 1 (64). The last clip
    limit leaves an inner tile's steal, its pixels less the limit, at
    256."""
    h, w = 2161, 3839
    th, tw, pt, pl = _clahe_geometry(h, w, tiles, tiles)
    ty = (torch.arange(h, device=card) + pt) // th
    tx = (torch.arange(w, device=card) + pl) // tw
    img = ((ty[:, None] * tiles + tx[None, :]) * 37 % 256).to(
        torch.uint8).contiguous()
    hists = tile_hist_plain(img, tiles, tiles, th, tw, pt, pl)
    steals = set()
    for clip in (0.01, 1.0, 2.0, 40.0, 256.0 * (th * tw - 256) / (th * tw)):
        _tables_both(img, tiles, tiles, clip)
        limit, _ = _clahe_scale(clip, th, tw)
        steals |= set((hists - limit).clamp(min=0).sum(dim=1).remainder(
            256).tolist())
    assert 0 in steals and len(steals) > 1


def test_tile_tables_one_launch_no_torch_op(card):
    """One kernel a call and no PyTorch op on the card, at clusters of 8
    (4K, 8 tiles), 4 (1080p) and 1 (4K, 64 tiles); the counter rises by
    one a call."""
    from tpuimg_torch.kernels import sm_count
    from tpuimg_torch.kernels.hist import tile_hist_plan

    clusters = set()
    for shape, tiles in (((2160, 3840), 8), ((1080, 1920), 8),
                         ((2160, 3840), 64)):
        img = torch.from_numpy(_frame(shape, 85)).to(card)
        geo = _clahe_geometry(*shape, tiles, tiles)
        clusters.add(tile_hist_plan(tiles, tiles, geo[0], geo[1],
                                    sm_count(img.device))[0])
        before = kernels.launches["tpuimg_tile_tables"]
        assert _queued_by(tile_tables, img, tiles, tiles, *geo,
                          *_clahe_scale(2.0, *geo[:2])) == ["launch"]
        assert kernels.launches["tpuimg_tile_tables"] == before + 2
    assert {1, 8} <= clusters


@pytest.mark.parametrize("impl", ["fused", "fused1", "staged"])
def test_enhance_4k_equals_tables_built_on_the_host(card, monkeypatch, impl):
    """enhance at 4K with the tables from the tile kernel (the plan's C
    call on the fused paths) equals the same chain with the tables built
    the old way, tile_hist then _clahe_tables, bit for bit: staged through
    enhance, the fused paths through their wrappers."""
    from tpuimg_torch.ops import histogram

    img = torch.from_numpy(_frame((2160, 3840), 86)).to(card)
    got = enhance(img, impl=impl)

    def host_tables(img, yt, xt, th, tw, pt, pl, limit, fr):
        assert (limit, fr) == _clahe_scale(2.0, th, tw)
        return _clahe_tables(tile_hist(img, yt, xt, th, tw, pt, pl), 2.0,
                             th, tw)

    monkeypatch.setattr(histogram, "tile_tables", host_tables)
    before = kernels.launches["tpuimg_tile_hist"]
    if impl == "staged":
        want = enhance(img, impl=impl)
    else:
        tables, *geo = histogram._clahe_front(img, 2.0, 8, 8)
        if impl == "fused":
            f = clahe_map(img, tables, 8, 8, *geo, out_f32=True,
                          scale=INV_255)
            want = enhance_tail(f, 2, 1.5, 8, 1e-3, out_u8=True)
        else:
            want = enhance_tail_clahe(img, tables, 8, 8, *geo, 2, 1.5, 8,
                                      1e-3, out_u8=True)
    assert kernels.launches["tpuimg_tile_hist"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ["fused", "fused1", "staged"])
def test_enhance_spans_on_card_leave_out_the_host_tables(card, impl):
    """On the card no step of enhance builds the tables on the host (the
    CPU run's clahe.tables): staged's steps are the CPU run's without it,
    clahe.hist holding the one launch of tpuimg_tile_tables; a fused call
    of a planned shape is one launch of tpuimg_enhance_run, which builds
    them in its tile kernel."""
    from tpuimg_torch import profiling

    frame = _frame((270, 480), 87)
    enhance(torch.from_numpy(frame).to(card), impl=impl)  # makes the plan
    spans = {}
    for dev in ("cpu", card):
        with profiling.recording() as rec:
            enhance(torch.from_numpy(frame).to(dev), impl=impl)
        spans[dev] = rec.spans
    cpu, gpu = ([s for s in sp if s.parent == sp[0].id]
                for sp in spans.values())
    assert spans["cpu"][0].name == spans[card][0].name == "pipeline.enhance"
    assert "clahe.tables" in [s.name for s in cpu]
    assert "clahe.tables" not in [s.name for s in spans[card]]
    if impl != "staged":
        assert [(s.name, s.detail) for s in gpu] == [
            ("kernels.launch", "tpuimg_enhance_run")]
        return
    assert [s.name for s in gpu] == [
        s.name for s in cpu if s.name != "clahe.tables"]
    (hist,) = [s for s in gpu if s.name == "clahe.hist"]
    inside = [s for s in spans[card] if s.parent == hist.id]
    assert [(s.name, s.detail) for s in inside] == [
        ("kernels.launch", "tpuimg_tile_tables")]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 2160 * 3840 + 1])
@pytest.mark.parametrize("offset", range(16))
def test_lut_gather_offsets_and_lengths(card, offset, n):
    """Inputs at every offset from a 16-byte boundary, lengths around a
    chunk of 16 and a 4K frame plus one pixel, every table kind: bits
    exact."""
    img = _unaligned((1, n), offset, 26, card)
    for table in _tables(27):
        t = torch.from_numpy(table).to(card)
        got = lut_gather(t, img)
        assert got.dtype == t.dtype and got.shape == (1, n)
        assert torch.equal(_bits(got), _bits(lut_gather_plain(t, img)))


@pytest.mark.parametrize("offset", [0, 1, 7])
@pytest.mark.parametrize("shape", [(70000, 1, 3), (3, 1081, 1917),
                                   (3, 256, 256), (3, 65535, 1),
                                   (5, 4099, 17)])
def test_lut_gather_frames_offsets(card, shape, offset):
    """Frames below the staging threshold of 65536 pixels (every table
    through the read-only cache), at it, and above it (staged, with chunks
    that straddle two frames), at input offsets: exact."""
    imgs = _unaligned(shape, offset, 28, card)
    tables = torch.from_numpy(_frame((shape[0], 256), 29)).to(card)
    got = lut_gather_frames(tables, imgs)
    assert torch.equal(got, lut_gather_frames_plain(tables, imgs))


def test_lut_gather_one_launch_no_memset(card):
    """One kernel a call: one table (u8 and 4-byte entries) and frames."""
    img = torch.from_numpy(_frame((2160, 3840), 84)).to(card)
    stack = torch.from_numpy(_frame((16, 108, 192), 85)).to(card)
    tables = torch.from_numpy(_frame((16, 256), 86)).to(card)
    for fn, args in ((lut_gather, (tables[0], img)),
                     (lut_gather, (tables.view(torch.int32).reshape(-1)[:256],
                                   img)),
                     (lut_gather_frames, (tables, stack))):
        before = kernels.launches["tpuimg_lut_gather"]
        assert _queued_by(fn, *args) == ["launch"]
        assert kernels.launches["tpuimg_lut_gather"] == before + 2


def test_lut_gather_two_streams_at_once(card):
    """Calls interleaved on two streams give each call its own bits."""
    img = _unaligned((1080, 1920), 3, 87, card)
    stack = torch.from_numpy(_frame((4, 540, 960), 88)).to(card)
    tables = torch.from_numpy(_frame((4, 256), 89)).to(card)
    f32 = torch.from_numpy(_tables(90)[2]).to(card)
    cases = [(lut_gather, (tables[1], img)), (lut_gather, (f32, img)),
             (lut_gather_frames, (tables, stack))]
    want = [_bits(lut_gather_plain(*a) if fn is lut_gather
                  else lut_gather_frames_plain(*a)) for fn, a in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                outs += [(i, fn(*a)) for i, (fn, a) in enumerate(cases)]
    torch.cuda.synchronize()
    for i, out in outs:
        assert torch.equal(_bits(out), want[i])


# -- colour, metrics, the CLI, the frame stream and the profiler on the card


def _steps(a, b) -> int:
    return int((a.cpu().int() - b.cpu().int()).abs().max())


@pytest.mark.parametrize("shape", [(2160, 3840, 3), (3, 17, 23, 3)])
def test_color_on_card_matches_cpu(card, shape):
    from tpuimg_torch.ops import color

    rgb = torch.from_numpy(_frame(shape, 91))
    for name in ("rgb_to_lab", "lab_to_rgb", "bgr_to_lab", "lab_to_bgr",
                 "rgb_to_gray"):
        fn = getattr(color, name)
        got = fn(rgb.to(card))
        assert got.is_cuda and got.dtype == torch.uint8
        assert _steps(got, fn(rgb)) <= 1, name


def test_metrics_on_card_match_cpu(card):
    from tpuimg_torch.ops.metrics import max_abs_diff, max_abs_diff_loc

    rng = np.random.default_rng(92)
    big = torch.from_numpy(rng.integers(2**24, 2**30, (64, 80)).astype(
        np.int32))
    cases = [
        (big, big + 1),
        (torch.zeros((9, 9), dtype=torch.uint8),
         torch.full((9, 9), 255, dtype=torch.uint8)),
        (torch.from_numpy(rng.random((33, 47), dtype=np.float32)),
         torch.from_numpy(rng.random((33, 47), dtype=np.float32))),
    ]
    tie = torch.zeros((5, 7), dtype=torch.int32)
    tie2 = tie.clone()
    tie2[1, 2] = tie2[3, 4] = 9
    cases.append((tie, tie2))
    for a, b in cases:
        got = max_abs_diff(a.to(card), b.to(card))
        assert got.is_cuda and got.ndim == 0
        assert got.item() == max_abs_diff(a, b).item()
        loc = max_abs_diff_loc(a.to(card), b.to(card))
        assert [t.item() for t in loc] == [
            t.item() for t in max_abs_diff_loc(a, b)]
    assert max_abs_diff(cases[1][0].to(card), cases[1][1].to(card)) == 255


@pytest.mark.parametrize("argv,rows", [
    (["integral", "--width", "300", "--height", "200", "--nreps", "2"], 2),
    (["enhance", "--width", "320", "--height", "180", "--nreps", "2"], 3),
])
def test_cli_on_card(card, capsys, argv, rows):
    from tpuimg_torch.cli import main

    assert main(argv) == 0
    out, err = capsys.readouterr()
    assert out.count("[OK]") == rows
    assert "times by CUDA events" in err


def test_cli_he_autotest_on_card(card, tmp_path, monkeypatch, capsys):
    from tpuimg_torch.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["he-autotest", "--runs", "3", "--max-size", "400"]) == 0
    lines = (tmp_path / "res.log").read_text().strip().splitlines()
    assert len(lines) == 3 and all(l.endswith(": 0") for l in lines)


def test_frame_stream_into_enhance_on_card(card, tmp_path):
    from tpuimg_torch import native

    if not native.available():
        pytest.skip("native loader does not build here")
    frames = [_frame((180, 320), 93 + i) for i in range(5)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.png"))
        native.write_png(paths[-1], f)
    seen = 0
    with native.FrameStream(paths, (180, 320), gray=True, threads=2) as fs:
        for idx, frame in fs:
            out = enhance(torch.from_numpy(frame).to(card))
            assert out.is_cuda
            assert _steps(out, enhance(torch.from_numpy(frames[idx]))) <= 1
            seen += 1
    assert seen == 5


def test_trace_on_card_names_the_enhance_tail_kernel(card, tmp_path):
    names = _in_a_fresh_process(f"""
import glob
from tpuimg_torch.pipeline import enhance
from tpuimg_torch.profiling import trace
img = torch.randint(0, 256, (540, 960), dtype=torch.uint8, device=card)
with trace({str(tmp_path)!r}):
    enhance(img)
(path,) = glob.glob({str(tmp_path / "*.pt.trace.json")!r})
with open(path) as f:
    print(json.dumps([e.get("name", "") for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "kernel"]))
""")
    # csrc/enhance_tail.cu instantiates tail::tail_kernel with its FrameSrc
    assert any("tail_kernel" in n and "FrameSrc" in n for n in names), names


def test_trace_on_card_counts_two_tail_kernels_a_call(card):
    """A traced enhance launches the tail's two walks, each a kernel whose
    name holds "tail_kernel" (the substring bench_torch's tail_roofline
    reads) and FrameSrc: exactly two such kernels a call."""
    names = _kernels_in_a_fresh_process(
        "img = torch.randint(0, 256, (540, 960), dtype=torch.uint8, "
        "device=card)", "enhance(img)")
    tails = [n for n in names if "tail_kernel" in n]
    assert len(tails) == 2 and all("FrameSrc" in n for n in tails), names


def test_trace_on_card_puts_each_launch_call_inside_its_span(card, tmp_path):
    import glob
    import json

    from tpuimg_torch.profiling import trace

    img = torch.from_numpy(_frame((540, 960), 99)).to(card)
    enhance(img)
    torch.cuda.synchronize()
    with trace(str(tmp_path)):
        enhance(img)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = [e for e in events if e.get("cat") == "tpuimg_span"
                and e["name"] == "kernels.launch"]
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and e["name"].startswith("cudaLaunchKernel")]
    assert len(launches) == 1, launches
    # the spans are on the profiler's clock: the launch span of the plan's
    # C entry holds the runtime calls that launch its 4 kernels (the tile
    # kernel, the mapping, the tail's two walks)
    (span,) = launches
    assert span["args"]["detail"] == "tpuimg_enhance_run"
    inside = [c for c in calls if span["ts"] <= c["ts"]
              and c["ts"] + c["dur"] <= span["ts"] + span["dur"]]
    assert len(inside) == 4, (span, calls)


# -- enhance_host: host frames through the stream pool


def _retire(pending):
    i, out, ev = pending.pop(0)
    ev.synchronize()
    return i, out


def test_enhance_host_64_frames_4_in_flight_equal_enhance(card):
    """64 pinned frames through the pool's 4 streams, 4 in flight and each
    waited on by its event on the caller's stream, as the benchmark's loop
    does; each equals enhance of the frame on the card, bit for bit, and
    outputs still held are unchanged after 64 further calls."""
    from tpuimg_torch.host import POOL_STREAMS, enhance_host

    ring = torch.from_numpy(_frame((8, 1080, 1920), 120)).pin_memory()
    want = [enhance(ring[i].to(card)).cpu() for i in range(len(ring))]
    torch.cuda.synchronize()
    pending, seen = [], {}
    for i in range(128):
        if len(pending) == POOL_STREAMS:
            k, out = _retire(pending)
            seen.setdefault(k, []).append(out)
        ev = torch.cuda.Event()
        out = enhance_host(ring[i % len(ring)])
        ev.record()
        assert out.is_pinned() and out.dtype == torch.uint8
        pending.append((i, out, ev))
        if i == 63:  # held from here on: the first 64 frames' outputs
            held = {k: v[0].clone() for k, v in seen.items()}
    while pending:
        k, out = _retire(pending)
        seen.setdefault(k, []).append(out)
    for k, (out,) in seen.items():
        assert torch.equal(out, want[k % len(ring)]), k
    for k, copy in held.items():
        assert torch.equal(seen[k][0], copy), k


def test_enhance_host_pageable_numpy_and_pinned_agree(card):
    """A pageable CPU tensor and a NumPy array are staged into pinned
    memory and give the pinned input's frame; the counter counts each
    staging."""
    from tpuimg_torch.host import enhance_host

    frame = _frame((2160, 3840), 121)
    n = frame.size
    before = enhance_host.staged_bytes
    outs = [enhance_host(x) for x in (torch.from_numpy(frame).pin_memory(),
                                      torch.from_numpy(frame), frame)]
    torch.cuda.synchronize()
    assert enhance_host.staged_bytes - before == 2 * n
    want = enhance(torch.from_numpy(frame).to(card)).cpu()
    for out in outs:
        assert torch.equal(out, want)


def test_enhance_host_completes_on_the_callers_stream(card):
    """The call does not wait for its frame; the caller's stream does. A
    pool stream held up keeps the caller's event pending until the frame
    is down; a caller's stream held up does not hold up the pool stream."""
    from tpuimg_torch import host

    frame = torch.from_numpy(_frame((1080, 1920), 122)).pin_memory()
    want = enhance(frame.to(card)).cpu()
    host.enhance_host(frame)
    torch.cuda.synchronize()
    pool = host._POOLS[card.index if card.index is not None
                       else torch.cuda.current_device()]
    caller = torch.cuda.Stream()
    cycles = 200_000_000  # ~0.1 s at the card's clock
    with torch.cuda.stream(caller):
        stream = pool.streams[pool.turn]
        with torch.cuda.stream(stream):
            torch.cuda._sleep(cycles)  # the next frame's stream is busy
        out = host.enhance_host(frame)
        done = torch.cuda.Event()
        done.record()
    assert not done.query()  # returned before its frame was done
    done.synchronize()
    assert torch.equal(out, want)
    # the other way round: the caller's stream busy, the pool's not held
    with torch.cuda.stream(caller):
        torch.cuda._sleep(cycles)
        stream = pool.streams[pool.turn]
        out = host.enhance_host(frame)
        done = torch.cuda.Event()
        done.record()
    stream.synchronize()
    assert not done.query()  # the caller's stream is still asleep
    assert torch.equal(out, want)
    done.synchronize()


def test_enhance_host_spans_stage_on_the_card(card):
    from tpuimg_torch import profiling
    from tpuimg_torch.host import enhance_host

    frame = _frame((270, 480), 123)
    with profiling.recording() as rec:
        enhance_host(frame)
    torch.cuda.synchronize()
    root = rec.spans[0]
    assert root.name == "host.enhance"
    assert [(s.name, s.layer) for s in rec.spans if s.parent == root.id] == [
        ("host.stage", "transfer"), ("host.upload", "transfer"),
        ("pipeline.enhance", "entry"), ("host.download", "transfer")]


# ---- device spans: the card's work on the spans' clock ---------------------

DEVICE_SPANS = ("kernels.launch", "host.upload", "host.download")


def test_device_spans_put_the_cards_work_on_the_spans_clock(card):
    """Under recording(device=True), HE of 16 1080p frames, enhance at 4K
    and enhance_host at 4K give one interval a device span (each launch and
    copy), none ending before its span began less clock_error_ns; HE's two
    intervals, queued behind a wait on the card, follow it and each other
    and add up to its device time by events; a second stretch of the same
    size makes no new event."""
    from tpuimg_torch import profiling
    from tpuimg_torch.core.timing import time_cuda
    from tpuimg_torch.host import enhance_host

    stack = torch.from_numpy(_frame((16, 1080, 1920), 140)).to(card)
    frame = torch.from_numpy(_frame((2160, 3840), 141))
    up, pinned = frame.to(card), frame.pin_memory()

    def calls(n):  # 6 device spans a round
        for _ in range(n):
            tpuimg_torch.hist_equalize(stack)
            enhance(up)
            enhance_host(pinned)

    calls(1)
    torch.cuda.synchronize()
    made = []
    for _ in range(2):
        with profiling.recording(device=True) as rec:
            calls(50)  # more device spans than a pool makes ahead
        torch.cuda.synchronize()
        ivs = rec.intervals()
        spans = {s.id: s for s in rec.spans}
        assert sorted(iv.span for iv in ivs) == sorted(
            s.id for s in spans.values() if s.name in DEVICE_SPANS)
        assert len(ivs) == 300
        err = rec.clock_error_ns
        assert 0 <= err < 1_000_000
        for iv in ivs:
            assert iv.end_ns >= spans[iv.span].start_ns - err
            assert spans[iv.span].start_ns - err <= iv.start_ns <= iv.end_ns
        made.append(profiling._POOLS[torch.cuda.current_device()].made)
    assert made[1] == made[0]

    timed = [time_cuda(tpuimg_torch.hist_equalize, stack).ms
             for _ in range(2)]
    torch.cuda.synchronize()
    with profiling.recording(device=True) as rec:
        with profiling.span("test.wait", "glue", device=card) as s:
            s.queue()
            torch.cuda._sleep(50_000_000)  # ~30 ms: HE queues behind it
        tpuimg_torch.hist_equalize(stack)
    torch.cuda.synchronize()
    wait, *he = rec.intervals()
    assert [rec.spans[i].detail for i in range(len(rec.spans))
            if rec.spans[i].name == "kernels.launch"] == [
        "tpuimg_he_tables", "tpuimg_lut_gather"]
    # each starts as the work ahead of it on the stream ends
    assert 0 <= he[0].start_ns - wait.end_ns <= 10_000, (he, wait)
    assert 0 <= he[1].start_ns - he[0].end_ns <= 10_000, he
    he_ms = sum(iv.end_ns - iv.start_ns for iv in he) * 1e-6
    for ms in timed:
        assert abs(he_ms - ms) <= 0.25 * ms, (he_ms, timed)


def test_device_spans_on_an_idle_card_time_hes_kernels(card):
    """On an idle card, nothing queued ahead, HE's two intervals a call
    hold its kernels: their sum is no less than its device time by events
    queued behind a wait (``time_cuda``), and longer by the host's
    submission of each launch; trimmed to the launches' times when queued
    (``bench_torch.intervals``), the sum is within 25% of it."""
    from bench_torch import intervals
    from bench_torch import spans as bench_spans
    from tpuimg_torch import profiling
    from tpuimg_torch.core.timing import time_cuda

    stack = torch.from_numpy(_frame((16, 1080, 1920), 142)).to(card)
    timed = [time_cuda(tpuimg_torch.hist_equalize, stack).ms
             for _ in range(2)]
    queued = intervals.calibrate(profiling, tpuimg_torch.hist_equalize,
                                 [(stack,)], card)
    assert set(queued) == {"tpuimg_he_tables", "tpuimg_lut_gather"}
    raw, cut = [], []
    for _ in range(21):
        torch.cuda.synchronize()
        with profiling.recording(device=True) as rec:
            tpuimg_torch.hist_equalize(stack)
        torch.cuda.synchronize()
        ivs = rec.intervals()
        assert len(ivs) == 2
        raw.append(sum(iv.end_ns - iv.start_ns for iv in ivs) * 1e-6)
        cut.append(sum(iv[4] - iv[3] for iv in intervals.trim(
            ivs, bench_spans.spans_of(rec), queued)) * 1e-6)
    raw_ms, cut_ms = statistics.median(raw), statistics.median(cut)
    for ms in timed:
        assert raw_ms >= 0.95 * ms, (raw_ms, timed, queued)
        assert abs(cut_ms - ms) <= 0.25 * ms, (cut_ms, raw_ms, timed, queued)


# ---- enhance's scaling and rounding in the kernels' stores -----------------

# (shape, rg, r): the shared-memory route at the fixed gaussian radius and at
# a run-time one, the scratch route (r 54 past the shared-memory ceiling at
# rg 2), a width that is not a multiple of the 64-column strip, 4K, 8K and a
# frame just above enhance's gate (min(H, W) > 2*(2r + rg) = 36)
U8_CASES = [((300, 517), 2, 8), ((300, 517), 3, 4), ((300, 517), 2, 54),
            ((2160, 3840), 2, 8), ((4320, 7680), 2, 8), ((37, 70), 2, 8)]


@pytest.mark.parametrize("shape,rg,r", U8_CASES)
def test_enhance_tail_u8_store_equals_to_u8(card, shape, rg, r):
    """The tail's u8 store is _to_u8 of its f32 q, bit for bit, on the f of
    the card's own CLAHE blend (its q runs through [0, 1])."""
    img = torch.from_numpy(_frame(shape, 130)).to(card)
    geo, tables = _geometry_and_tables(img, 8, 8)
    f = clahe_map(img, tables, 8, 8, *geo, out_f32=True, scale=INV_255)
    before = kernels.launches["tpuimg_enhance_tail"]
    got = enhance_tail(f, rg, 1.5, r, 1e-3, out_u8=True)
    assert kernels.launches["tpuimg_enhance_tail"] == before + 1
    assert got.dtype == torch.uint8 and got.shape == shape
    assert torch.equal(got, _to_u8(enhance_tail(f, rg, 1.5, r, 1e-3)))


@pytest.mark.parametrize("shape,rg,r", U8_CASES)
def test_enhance_tail_clahe_u8_store_equals_to_u8(card, shape, rg, r):
    img = torch.from_numpy(_frame(shape, 131)).to(card)
    geo, tables = _geometry_and_tables(img, 8, 8)
    before = kernels.launches["tpuimg_enhance_tail_clahe"]
    got = enhance_tail_clahe(img, tables, 8, 8, *geo, rg, 1.5, r, 1e-3,
                             out_u8=True)
    assert kernels.launches["tpuimg_enhance_tail_clahe"] == before + 1
    assert got.dtype == torch.uint8 and got.shape == shape
    assert torch.equal(got, _to_u8(enhance_tail_clahe(
        img, tables, 8, 8, *geo, rg, 1.5, r, 1e-3)))


@pytest.mark.parametrize("shape,grid", [
    ((2160, 3840), (8, 8)), ((2161, 3839), (8, 8)), ((64, 1000), (4, 128))])
def test_clahe_map_scale_is_the_blend_times_scale(card, shape, grid):
    """scale=INV_255 stores the f32 blend times INV_255 exactly; scale=1.0
    keeps the raw blend, whose truncation, clamped (tiles 8 columns wide
    blend up to 256.9 here), is the u8 output. The shapes take the staged
    tables with 16-byte stores, an unaligned width's scalar stores, and
    tables gathered from device memory (tiles 8 columns wide)."""
    yt, xt = grid
    img = torch.from_numpy(_frame(shape, 132)).to(card)
    geo, tables = _geometry_and_tables(img, yt, xt)
    raw = clahe_map(img, tables, yt, xt, *geo, out_f32=True)
    assert torch.equal(_bits(clahe_map(img, tables, yt, xt, *geo,
                                       out_f32=True, scale=1.0)), _bits(raw))
    assert torch.equal(_blend_to_u8(raw),
                       clahe_map(img, tables, yt, xt, *geo))
    scaled = clahe_map(img, tables, yt, xt, *geo, out_f32=True, scale=INV_255)
    assert torch.equal(_bits(scaled), _bits(raw * INV_255))
    with pytest.raises(ValueError, match="scale"):
        clahe_map(img, tables, yt, xt, *geo, scale=INV_255)


TAILS = ("tpuimg_enhance_tail", "tpuimg_enhance_tail_clahe")


def _rounded_in_glue(monkeypatch) -> list:
    """Record each call of the pipeline's _to_u8, the glue that rounds q
    where no tail's store does."""
    from tpuimg_torch import pipeline

    rounded = []

    def to_u8(q):
        rounded.append(q.shape)
        return _to_u8(q)

    monkeypatch.setattr(pipeline, "_to_u8", to_u8)
    return rounded


@pytest.mark.parametrize("seed", [133, 134])
def test_enhance_equals_the_composition_with_glue(card, seed, monkeypatch):
    """enhance at 4K equals the composition that ran PyTorch glue between
    the kernels (the raw f32 blend, times INV_255, the f32 tail, _to_u8),
    bit for bit; fused1 equals it too. One launch of the plan's C call a
    call stores u8, no tail wrapper's."""
    from tpuimg_torch.ops.histogram import _clahe_front

    img = torch.from_numpy(_frame((2160, 3840), seed)).to(card)
    tables, *geo = _clahe_front(img, 2.0, 8, 8)
    blend = clahe_map(img, tables, 8, 8, *geo, out_f32=True)
    want = _to_u8(enhance_tail(blend * INV_255, 2, 1.5, 8, 1e-3))
    rounded = _rounded_in_glue(monkeypatch)
    for impl in ("fused", "fused1"):
        before = _count("tpuimg_enhance_run", *TAILS)
        assert torch.equal(enhance(img, impl=impl), want), impl
        assert _count("tpuimg_enhance_run", *TAILS) == (
            before[0] + 1, *before[1:]) and rounded == []


def test_u8_launches_count_the_fused_calls_only(card, monkeypatch):
    """The fused paths above the gate store u8 in the tail (the plan's C
    call); staged and frames under the gate launch no tail and round q in
    _to_u8."""
    big = torch.from_numpy(_frame((270, 480), 135)).to(card)
    small = torch.from_numpy(_frame((30, 40), 136)).to(card)
    rounded = _rounded_in_glue(monkeypatch)
    for call, adds in ((lambda: enhance(big), 1),
                       (lambda: enhance(big, impl="fused1"), 1),
                       (lambda: enhance(big, impl="staged"), 0),
                       (lambda: enhance(small), 0),
                       (lambda: enhance(small, impl="fused1"), 0)):
        before = sum(_count("tpuimg_enhance_run", *TAILS))
        rounded.clear()
        out = call()
        assert out.dtype == torch.uint8
        assert sum(_count("tpuimg_enhance_run", *TAILS)) == before + adds
        assert len(rounded) == 1 - adds


# ---- enhance's plan: one C call a frame ------------------------------------


def _composed(img, clip=2.0, tiles=8, radius=2, gf_radius=8):
    """enhance's fused chain as its three wrappers compose it: tile_tables,
    clahe_map storing the blend times INV_255, the tail storing u8 q."""
    geo = _clahe_geometry(*img.shape, tiles, tiles)
    tables = tile_tables(img, tiles, tiles, *geo,
                         *_clahe_scale(clip, *geo[:2]))
    f = clahe_map(img, tables, tiles, tiles, *geo, out_f32=True,
                  scale=INV_255)
    return enhance_tail(f, radius, 1.5, gf_radius, 1e-3, out_u8=True)


def _planned(img, impl, **params):
    """enhance(img) on its plan: one launch of tpuimg_enhance_run and none
    of the wrappers' entries."""
    before = _count(*PLAN_ENTRIES)
    got = enhance(img, impl=impl, **params)
    assert _count(*PLAN_ENTRIES) == (before[0] + 1, *before[1:])
    return got


@pytest.mark.parametrize("impl", ["fused", "fused1"])
@pytest.mark.parametrize("shape", [(2160, 3840), (4320, 7680), (2161, 3839)])
def test_enhance_plan_equals_the_wrappers(card, shape, impl):
    img = torch.from_numpy(_frame(shape, 140)).to(card)
    want = _composed(img)
    for _ in range(2):  # the call that makes the plan, and one reusing it
        assert torch.equal(_planned(img, impl), want)


@pytest.mark.parametrize("impl", ["fused", "fused1"])
@pytest.mark.parametrize("clip", [0.01, 2.0, 40.0])
@pytest.mark.parametrize("tiles", [4, 8, 16])
def test_enhance_plan_tile_grids_and_clip_limits(card, tiles, clip, impl):
    img = torch.from_numpy(_frame((1080, 1920), 141)).to(card)
    got = _planned(img, impl, clip_limit=clip, tiles=tiles)
    assert torch.equal(got, _composed(img, clip, tiles))


@pytest.mark.parametrize("impl", ["fused", "fused1"])
@pytest.mark.parametrize("gf_radius", [8, 54, 60])
def test_enhance_plan_guided_radii(card, gf_radius, impl):
    """gf r 54 and 60 put walk 1 on its scratch route (rings in the
    workspace)."""
    img = torch.from_numpy(_frame((540, 960), 142)).to(card)
    assert load().tpuimg_enhance_tail_shared(2, gf_radius) == (gf_radius < 45)
    got = _planned(img, impl, gf_radius=gf_radius)
    assert torch.equal(got, _composed(img, gf_radius=gf_radius))


def test_enhance_plan_on_four_streams_at_once(card):
    """Frames on 4 streams at once, as enhance_host's pool runs them, each
    with its own workspace from its stream: each equals the composition."""
    frames = [torch.from_numpy(_frame((2160, 3840), 143 + i)).to(card)
              for i in range(8)]
    want = [_composed(f) for f in frames]
    streams = [torch.cuda.Stream() for _ in range(4)]
    torch.cuda.synchronize()
    outs = []
    for i, f in enumerate(frames):
        with torch.cuda.stream(streams[i % 4]):
            outs.append(_planned(f, "fused" if i % 2 else "fused1"))
    torch.cuda.synchronize()
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)


def test_enhance_plan_after_calls_that_lower_a_kernel_ceiling(card):
    """The shared-memory ceiling of a kernel is the card's, one for every
    caller: a stand-alone tail call at a smaller radius, and a plan made
    at one, set it below what a plan at r 8 launches with. That plan's
    next call raises it again and equals the composition."""
    from tpuimg_torch import pipeline

    img = torch.from_numpy(_frame((540, 960), 150)).to(card)
    want = {r: _composed(img, gf_radius=r) for r in (8, 2)}
    built = pipeline.plans["built"]
    for impl in ("fused", "fused1"):
        assert torch.equal(_planned(img, impl), want[8])
        f = torch.rand((300, 300), device=card)
        enhance_tail(f, 2, 1.5, 2, 1e-3)  # the same walk 1 instance, smaller
        assert torch.equal(_planned(img, impl), want[8])
        assert torch.equal(_planned(img, impl, gf_radius=2), want[2])
        assert torch.equal(_planned(img, impl), want[8])
    assert pipeline.plans["built"] - built <= 4


def test_enhance_plan_is_built_once_a_key(card):
    from tpuimg_torch import pipeline

    img = torch.from_numpy(_frame((300, 517), 151)).to(card)
    before = dict(pipeline.plans)
    for _ in range(3):
        enhance(img, clip_limit=3.25)
    assert pipeline.plans["built"] == before.get("built", 0) + 1
    assert pipeline.plans["reused"] == before.get("reused", 0) + 2

