"""tpuimg_torch's CUDA kernels against their plain PyTorch versions, on the
card, over shapes and parameters that chip_smoke.py does not reach: tiny
tiles, unaligned frames, other radii, the shared-memory limit, the error
paths.

Every test needs a CUDA card and skips without one. On the card, run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use and the card's machine need not have).
"""

import numpy as np
import pytest
import torch

import tpuimg_torch
from tpuimg_torch.core.validate import NotPortedError
from tpuimg_torch.kernels import KernelLaunchError
from tpuimg_torch.kernels.boxsum import enhance_tail, enhance_tail_plain
from tpuimg_torch.kernels.hist import tile_hist, tile_hist_plain
from tpuimg_torch.kernels.lut import clahe_map, clahe_map_plain
from tpuimg_torch.ops.histogram import _clahe_geometry, _clahe_tables
from tpuimg_torch.pipeline import enhance

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
    f = torch.zeros((400, 400), device=card)
    with pytest.raises(KernelLaunchError):
        enhance_tail(f, 16, 5.0, 16, 1e-3)


@pytest.mark.parametrize("shape,tiles,radius,gf_radius", [
    ((270, 480), 8, 2, 8), ((301, 203), 4, 1, 2), ((512, 512), 16, 2, 4)])
def test_enhance_on_card_matches_cpu(card, shape, tiles, radius, gf_radius):
    frame = _frame(shape, 3)
    before = (tile_hist.launches, clahe_map.launches, enhance_tail.launches)
    got = enhance(torch.from_numpy(frame).to(card), 2.0, tiles, radius, 1.5,
                  gf_radius, 1e-3)
    after = (tile_hist.launches, clahe_map.launches, enhance_tail.launches)
    assert all(a == b + 1 for a, b in zip(after, before))
    ref = enhance(torch.from_numpy(frame), 2.0, tiles, radius, 1.5,
                  gf_radius, 1e-3)
    assert got.dtype == torch.uint8 and got.shape == shape
    assert int((got.cpu().int() - ref.int()).abs().max()) <= 1


def test_clahe_on_card_within_one_step_of_cpu(card):
    frame = _frame((300, 420), 4)
    got = tpuimg_torch.clahe(torch.from_numpy(frame).to(card), 3.0, 6, 5)
    ref = tpuimg_torch.clahe(torch.from_numpy(frame), 3.0, 6, 5)
    assert int((got.cpu().int() - ref.int()).abs().max()) <= 1


def test_unported_paths_raise_on_card(card):
    img = torch.from_numpy(_frame((64, 64))).to(card)
    f = img.float() / 255
    with pytest.raises(NotPortedError):
        enhance(img, impl="staged")
    small = torch.from_numpy(_frame((30, 40))).to(card)
    with pytest.raises(NotPortedError):
        enhance(small)  # 30 <= 2*(2*8 + 2): below the tail kernel's gate
    with pytest.raises(NotPortedError):
        tpuimg_torch.gaussian(f, 2, 1.5)
    with pytest.raises(NotPortedError):
        tpuimg_torch.guided_filter(f, f, 4, 1e-3, border="reflect101")


def test_wrappers_check_their_inputs(card):
    img = torch.from_numpy(_frame((64, 96))).to(card)
    with pytest.raises(ValueError, match="contiguous"):
        tile_hist(img.t(), 4, 4, 24, 16, 0, 0)
    with pytest.raises(ValueError, match="uint8"):
        tile_hist(img.float(), 4, 4, 16, 24, 0, 0)
    with pytest.raises(ValueError, match="float32"):
        enhance_tail(img.double(), 2, 1.5, 8, 1e-3)
    with pytest.raises(ValueError, match="tables"):
        clahe_map(img, torch.zeros((3, 256), device=card), 4, 4, 16, 24, 0, 0)


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
