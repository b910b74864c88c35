"""The port's copy of the NumPy oracles (tpuimg_torch.oracle) against
tpuimg.oracle, bit for bit, on seeded inputs; and the core helpers the copy
needs (pad_mode, gaussian_kernel_2d) against tpuimg.core's."""

import numpy as np
import pytest

import tpuimg.oracle as jax_oracle
import tpuimg.oracle.numpy_ref as jax_ref
import tpuimg_torch.oracle as oracle
import tpuimg_torch.oracle.numpy_ref as ref
from tpuimg.core.borders import pad_mode as jax_pad_mode
from tpuimg.core.kernelgen import gaussian_kernel_2d as jax_kernel_2d
from tpuimg_torch.core.borders import pad_mode
from tpuimg_torch.core.kernelgen import gaussian_kernel_2d
from tpuimg_torch.core.validate import ParamError

SHAPES = [(37, 53), (64, 48), (5, 7)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_exports_match():
    assert sorted(oracle.__all__) == sorted(jax_oracle.__all__)


@pytest.mark.parametrize("shape", SHAPES)
def test_integer_oracles(rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    for name in ("integral_ref", "hist_equalize_ref"):
        _same(getattr(oracle, name)(img), getattr(jax_oracle, name)(img))
    for name in ("erode_ref", "dilate_ref", "open_ref", "close_ref"):
        for r in (1, 3, 9):
            _same(getattr(oracle, name)(img, r),
                  getattr(jax_oracle, name)(img, r))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius,sigma", [(1, 0.8), (2, 1.5), (4, 0.0)])
def test_gaussian_ref(rng, shape, radius, sigma):
    img = rng.random(shape, dtype=np.float32)
    _same(oracle.gaussian_ref(img, radius, sigma),
          jax_oracle.gaussian_ref(img, radius, sigma))


@pytest.mark.parametrize("border", ["shrink", "reflect101"])
@pytest.mark.parametrize("radius", [1, 4, 7])
def test_box_and_guided_ref(rng, border, radius):
    I = rng.random((40, 52), dtype=np.float32)
    p = rng.random((40, 52), dtype=np.float32)
    _same(oracle.box_filter_ref(p, radius, border),
          jax_oracle.box_filter_ref(p, radius, border))
    _same(oracle.guided_filter_ref(I, p, radius, 1e-3, border=border),
          jax_oracle.guided_filter_ref(I, p, radius, 1e-3, border=border))


def test_box_ref_three_channel_and_bad_border(rng):
    x = rng.random((20, 24, 3), dtype=np.float32)
    _same(oracle.box_filter_ref(x, 2), jax_oracle.box_filter_ref(x, 2))
    with pytest.raises(ValueError):
        oracle.box_filter_ref(x, 2, border="zero")


@pytest.mark.parametrize("shape", [(37, 53), (96, 128), (21, 40)])
@pytest.mark.parametrize("tiles,clip", [((2, 2), 1.0), ((8, 8), 2.0),
                                        ((3, 5), 40.0), ((4, 6), 0.5)])
def test_clahe_ref_and_its_stages(rng, shape, tiles, clip):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    xt, yt = tiles
    h, w = shape
    assert ref.clahe_tile_geometry(h, w, xt, yt) == \
        jax_ref.clahe_tile_geometry(h, w, xt, yt)
    hists = ref.clahe_tile_hists_ref(img, xt, yt)
    _same(hists, jax_ref.clahe_tile_hists_ref(img, xt, yt))
    tw, th, _, _ = ref.clahe_tile_geometry(h, w, xt, yt)
    limit = int(tw * th * clip / 256 + 0.5)
    clipped = ref.clahe_clip_ref(hists, limit)
    _same(clipped, jax_ref.clahe_clip_ref(hists, limit))
    _same(ref.clahe_tables_ref(clipped, tw * th),
          jax_ref.clahe_tables_ref(clipped, tw * th))
    _same(oracle.clahe_ref(img, clip, xt, yt),
          jax_oracle.clahe_ref(img, clip, xt, yt))


def test_core_helpers_match_tpuimg():
    for border in ("reflect101", "replicate"):
        assert pad_mode(border) == jax_pad_mode(border)
    with pytest.raises(ParamError):
        pad_mode("shrink")
    for radius, sigma in ((1, 1.0), (3, 0.0), (5, 2.5)):
        _same(gaussian_kernel_2d(radius, sigma),
              jax_kernel_2d(radius, sigma))
        _same(gaussian_kernel_2d(radius, sigma, dtype=np.float64),
              jax_kernel_2d(radius, sigma, dtype=np.float64))
