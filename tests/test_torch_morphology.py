"""tpuimg_torch's erode, dilate, morph_open and morph_close against tpuimg's,
on the CPU, bit for bit.

On a CPU tensor the kernel wrappers run their plain versions; these tests
hold them to the JAX package's Pallas kernels (interpret mode on the CPU
backend, as tests/test_pallas_kernels.py runs them), its XLA path and the
NumPy oracles: u8 at the radii of KNOWN_DIVERGENCES section 6, int32 with
its extremes, float32 with NaNs (which propagate), frames smaller than the
structuring element, batches, and the typed errors.
"""

import numpy as np
import pytest
import torch

import tpuimg
import tpuimg_torch
from tpuimg.kernels.sep_stencil import morph_pallas_ypadded, open_close_pallas
from tpuimg.oracle import close_ref, dilate_ref, erode_ref, open_ref
from tpuimg_torch import kernels
from tpuimg_torch.kernels import SMEM_MAX_BYTES
from tpuimg_torch.kernels.sep_stencil import (
    OPEN_CLOSE_PAIR_BYTES, OPEN_CLOSE_TILES, morph_max_radius, morph_smem,
    morph_tile, morph_ypadded_kernel, morphology_kernel, morphology_plain,
    open_close_kernel, open_close_max_radius, open_close_plain,
    open_close_smem, open_close_tile, pad_replicate)

OPS = ["erode", "dilate", "morph_open", "morph_close"]
RADII = [1, 2, 3, 6, 7, 8, 15, 25, 31]


def _same(got, ref):
    """Equal values and dtype, NaNs in the same places (+0 equals -0)."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype.kind == "f":
        nan = np.isnan(ref)
        np.testing.assert_array_equal(np.isnan(got), nan)
        got, ref = got[~nan], ref[~nan]
    np.testing.assert_array_equal(got, ref)


def _port(op, x, radius):
    return getattr(tpuimg_torch, op)(torch.from_numpy(x), radius).numpy()


@pytest.mark.parametrize("radius", RADII)
def test_erode_dilate_u8_match_pallas_and_oracle(rng, radius):
    img = rng.integers(0, 256, (75, 183), dtype=np.uint8)
    for op, oracle in (("erode", erode_ref), ("dilate", dilate_ref)):
        got = _port(op, img, radius)
        _same(got, getattr(tpuimg, op)(img, radius, impl="pallas"))
        _same(got, oracle(img, radius))


def _int32_frame(rng, shape):
    x = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
        np.int32)
    x.flat[::17] = np.iinfo(np.int32).min
    x.flat[5::23] = np.iinfo(np.int32).max
    return x


def _nan_frame(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x.flat[rng.choice(x.size, 4, replace=False)] = np.nan
    x.flat[::31] = -0.0
    x.flat[3::37] = np.inf
    return x


@pytest.mark.parametrize("radius", [1, 2, 13])
@pytest.mark.parametrize("op", OPS)
def test_int32_and_float32_nan_match_tpuimg(rng, op, radius):
    for x in (_int32_frame(rng, (20, 30)), _nan_frame(rng, (20, 30))):
        _same(_port(op, x, radius), getattr(tpuimg, op)(x, radius))


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
def test_erode_matches_pallas_in_every_dtype(rng, dtype):
    x = {"uint8": lambda: rng.integers(0, 256, (40, 70), dtype=np.uint8),
         "int32": lambda: _int32_frame(rng, (40, 70)),
         "float32": lambda: _nan_frame(rng, (40, 70))}[dtype]()
    for op in ("erode", "dilate"):
        _same(_port(op, x, 3), getattr(tpuimg, op)(x, 3, impl="pallas"))


@pytest.mark.parametrize("op,radius,want", [
    ("erode", 2, 25), ("dilate", 13, 540), ("morph_open", 2, 81),
    ("morph_close", 2, 81)])
def test_nan_spreads_over_the_window(rng, op, radius, want):
    """One NaN in a 20x30 frame spreads over its clamped window (27x20 at
    r13), and open and close spread it twice, in tpuimg and in the port."""
    x = rng.random((20, 30), dtype=np.float32)
    x[10, 15] = np.nan
    got = _port(op, x, radius)
    assert int(np.isnan(got).sum()) == want
    _same(got, getattr(tpuimg, op)(x, radius))


@pytest.mark.parametrize("shape,radius", [((10, 200), 15), ((5, 6), 40),
                                          ((1, 1), 3), ((1, 9), 2),
                                          ((7, 1), 4)])
@pytest.mark.parametrize("op", OPS)
def test_frames_smaller_than_the_element(rng, op, shape, radius):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = _port(op, img, radius)
    assert got.shape == shape
    _same(got, getattr(tpuimg, op)(img, radius))


@pytest.mark.parametrize("shape", [(3, 30, 42), (2, 2, 20, 30)])
@pytest.mark.parametrize("op", OPS)
def test_batches_match_tpuimg(rng, op, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = _port(op, img, 4)
    _same(got, getattr(tpuimg, op)(img, 4))
    flat = img.reshape((-1,) + shape[-2:])
    one = np.stack([_port(op, f, 4) for f in flat]).reshape(shape)
    _same(got, one)


@pytest.mark.parametrize("radius", [1, 3, 8, 15])
def test_open_close_match_pallas_and_oracle(rng, radius):
    """The fused form's semantics: stage 2's replicate border acts on the
    stage-1 result (also where 2r > h)."""
    for shape in [(97, 201), (15, 33)]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for mode, oracle in ((0, open_ref), (1, close_ref)):
            got = open_close_kernel(torch.from_numpy(img), radius,
                                    mode).numpy()
            _same(got, open_close_pallas(img, radius, mode))
            _same(got, oracle(img, radius))


@pytest.mark.parametrize("seed", range(6))
def test_random_shapes_match_oracle(seed):
    """autoTestDemo-style: a random frame, batch and radius per seed, the
    four ops against the NumPy oracles frame by frame."""
    g = np.random.default_rng(300 + seed)
    h, w = (int(v) for v in g.integers(1, 60, 2))
    b, radius = int(g.integers(1, 4)), int(g.integers(1, 21))
    img = g.integers(0, 256, (b, h, w), dtype=np.uint8)
    for op, oracle in (("erode", erode_ref), ("dilate", dilate_ref),
                       ("morph_open", open_ref), ("morph_close", close_ref)):
        got = _port(op, img, radius)
        _same(got, np.stack([oracle(f, radius) for f in img]))


def test_dtype_narrowing_follows_tpuimg(rng):
    """float64 comes out float32 and int64 int32, as through jnp.asarray."""
    f64 = rng.random((12, 14))
    i64 = rng.integers(-1000, 1000, (12, 14))
    for x, want in ((f64, torch.float32), (i64, torch.int32)):
        for op in OPS:
            got = getattr(tpuimg_torch, op)(torch.from_numpy(x), 2)
            assert got.dtype == want
            _same(got.numpy(), getattr(tpuimg, op)(x, 2))


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", ["int16", "uint16", "bool", "float16",
                                  "radius_0", "radius_float", "radius_bool",
                                  "one_dim"])
@pytest.mark.parametrize("op", OPS)
def test_same_typed_errors_as_tpuimg(op, case):
    x = np.zeros((6, 8), np.uint8)
    arr, radius = {
        "int16": (x.astype(np.int16), 1), "uint16": (x.astype(np.uint16), 1),
        "bool": (x.astype(bool), 1), "float16": (x.astype(np.float16), 1),
        "radius_0": (x, 0), "radius_float": (x, 2.0),
        "radius_bool": (x, True), "one_dim": (x[0], 1)}[case]
    theirs = _raised(lambda: getattr(tpuimg, op)(arr, radius))
    ours = _raised(lambda: getattr(tpuimg_torch, op)(torch.from_numpy(arr),
                                                     radius))
    assert ours == theirs


def test_plain_versions_compose_and_pad(rng):
    x = torch.from_numpy(rng.integers(0, 256, (9, 11), dtype=np.uint8))
    p = pad_replicate(x, 20)
    assert p.shape == (49, 51)
    assert torch.equal(p[:21, :21], x[0, 0].expand(21, 21))
    assert torch.equal(open_close_plain(x, 2, 1),
                       morphology_plain(morphology_plain(x, 2, 1), 2, 0))


def test_wrappers_take_plain_version_on_cpu(rng):
    entries = ("tpuimg_morphology", "tpuimg_open_close")
    before = [kernels.launches[e] for e in entries]
    x = torch.from_numpy(rng.integers(0, 256, (30, 40), dtype=np.uint8))
    for op in OPS:
        getattr(tpuimg_torch, op)(x, 3)
    assert [kernels.launches[e] for e in entries] == before == [0, 0]


def test_wrappers_raise_off_the_cpu(monkeypatch):
    """A tensor off the CPU never runs the plain versions; a bad mode is a
    ParamError."""
    from tpuimg_torch.kernels import sep_stencil

    def must_not_run(*args, **kwargs):
        raise AssertionError("a plain version ran off the CPU")

    monkeypatch.setattr(sep_stencil, "morphology_plain", must_not_run)
    monkeypatch.setattr(sep_stencil, "open_close_plain", must_not_run)
    meta = torch.empty((64, 64), dtype=torch.uint8, device="meta")
    for op in OPS:
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            getattr(tpuimg_torch, op)(meta, 3)
    with pytest.raises(tpuimg_torch.core.validate.ParamError, match="mode"):
        morphology_kernel(torch.zeros((4, 4)), 1, 2)


@pytest.mark.parametrize("dtype,ceiling", [(torch.uint8, 93),
                                           (torch.int32, 44),
                                           (torch.float32, 44)])
def test_open_close_tile_planner(dtype, ceiling):
    """open_close_tile picks the largest tile whose footprint lets two blocks
    share an SM, else the largest that fits a block, else None; the fused
    kernel's ceiling follows from it per dtype."""
    size = torch.empty((), dtype=dtype).element_size()
    assert open_close_max_radius(dtype) == ceiling
    for r in range(0, ceiling + 2):
        tile = open_close_tile(r, size)
        assert (tile is None) == (r > ceiling)
        if tile is None:
            continue
        e = tile + 4 * r
        words = [(n * size + 3) // 4 | 1 for n in (e, tile + 2 * r)]
        assert open_close_smem(tile, r, size) == 4 * e * sum(words)
        assert open_close_smem(tile, r, size) <= SMEM_MAX_BYTES
        bigger = [t for t in OPEN_CLOSE_TILES if t > tile]
        for t in bigger:  # a larger tile would lose the pair, or not fit
            assert open_close_smem(t, r, size) > (
                OPEN_CLOSE_PAIR_BYTES if open_close_smem(tile, r, size)
                <= OPEN_CLOSE_PAIR_BYTES else SMEM_MAX_BYTES)
    assert open_close_tile(15, 1) == 128 and open_close_tile(15, 4) == 64


def _gil_werman(x, k, fn, ident):
    """open_close.cu's window_pass along the last axis: out[j] = fn over
    x[j .. j + k - 1], each thread's block of k outputs from the suffix
    extremes of its inputs and the prefix extremes of the next block's."""
    n_out = x.shape[-1] - k + 1
    out = np.empty(x.shape[:-1] + (n_out,), x.dtype)
    for j0 in range(0, n_out, k):
        n = min(k, n_out - j0)
        h = np.full(x.shape[:-1], ident, x.dtype)
        for p in range(j0 + k - 1, j0 - 1, -1):
            h = fn(x[..., p], h)
            if p < j0 + n:
                out[..., p] = h
        g = np.full(x.shape[:-1], ident, x.dtype)
        for t in range(1, n):
            g = fn(g, x[..., j0 + k - 1 + t])
            out[..., j0 + t] = fn(out[..., j0 + t], g)
    return out


def _open_close_model(x, r, mode):
    """The kernel's four passes in NumPy: stage 1 along the rows, stage 1
    then stage 2 down the columns, stage 2 along the rows, with each pass's
    identity outside the frame (the truncated window a replicate border
    gives a min or max)."""
    lo, hi = ((np.iinfo(x.dtype).max, np.iinfo(x.dtype).min)
              if x.dtype.kind in "iu" else (np.inf, -np.inf))
    fns = (np.minimum, np.maximum)
    f1, f2 = fns[mode], fns[1 - mode]
    id1, id2 = ((lo, hi) if mode == 0 else (hi, lo))
    k = 2 * r + 1
    p = np.pad(x, 2 * r, constant_values=id1)
    rows = _gil_werman(p, k, f1, id1)                       # (H+4r, W+2r)
    s1 = _gil_werman(rows.T, k, f1, id1).T                  # (H+2r, W+2r)
    s1[:r] = id2
    s1[s1.shape[0] - r:] = id2
    cols = _gil_werman(s1.T, k, f2, id2).T                  # (H, W+2r)
    cols[:, :r] = id2
    cols[:, cols.shape[1] - r:] = id2
    return _gil_werman(cols, k, f2, id2)                    # (H, W)


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("shape,radius", [((1, 9), 2), ((13, 1), 3),
                                          ((17, 23), 4), ((30, 26), 7),
                                          ((9, 40), 15)])
def test_open_close_kernel_model_matches_oracle(rng, dtype, shape, radius):
    """The redesigned kernel's decomposition (van Herk/Gil-Werman windows,
    truncated by identities, the column passes fused) equals tpuimg's open
    and close oracles, NaNs in place, on frames of one row or column and
    radii whose 2r + 1 divides no line."""
    if dtype == "uint8":
        x = rng.integers(0, 256, shape, dtype=np.uint8)
    elif dtype == "int32":
        x = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
            np.int32)
        x.flat[::7] = np.iinfo(np.int32).min
        x.flat[3::11] = np.iinfo(np.int32).max
    else:
        x = rng.standard_normal(shape).astype(np.float32)
        x.flat[::5] = -0.0
        x.flat[rng.integers(0, x.size, 2)] = (np.nan, np.inf)
    for mode, ref in ((0, open_ref), (1, close_ref)):
        _same(_open_close_model(x, radius, mode), ref(x, radius))


def _identities(dtype):
    """(the min's identity, the max's) for a NumPy dtype."""
    if dtype.kind in "iu":
        return np.iinfo(dtype).max, np.iinfo(dtype).min
    return np.inf, -np.inf


def _morph_tile_model(x, r, mode, tile, yoff=0):
    """csrc/morphology.cu's tile route in NumPy: for each tile x tile block
    of outputs, the (tile + 2r)^2 extent from source rows y0 + yoff - r ..
    and columns x0 - r .., the pass's identity outside the frame (the
    truncated window a replicate border gives a min or max), a van
    Herk/Gil-Werman pass along the rows, then one down the columns. yoff = r
    is the row-padded entry: x holds h + 2r rows for h outputs."""
    fn = (np.minimum, np.maximum)[mode]
    ident = _identities(x.dtype)[mode]
    k = 2 * r + 1
    hin, w = x.shape
    h = hin - 2 * yoff
    e = tile + 2 * r
    out = np.empty((h, w), x.dtype)
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            ext = np.full((e, e), ident, x.dtype)
            ys = np.arange(y0 + yoff - r, y0 + yoff - r + e)
            xs = np.arange(x0 - r, x0 - r + e)
            yi, xi = (ys >= 0) & (ys < hin), (xs >= 0) & (xs < w)
            ext[np.ix_(yi, xi)] = x[np.ix_(ys[yi], xs[xi])]
            rows = _gil_werman(ext, k, fn, ident)             # (e, tile)
            cols = _gil_werman(rows.T, k, fn, ident).T        # (tile, tile)
            th, tw = min(tile, h - y0), min(tile, w - x0)
            out[y0:y0 + th, x0:x0 + tw] = cols[:th, :tw]
    return out


def _model_frame(rng, dtype, shape):
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if dtype == "int32":
        return _int32_frame(rng, shape)
    x = rng.standard_normal(shape).astype(np.float32)
    x.flat[::5] = -0.0
    x.flat[rng.integers(0, x.size, 3)] = (np.nan, np.inf, -np.inf)
    return x


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("shape,radius,tile", [
    ((1, 9), 2, 4), ((13, 1), 3, 4), ((1, 1), 3, 16), ((17, 23), 4, 8),
    ((30, 26), 7, 16), ((9, 40), 15, 16), ((21, 35), 6, 8)])
def test_morphology_kernel_model_matches_oracle(rng, dtype, shape, radius,
                                                tile):
    """The redesigned erode/dilate tiles (identity outside the frame, van
    Herk/Gil-Werman along the rows, then down the columns) equal tpuimg's
    erode and dilate oracles, NaNs in place, on frames of one row or column,
    tiles cut by the frame's edge, and radii whose 2r + 1 divides no line."""
    x = _model_frame(rng, dtype, shape)
    for mode, ref in ((0, erode_ref), (1, dilate_ref)):
        _same(_morph_tile_model(x, radius, mode, tile), ref(x, radius))


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("shape,radius,tile", [
    ((1, 9), 2, 4), ((5, 1), 3, 4), ((17, 23), 4, 8), ((12, 40), 7, 16)])
def test_morph_ypadded_kernel_model_matches_pallas(rng, dtype, shape, radius,
                                                   tile):
    """The row-padded entry's tiles (rows from the block at offset r, only
    x truncated) equal tpuimg's morph_pallas_ypadded in interpret mode and
    the port's plain version."""
    h, w = shape
    p = _model_frame(rng, dtype, (h + 2 * radius, w))
    for mode in (0, 1):
        got = _morph_tile_model(p, radius, mode, tile, yoff=radius)
        _same(got, morph_pallas_ypadded(p, radius, mode))
        _same(got, morph_ypadded_kernel(torch.from_numpy(p), radius,
                                        mode).numpy())


@pytest.mark.parametrize("dtype,ceiling", [(torch.uint8, 191),
                                           (torch.int32, 96),
                                           (torch.float32, 96)])
def test_morph_tile_planner(dtype, ceiling):
    """morph_tile (csrc/morphology.cu morph_tile) picks the largest tile
    whose footprint lets two blocks share an SM, unless the largest tile
    that fits a block stages less than half as many elements an output
    ((t + 2r)^2 / t^2); tiles narrower than 64 only up to r = 96, else
    None. The tile route's ceiling follows per dtype and never falls below
    the r = 96 of the 32x32 tiles it replaced."""
    size = torch.empty((), dtype=dtype).element_size()
    assert morph_max_radius(dtype) == ceiling >= 96
    for r in range(0, ceiling + 2):
        tile = morph_tile(r, size)
        assert (tile is None) == (r > ceiling)
        if tile is None:
            continue
        e = tile + 2 * r
        words = [(n * size + 3) // 4 | 1 for n in (e, tile)]
        assert morph_smem(tile, r, size) == 4 * e * sum(words)
        assert morph_smem(tile, r, size) <= SMEM_MAX_BYTES
        fits = [t for t in OPEN_CLOSE_TILES
                if morph_smem(t, r, size) <= SMEM_MAX_BYTES]
        pair = [t for t in fits
                if morph_smem(t, r, size) <= OPEN_CLOSE_PAIR_BYTES]
        assert tile >= 64 or r <= 96
        if not pair:
            assert tile == fits[0]
            continue

        def halves(big, small):  # big stages under half of small's an output
            return 2 * (big + 2 * r) ** 2 * small ** 2 < (
                (small + 2 * r) ** 2 * big ** 2)

        assert tile == (fits[0] if halves(fits[0], pair[0]) else pair[0])
    assert morph_tile(15, 1) == 128 and morph_tile(15, 4) == 64
    assert morph_tile(64, 4) == 64  # not the two-block 16, 9x the staging
    assert morph_tile(96, 4) == 32 and morph_tile(97, 4) is None
    assert morph_tile(191, 1) == 64 and morph_tile(192, 1) is None
