"""tpuimg_torch.parallel and the row-padded ops against tpuimg's, on the CPU.

The port's mesh repeats the CPU device eight times; tpuimg's runs on the
eight virtual JAX devices of tests/conftest.py. On CPU tensors the kernel
wrappers run their plain versions; tpuimg's ypadded ops run their Pallas
kernels in interpret mode, as its own tests/test_parallel.py runs them. The
sizes are test_parallel.py's, the tolerances its: gaussian 1e-6, guided
1e-5, CLAHE and enhance 1 step, the rest bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuimg
import tpuimg_torch
from tpuimg import parallel as jpar
from tpuimg.core.borders import REFLECT101, REPLICATE
from tpuimg.kernels.lut import clahe_band_map as jax_band_map
from tpuimg.ops.gaussian import gaussian_ypadded as jax_gaussian_ypadded
from tpuimg.ops.guided import box_filter_ypadded as jax_box_ypadded
from tpuimg.ops.guided import guided_ypadded as jax_guided_ypadded
from tpuimg.ops.histogram import _tile_coord_runs
from tpuimg.ops.morphology import morph_ypadded as jax_morph_ypadded
from tpuimg_torch import parallel as tpar
from tpuimg_torch.core.validate import (
    DeviceError, DTypeError, ParamError)
from tpuimg_torch.kernels.lut import clahe_band_map, clahe_map_plain
from tpuimg_torch.ops.gaussian import gaussian_ypadded
from tpuimg_torch.ops.guided import box_filter_ypadded, guided_ypadded
from tpuimg_torch.ops.histogram import _clahe_front
from tpuimg_torch.ops.morphology import morph_ypadded

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return jpar.make_mesh(2, 4), tpar.make_mesh(2, 4, devices=CPU8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return (x.gather() if isinstance(x, tpar.Sharded) else x).numpy()


def _steps(a, b):
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


def _same(got, ref):
    """Equal values and dtype, NaNs in the same places."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype.kind == "f":
        nan = np.isnan(ref)
        np.testing.assert_array_equal(np.isnan(got), nan)
        got, ref = got[~nan], ref[~nan]
    np.testing.assert_array_equal(got, ref)


# --- the row-padded ops, one block --------------------------------------


@pytest.mark.parametrize("shape,radius", [((68, 96), 2), ((2, 19, 40), 3),
                                          ((11, 7), 5)])
def test_gaussian_ypadded_matches_tpuimg(rng, shape, radius):
    p = rng.random(shape, dtype=np.float32)
    got = gaussian_ypadded(_t(p), radius, 1.5).numpy()
    ref = np.asarray(jax_gaussian_ypadded(p, radius, 1.5))
    assert got.shape == ref.shape == shape[:-2] + (shape[-2] - 2 * radius,
                                                   shape[-1])
    assert np.abs(got - ref).max() <= 1e-6


def _morph_input(rng, dtype, shape):
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if dtype == "int32":
        x = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
            np.int32)
        x.flat[::17] = np.iinfo(np.int32).min
        return x
    x = rng.standard_normal(shape).astype(np.float32)
    x.flat[rng.choice(x.size, 3, replace=False)] = np.nan
    x.flat[::29] = -np.inf
    return x


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("radius,shape", [(1, (20, 80)), (3, (2, 22, 37)),
                                          (15, (36, 64))])
def test_morph_ypadded_matches_tpuimg(rng, dtype, radius, shape):
    p = _morph_input(rng, dtype, shape)
    for mode in (0, 1):
        _same(morph_ypadded(_t(p), radius, mode).numpy(),
              jax_morph_ypadded(p, radius, mode))


@pytest.mark.parametrize("radius", [2, 4])
def test_guided_ypadded_matches_tpuimg(rng, radius):
    Ip = rng.random((40 + 4 * radius, 96), dtype=np.float32)
    pp = rng.random(Ip.shape, dtype=np.float32)
    got = guided_ypadded(_t(Ip), _t(pp), radius, 1e-3).numpy()
    ref = np.asarray(jax_guided_ypadded(Ip, pp, radius, 1e-3))
    assert got.shape == ref.shape == (40, 96)
    assert np.abs(got - ref).max() <= 1e-5
    # the self-guided form: the same tensor twice
    x = _t(Ip)
    got = guided_ypadded(x, x, radius, 1e-3).numpy()
    jx = jnp.asarray(Ip)
    ref = np.asarray(jax_guided_ypadded(jx, jx, radius, 1e-3))
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("radius", [2, 7])
def test_box_filter_ypadded_matches_tpuimg(rng, radius):
    p = rng.random((3, 30 + 2 * radius, 50), dtype=np.float32)
    got = box_filter_ypadded(_t(p), radius).numpy()
    ref = np.asarray(jax_box_ypadded(p, radius))
    assert got.shape == ref.shape == (3, 30, 50)
    assert np.abs(got - ref).max() <= 1e-6


def test_ypadded_ops_refuse_thin_blocks():
    with pytest.raises(ValueError, match="> 2\\*radius rows"):
        gaussian_ypadded(torch.zeros(4, 9), 2, 1.5)
    with pytest.raises(ValueError, match="> 2\\*radius rows"):
        morph_ypadded(torch.zeros(6, 9, dtype=torch.uint8), 3, 0)
    with pytest.raises(ValueError, match="> 4\\*radius rows"):
        x = torch.zeros(8, 9)
        guided_ypadded(x, x, 2, 1e-3)
    with pytest.raises(ValueError, match="> 2\\*radius rows"):
        box_filter_ypadded(torch.zeros(2, 9), 1)


@pytest.mark.parametrize("self_guided", [False, True])
@pytest.mark.parametrize("radius", [17, 20])
def test_guided_ypadded_large_radius_matches_tpuimg(rng, radius, self_guided):
    """Past tpuimg_torch's former r <= 16 ceiling, as tpuimg runs it."""
    Ip = rng.random((40 + 4 * radius, 96), dtype=np.float32)
    if self_guided:
        x, jx = _t(Ip), jnp.asarray(Ip)
        got = guided_ypadded(x, x, radius, 1e-3).numpy()
        ref = np.asarray(jax_guided_ypadded(jx, jx, radius, 1e-3))
    else:
        pp = rng.random(Ip.shape, dtype=np.float32)
        got = guided_ypadded(_t(Ip), _t(pp), radius, 1e-3).numpy()
        ref = np.asarray(jax_guided_ypadded(Ip, pp, radius, 1e-3))
    assert got.shape == ref.shape == (40, 96)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5


# --- the band mapping ----------------------------------------------------


@pytest.mark.parametrize("shape,tiles", [((64, 96), 8), ((18, 64), 16),
                                         ((45, 70), 3)])
def test_clahe_band_map_matches_tpuimg(rng, shape, tiles):
    """Each y-run band of the frame through both band kernels: tpuimg's
    with its (n_xruns, 4, 256) bank, the port's with the frame's tables."""
    h, w = shape
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    tables, th, tw, pt, pl = _clahe_front(_t(img), 3.0, tiles, tiles)
    tnp = tables.numpy()
    xruns = _tile_coord_runs(w, tiles, tw, pl, use_recip=True)
    xinfo = [(x0, x1, tx1) for x0, x1, tx1, _, _ in xruns]
    inv_tw = float(np.float32(1.0) / np.float32(tw))
    for y0, y1, ty1, ty2, _ in _tile_coord_runs(h, tiles, th, pt, False):
        idx = []
        for _x0, _x1, tx1, tx2, _ in xruns:
            idx += [ty1 * tiles + tx1, ty1 * tiles + tx2,
                    ty2 * tiles + tx1, ty2 * tiles + tx2]
        bank = jnp.asarray(tnp[idx].reshape(len(xruns), 4, 256))
        ref = np.asarray(jax_band_map(
            jnp.asarray(img[y0:y1]), bank, xinfo, y0=float(y0),
            pad_top=float(pt), th=float(th), ty1=float(ty1),
            pad_left=float(pl), inv_tw=inv_tw))
        got = clahe_band_map(_t(img[y0:y1]), tables, tiles, tiles, th, tw,
                             pt, pl, y0).numpy()
        assert got.dtype == np.uint8 and _steps(got, ref) <= 1, (y0, y1)


def test_clahe_band_map_is_the_frame_blend_at_y0(rng):
    # any band, across y-runs, is the whole-frame blend's rows, bit for bit
    img = rng.integers(0, 256, (90, 110), dtype=np.uint8)
    tables, th, tw, pt, pl = _clahe_front(_t(img), 2.0, 8, 8)
    full = clahe_map_plain(_t(img), tables, 8, 8, th, tw, pt, pl,
                           out_f32=True)
    for y0, y1 in [(0, 90), (13, 41), (89, 90)]:
        band = clahe_band_map(_t(img[y0:y1]), tables, 8, 8, th, tw, pt, pl,
                              y0, out_f32=True)
        assert torch.equal(band, full[y0:y1])


# --- the sharded ops against tpuimg.parallel ------------------------------


def test_gaussian_sharded_matches_tpuimg(rng, meshes):
    jm, tm = meshes
    img = rng.random((64, 96), dtype=np.float32)
    ref = jax.jit(jpar.stencil_sharded(functools.partial(
        jax_gaussian_ypadded, radius=2, sigma=1.5), 2, REFLECT101, jm))(
        jpar.shard_rows(jm, img))
    got = tpar.stencil_sharded(functools.partial(
        gaussian_ypadded, radius=2, sigma=1.5), 2, REFLECT101, tm)(
        tpar.shard_rows(tm, _t(img)))
    assert np.abs(_np(got) - np.asarray(ref)).max() < 1e-6
    # and the unsharded op
    assert np.abs(_np(got) - tpuimg_torch.gaussian(_t(img), 2, 1.5).numpy()
                  ).max() < 1e-6


def test_erode_sharded_matches_tpuimg(rng, meshes):
    jm, tm = meshes
    img = rng.integers(0, 256, (64, 80), dtype=np.uint8)
    ref = jax.jit(jpar.stencil_sharded(functools.partial(
        jax_morph_ypadded, radius=3, mode=0), 3, REPLICATE, jm))(
        jpar.shard_rows(jm, img))
    got = tpar.stencil_sharded(functools.partial(
        morph_ypadded, radius=3, mode=0), 3, REPLICATE, tm)(_t(img))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    np.testing.assert_array_equal(_np(got),
                                  tpuimg_torch.erode(_t(img), 3).numpy())


def test_stencil_sharded_batch(rng, meshes):
    # (B, H, W) over (data, sp), from shard_batch's placement
    _, tm = meshes
    frames = rng.random((4, 32, 48), dtype=np.float32)
    got = tpar.stencil_sharded(functools.partial(
        gaussian_ypadded, radius=2, sigma=1.5), 2, REFLECT101, tm)(
        tpar.shard_batch(tm, _t(frames)))
    assert got.batch and len(got.blocks) == 2 and len(got.blocks[0]) == 4
    ref = tpuimg.gaussian(frames, 2, 1.5)
    assert np.abs(_np(got) - np.asarray(ref)).max() < 1e-6
    dil = tpar.stencil_sharded(functools.partial(
        morph_ypadded, radius=4, mode=1), 4, REPLICATE, tm)(
        _t((frames * 255).astype(np.uint8)))
    np.testing.assert_array_equal(
        _np(dil), np.asarray(tpuimg.dilate((frames * 255).astype(np.uint8),
                                           4)))


def test_integral_sharded_exact(rng, meshes):
    jm, tm = meshes
    img = rng.integers(0, 256, (64, 72), dtype=np.uint8)
    ref = jax.jit(jpar.integral_sharded(jm))(jpar.shard_rows(jm, img))
    got = tpar.integral_sharded(tm)(tpar.shard_rows(tm, _t(img)))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    batch = rng.integers(0, 256, (2, 16, 24), dtype=np.uint8)
    np.testing.assert_array_equal(
        _np(tpar.integral_sharded(tm)(_t(batch))),
        np.asarray(tpuimg.integral(batch)))


def test_he_sharded_exact(rng, meshes):
    jm, tm = meshes
    img = rng.integers(0, 256, (64, 72), dtype=np.uint8)
    ref = jax.jit(jpar.hist_equalize_sharded(jm))(jpar.shard_rows(jm, img))
    got = tpar.hist_equalize_sharded(tm)(tpar.shard_rows(tm, _t(img)))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    # per-frame tables for a batch, never reduced over data
    batch = rng.integers(0, 256, (4, 16, 40), dtype=np.uint8)
    batch[1] //= 4
    ref = jax.jit(jpar.hist_equalize_sharded(jm))(jpar.shard_batch(jm, batch))
    got = tpar.hist_equalize_sharded(tm)(tpar.shard_batch(tm, _t(batch)))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_guided_sharded_matches_tpuimg(rng, meshes):
    jm, tm = meshes
    I = rng.random((64, 96), dtype=np.float32)
    p = rng.random((64, 96), dtype=np.float32)
    for r in (2, 7):
        ref = jax.jit(jpar.guided_filter_sharded(jm, r, 1e-3))(
            jpar.shard_rows(jm, I), jpar.shard_rows(jm, p))
        got = tpar.guided_filter_sharded(tm, r, 1e-3)(
            tpar.shard_rows(tm, _t(I)), _t(p))
        assert np.abs(_np(got) - np.asarray(ref)).max() < 1e-5, r


def test_guided_sharded_large_radius_matches_tpuimg(rng):
    """r = 20 > 16 over (1, 2): each 96-row shard takes a 40-row halo."""
    jm = jpar.make_mesh(1, 2)
    tm = tpar.make_mesh(1, 2, devices=CPU8[:2])
    I = rng.random((192, 96), dtype=np.float32)
    p = rng.random((192, 96), dtype=np.float32)
    ref = jax.jit(jpar.guided_filter_sharded(jm, 20, 1e-3))(
        jpar.shard_rows(jm, I), jpar.shard_rows(jm, p))
    got = tpar.guided_filter_sharded(tm, 20, 1e-3)(
        tpar.shard_rows(tm, _t(I)), _t(p))
    assert _np(got).shape == (192, 96)
    assert np.abs(_np(got) - np.asarray(ref)).max() <= 1e-5


def test_guided_sharded_self_guided(rng, meshes):
    jm, tm = meshes
    I = rng.random((64, 96), dtype=np.float32)
    ref = jax.jit(jpar.guided_filter_sharded(jm, 4, 1e-3, self_guided=True))(
        jpar.shard_rows(jm, I))
    Is = tpar.shard_rows(tm, _t(I))
    for got in (tpar.guided_filter_sharded(tm, 4, 1e-3, self_guided=True)(Is),
                tpar.guided_filter_sharded(tm, 4, 1e-3)(Is, Is)):
        assert np.abs(_np(got) - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize("h,grid,clip", [
    (64, (8, 8), 2.0), (64, (6, 6), 3.0), (64, (4, 8), 40.0),
    (36, (4, 16), 4.0), (70, (4, 4), 4.0), (45, (3, 5), 4.0)])
def test_clahe_sharded_matches_tpuimg(rng, meshes, h, grid, clip):
    # 64 rows: 16 a shard, tile rows aligned (8x8) and not (6x6); 36 rows
    # with 16 y-tiles: pads span tiles; 70 and 45: H not a shard multiple
    jm, tm = meshes
    w = 64 if h == 36 else 96
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref = np.asarray(jax.jit(jpar.clahe_sharded(jm, clip, *grid))(
        jnp.asarray(img)))
    got = tpar.clahe_sharded(tm, clip, *grid)(_t(img))
    assert _np(got).shape == ref.shape == (h, w)
    assert _steps(_np(got), ref) <= 1
    assert _steps(_np(got), tpuimg_torch.clahe(_t(img), clip, *grid)) <= 1


@pytest.mark.parametrize("shape,args", [
    ((96, 128), (2.0, 4, 2, 1.5, 4, 1e-3)),
    ((90, 96), (4.0, 3, 1, 1.0, 4, 1e-2)),
    ((160, 96), (2.0, 4, 2, 1.5, 17, 1e-3))])
def test_enhance_sharded_matches_tpuimg(rng, meshes, shape, args):
    # 90 rows do not divide over sp = 4: reflect-padded and cropped; 160
    # rows over sp = 4 hold gf_radius 17's reach of 2*17 + 2
    jm, tm = meshes
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jax.jit(jpar.enhance_sharded(jm, *args))(
        jnp.asarray(img)))
    got = tpar.enhance_sharded(tm, *args)(_t(img))
    assert _np(got).shape == ref.shape == shape
    assert _np(got).dtype == np.uint8
    assert _steps(_np(got), ref) <= 1
    staged = tpuimg_torch.enhance(_t(img), *args, impl="staged").numpy()
    assert _steps(_np(got), staged) <= 1


# --- contracts -------------------------------------------------------------


def test_halo_exchange_rejects_thin_shards(rng, meshes):
    _, tm = meshes
    img = _t(rng.random((16, 96), dtype=np.float32))  # 4 rows a shard < 6
    op = tpar.stencil_sharded(functools.partial(
        gaussian_ypadded, radius=6, sigma=2.0), 6, REFLECT101, tm)
    with pytest.raises(ValueError, match="halo exchange"):
        op(tpar.shard_rows(tm, img))
    # replicate needs radius rows, reflect-101 one more
    erode4 = tpar.stencil_sharded(functools.partial(
        morph_ypadded, radius=4, mode=0), 4, REPLICATE, tm)
    erode4(_t(rng.integers(0, 256, (16, 8), dtype=np.uint8)))
    with pytest.raises(ValueError, match="halo exchange"):
        tpar.stencil_sharded(functools.partial(
            gaussian_ypadded, radius=4, sigma=2.0), 4, REFLECT101, tm)(img)
    with pytest.raises(ParamError, match="border"):
        tpar.stencil_sharded(lambda p: p, 1, "wrap", tm)(img)


def test_sharded_ops_validate_inputs(rng, meshes):
    _, tm = meshes
    f32 = _t(rng.random((16, 64), dtype=np.float32))
    with pytest.raises(DTypeError):
        tpar.integral_sharded(tm)(f32)
    with pytest.raises(DTypeError):
        tpar.hist_equalize_sharded(tm)(f32)
    with pytest.raises(ValueError):
        tpar.hist_equalize_sharded(tm)(
            _t(rng.integers(0, 256, (2, 3, 16, 64), dtype=np.uint8)))
    with pytest.raises(ParamError):
        tpar.clahe_sharded(tm, 2.0, 8, 64)(
            _t(rng.integers(0, 256, (16, 64), dtype=np.uint8)))
    with pytest.raises(ParamError):
        tpar.guided_filter_sharded(tm, 4, 0.0)
    with pytest.raises(TypeError):
        tpar.guided_filter_sharded(tm, 4, 1e-3)(f32)
    with pytest.raises(ValueError, match="distinct"):
        tpar.guided_filter_sharded(tm, 4, 1e-3, self_guided=True)(
            f32, f32.clone())
    with pytest.raises(ParamError):
        tpar.guided_filter_sharded(tm, 0, 1e-3)
    with pytest.raises(ValueError):
        tpar.shard_rows(tm, _t(rng.integers(0, 256, (3, 16, 64),
                                            dtype=np.uint8)))


def test_uneven_shapes_raise_where_tpuimg_does_not_pad(rng, meshes):
    _, tm = meshes
    with pytest.raises(ValueError, match="sp axis"):
        tpar.shard_rows(tm, torch.zeros(18, 8))
    with pytest.raises(ValueError, match="data axis"):
        tpar.shard_batch(tm, torch.zeros(3, 16, 8))
    with pytest.raises(ValueError, match="sp axis"):
        tpar.integral_sharded(tm)(torch.zeros(18, 8, dtype=torch.uint8))
    with pytest.raises(ValueError, match="need 9 devices"):
        tpar.make_mesh(3, 3, devices=CPU8)
    with pytest.raises(ParamError):
        tpar.make_mesh(0, 4, devices=CPU8)


def test_enhance_sharded_validates_inputs(rng, meshes):
    _, tm = meshes
    with pytest.raises(ParamError):
        tpar.enhance_sharded(tm, gf_eps=0.0)
    with pytest.raises(ParamError):
        tpar.enhance_sharded(tm, radius=0)
    op = tpar.enhance_sharded(tm, tiles=2, gf_radius=2)
    with pytest.raises(DTypeError):
        op(_t(rng.random((64, 96), dtype=np.float32)))
    with pytest.raises(ValueError, match="one .H, W. frame"):
        op(_t(rng.integers(0, 256, (2, 64, 96), dtype=np.uint8)))
    # H = 5 over 4 shards: 7 pad rows (a shard multiple >= 2*2 + 2 deep)
    # would need more than h - 1 rows of reflect-101 extension
    with pytest.raises(ValueError, match="pad rows"):
        op(_t(rng.integers(0, 256, (5, 96), dtype=np.uint8)))
    # H = 9: 4 rows a shard, thinner than the tail's reach of 6
    with pytest.raises(ValueError, match="halo exchange"):
        op(_t(rng.integers(0, 256, (9, 96), dtype=np.uint8)))


def test_sharded_gather_and_shape(rng, meshes):
    _, tm = meshes
    img = _t(rng.integers(0, 256, (64, 72), dtype=np.uint8))
    s = tpar.shard_rows(tm, img)
    assert s.shape == (64, 72) and s.ndim == 2 and s.dtype == torch.uint8
    assert [b.shape[0] for b in s.blocks[0]] == [16] * 4
    assert torch.equal(s.gather(), img)
    b = tpar.shard_batch(tm, img.reshape(4, 16, 72))
    assert b.shape == (4, 16, 72)
    assert [[blk.shape for blk in row] for row in b.blocks] == [
        [(2, 4, 72)] * 4] * 2
    assert torch.equal(b.gather(), img.reshape(4, 16, 72))


# --- entry points and the device of a NumPy input --------------------------

ENTRY_POINTS = {
    "gaussian": lambda a: tpuimg_torch.gaussian(a, 1, 1.0),
    "box_filter": lambda a: tpuimg_torch.box_filter(a, 1),
    "guided_filter": lambda a: tpuimg_torch.guided_filter(a, a, 1, 1e-3),
    "integral": tpuimg_torch.integral,
    "hist_equalize": tpuimg_torch.hist_equalize,
    "clahe": tpuimg_torch.clahe,
    "erode": lambda a: tpuimg_torch.erode(a, 1),
    "morph_open": lambda a: tpuimg_torch.morph_open(a, 1),
    "enhance": tpuimg_torch.enhance,
    "gaussian_ypadded": lambda a: gaussian_ypadded(a, 1, 1.0),
    "morph_ypadded": lambda a: morph_ypadded(a, 1, 0),
    "shard_rows": lambda a: tpar.shard_rows(
        tpar.make_mesh(1, 1, devices=["cpu"]), a),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_numpy_input_is_refused_without_a_card(name):
    """A NumPy frame goes to the card; with none, every entry point raises
    DeviceError and never runs the CPU path silently."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_cuda.py covers it")
    a = np.random.default_rng(0).integers(0, 256, (32, 48), dtype=np.uint8)
    if name in ("gaussian", "box_filter", "guided_filter",
                "gaussian_ypadded"):
        a = a.astype(np.float32)
    with pytest.raises(DeviceError, match="torch.from_numpy"):
        ENTRY_POINTS[name](a)
    # the same frame as a CPU tensor is the CPU path
    ENTRY_POINTS[name](torch.from_numpy(a))


def test_carry_enhance_state_defaults_to_the_card():
    """tpuimg's CLAHE state carried across goes to the card unless the
    caller names the CPU."""
    from tpuimg_torch.core.params import carry_enhance_state

    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_cuda.py covers it")
    img = np.random.default_rng(1).integers(0, 256, (90, 110), np.uint8)
    tables, th, tw, pt, pl = _clahe_front(_t(img), 2.0, 8, 8)
    with pytest.raises(DeviceError, match="torch.from_numpy"):
        carry_enhance_state(tables.numpy(), th, tw, pt, pl, h=90, w=110)
    st = carry_enhance_state(tables.numpy(), th, tw, pt, pl, h=90, w=110,
                             device="cpu")
    assert st.tables.device.type == "cpu"
    assert torch.equal(st.tables, tables)
