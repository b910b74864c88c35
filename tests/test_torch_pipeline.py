"""tpuimg_torch's enhance pipeline against tpuimg's, on the CPU: end to end,
through carried-across CLAHE state, the typed errors, the dispatch rules and
the import boundary."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuimg
import tpuimg_torch
from tpuimg.core.kernelgen import gaussian_kernel_1d as jax_taps
from tpuimg.kernels.boxsum import (
    enhance_tail_clahe_pallas, enhance_tail_pallas)
from tpuimg.kernels.lut import clahe_map_full
from tpuimg.oracle import clahe_ref, gaussian_ref, guided_filter_ref
from tpuimg.ops.histogram import _clahe_front, _map_bank, _tile_coord_runs
from tpuimg.pipeline import enhance as jax_enhance
from tpuimg_torch.core import validate as tv
from tpuimg_torch.core.kernelgen import gaussian_kernel_1d
from tpuimg_torch.core.params import carry_enhance_state
from tpuimg_torch import kernels
from tpuimg_torch.kernels import MAX_TAPS, TAIL_MAX_RADIUS
from tpuimg_torch.kernels.boxsum import (
    INV_255, _tail_taps, enhance_tail, enhance_tail_clahe,
    enhance_tail_clahe_plain)
from tpuimg_torch.kernels.lut import clahe_map
from tpuimg_torch.ops.histogram import _clahe_front as torch_clahe_front
from tpuimg_torch.pipeline import _to_u8 as torch_to_u8
from tpuimg_torch.pipeline import enhance

SHAPE = (72, 96)
# every value of tiles {4, 8}, radius {1, 2} and gf_radius {2, 4, 8}; the
# last case is enhance's defaults. (72, 96) with gf_radius 8 takes the tail
# kernel's path (72 > 2*(2*8 + 2)); gf_radius 2 and 4 as well.
PARAMS = [(4, 1, 2), (8, 1, 4), (4, 2, 8), (8, 2, 8)]


def _to_u8(q):
    return np.clip(np.rint(q * 255.0), 0, 255).astype(np.uint8)


def _composed_oracle(img, tiles, radius, gf_radius):
    """cli.py's enhance-autotest reference: the NumPy oracles composed."""
    eq = clahe_ref(img, 2.0, tiles, tiles)
    f = eq.astype(np.float32) / np.float32(255.0)
    sm = gaussian_ref(f, radius, 1.5)
    return _to_u8(guided_filter_ref(f, sm, gf_radius, 1e-3,
                                    border="reflect101"))


@pytest.mark.parametrize("impl", ["fused", "staged"])
@pytest.mark.parametrize("tiles,radius,gf_radius", PARAMS)
def test_enhance_matches_tpuimg_and_oracle(rng, impl, tiles, radius,
                                           gf_radius):
    img = rng.integers(0, 256, SHAPE, dtype=np.uint8)
    args = (2.0, tiles, radius, 1.5, gf_radius, 1e-3)
    got = enhance(torch.from_numpy(img), *args, impl=impl).numpy()
    assert got.dtype == np.uint8 and got.shape == SHAPE
    ref = np.asarray(jax_enhance(img, *args, impl=impl))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    oracle = _composed_oracle(img, tiles, radius, gf_radius)
    assert np.abs(got.astype(int) - oracle.astype(int)).max() <= 2


@pytest.mark.parametrize("tiles,radius,gf_radius", PARAMS)
def test_enhance_fused1_matches_tpuimg_and_fused(rng, tiles, radius,
                                                 gf_radius):
    """impl="fused1" within 1 step of tpuimg's (which composes the fused
    chain on the CPU), and equal to the port's impl="fused"."""
    img = rng.integers(0, 256, SHAPE, dtype=np.uint8)
    args = (2.0, tiles, radius, 1.5, gf_radius, 1e-3)
    got = enhance(torch.from_numpy(img), *args, impl="fused1")
    assert got.dtype == torch.uint8 and got.shape == SHAPE
    ref = np.asarray(jax_enhance(img, *args, impl="fused1"))
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
    assert torch.equal(got, enhance(torch.from_numpy(img), *args))


@pytest.mark.parametrize("shape,tiles", [((150, 200), 4), ((220, 260), 8)])
def test_enhance_tail_clahe_matches_pallas(rng, shape, tiles):
    """The fused1 tail's plain version against tpuimg's Pallas kernel
    (interpret mode), fed the same CLAHE state: within tpuimg's own 5e-6
    (tests/test_pallas_kernels.py), u8 within 1 step."""
    h, w = shape
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    tables, th, tw, pad_top, pad_left = _clahe_front(
        jnp.asarray(img), 2.0, tiles, tiles)
    xinfo = tuple((x0, x1, tx1) for x0, x1, tx1, _tx2, _ in
                  _tile_coord_runs(w, tiles, tw, pad_left, use_recip=True))
    jq = np.asarray(enhance_tail_clahe_pallas(
        img, _map_bank(tables, tiles, tiles), 2, 1.5, 8, 1e-3,
        pad_top=float(pad_top), th=th, tw=tw, ytiles=tiles, xtiles=tiles,
        pad_left=float(pad_left),
        inv_tw=float(np.float32(1.0) / np.float32(tw)), xinfo=xinfo))
    q = enhance_tail_clahe(torch.from_numpy(img),
                           torch.from_numpy(np.array(tables)), tiles, tiles,
                           th, tw, pad_top, pad_left, 2, 1.5, 8,
                           1e-3).numpy()
    assert q.dtype == np.float32 and q.shape == shape
    assert np.abs(q - jq).max() < 5e-6
    assert np.abs(_to_u8(q).astype(int) - _to_u8(jq).astype(int)).max() <= 1


@pytest.mark.parametrize("radius,radius_g", [(20, 4), (3, 16)])
def test_enhance_tail_wide_radii_match_pallas(rng, radius, radius_g):
    """The tail's plain version against tpuimg's Pallas kernel (interpret
    mode) at radii the card's tail kernel now takes: a gf radius past 16
    and the largest gaussian radius, on frames just above the gate."""
    n = 2 * (2 * radius + radius_g) + 1
    f = rng.random((n, n + 9), dtype=np.float32)
    q = enhance_tail(torch.from_numpy(f), radius_g, 3.0, radius, 1e-3).numpy()
    jq = np.asarray(enhance_tail_pallas(jnp.asarray(f), radius_g, 3.0, radius,
                                        1e-3))
    assert q.shape == f.shape and np.abs(q - jq).max() < 1e-5


@pytest.mark.parametrize("radius,radius_g,shape,error", [
    (TAIL_MAX_RADIUS + 1, 2, (400, 400), tv.ParamError),
    (0, 2, (400, 400), tv.ParamError),
    (8, MAX_TAPS // 2 + 1, (400, 400), tv.ParamError),
    (8, 2, (18, 400), ValueError), (TAIL_MAX_RADIUS, MAX_TAPS // 2,
                                    (145, 400), None)])
def test_tail_limits_checked_before_any_launch(radius, radius_g, shape,
                                               error):
    """The tails' limits, checked on the host before a launch: gf radius
    1 .. TAIL_MAX_RADIUS, gaussian radius <= MAX_TAPS // 2, min(H, W) >
    2r + rg; within them, the taps."""
    h, w = shape
    if error is None:
        tp = _tail_taps(h, w, radius_g, 5.0, radius)
        assert list(tp.w) == pytest.approx(
            [float(v) for v in gaussian_kernel_1d(2 * radius_g + 1, 5.0)])
        return
    with pytest.raises(error):
        _tail_taps(h, w, radius_g, 5.0, radius)


def test_enhance_small_frame_composes_gaussian_and_guided(rng):
    """Below the tail kernel's gate (min(H, W) <= 2*(2*gf_radius + radius))
    the fused path composes gaussian and guided_filter, as tpuimg does."""
    img = rng.integers(0, 256, (30, 44), dtype=np.uint8)
    got = enhance(torch.from_numpy(img), tiles=4).numpy()
    ref = np.asarray(jax_enhance(img, tiles=4))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("shape,tiles", [((150, 200), 4), ((220, 260), 8)])
def test_carried_state_drives_both_packages(rng, shape, tiles):
    """tpuimg's _clahe_front state, carried across, goes through both
    packages' mapping and tail stages: blends within 1e-3, tails within
    1e-5 of each other, u8 frames within 1 step."""
    h, w = shape
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    tables, th, tw, pad_top, pad_left = _clahe_front(
        jnp.asarray(img), 2.0, tiles, tiles)
    st = carry_enhance_state(np.asarray(tables), th, tw, pad_top, pad_left,
                             h=h, w=w, tiles=tiles, device="cpu")
    geo = (st.th, st.tw, st.pad_top, st.pad_left)
    blend = clahe_map(torch.from_numpy(img), st.tables, tiles, tiles, *geo,
                      out_f32=True)
    xinfo = [(x0, x1, tx1) for x0, x1, tx1, _tx2, _ in
             _tile_coord_runs(w, tiles, tw, pad_left, use_recip=True)]
    jblend = clahe_map_full(
        jnp.asarray(img), _map_bank(tables, tiles, tiles), xinfo,
        pad_top=float(pad_top), th=float(th), ytiles=tiles,
        pad_left=float(pad_left),
        inv_tw=float(np.float32(1.0) / np.float32(tw)), out_f32=True)
    assert np.abs(blend.numpy() - np.asarray(jblend)).max() <= 1e-3
    g, gf = st.gaussian, st.guided
    q = enhance_tail(blend * (1.0 / 255.0), g.radius, g.sigma, gf.radius,
                     gf.eps).numpy()
    jq = np.asarray(enhance_tail_pallas(
        jblend * jnp.float32(1.0 / 255.0), g.radius, g.sigma, gf.radius,
        gf.eps))
    assert np.abs(q - jq).max() < 1e-5
    assert np.abs(_to_u8(q).astype(int) - _to_u8(jq).astype(int)).max() <= 1


def test_carry_round_trips_clahe_front_state(rng):
    img = rng.integers(0, 256, (90, 110), dtype=np.uint8)
    tables, th, tw, pad_top, pad_left = _clahe_front(
        jnp.asarray(img), 2.0, 8, 8)
    st = carry_enhance_state(np.asarray(tables), th, tw, pad_top, pad_left,
                             h=90, w=110, device="cpu")
    np.testing.assert_array_equal(st.tables.numpy(), np.asarray(tables))
    assert st.tables.dtype == torch.float32
    # the port's own front end computes the same state, bit for bit
    own = torch_clahe_front(torch.from_numpy(img), 2.0, 8, 8)
    np.testing.assert_array_equal(own[0].numpy(), np.asarray(tables))
    assert own[1:] == (st.th, st.tw, st.pad_top, st.pad_left)
    assert (st.clahe.clip_limit, st.clahe.xtiles, st.gaussian.radius,
            st.guided.radius, st.guided.eps) == (2.0, 8, 2, 8, 1e-3)
    with pytest.raises(tv.ParamError, match="geometry"):
        carry_enhance_state(np.asarray(tables), th, tw, pad_top, pad_left,
                            h=96, w=110, device="cpu")
    with pytest.raises(tv.ShapeError, match="tables"):
        carry_enhance_state(np.asarray(tables)[:10], th, tw, pad_top,
                            pad_left, h=90, w=110, device="cpu")


@pytest.mark.parametrize("ksize,sigma", [(3, 0.8), (5, 1.5), (17, 3.0),
                                         (5, 0.0), (9, -1.0), (33, 6.0)])
def test_gaussian_taps_bit_identical(ksize, sigma):
    ours = gaussian_kernel_1d(ksize, sigma)
    theirs = jax_taps(ksize, sigma)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.tobytes() == theirs.tobytes()


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", [
    "float_frame", "tiles_0", "clip_0", "clip_nan", "eps_0", "radius_0",
    "impl_typo"])
def test_same_typed_errors_as_tpuimg(case):
    u8 = np.zeros((64, 64), np.uint8)
    args, kwargs = {
        "float_frame": ((u8.astype(np.float32),), {}),
        "tiles_0": ((u8,), {"tiles": 0}),
        "clip_0": ((u8,), {"clip_limit": 0.0}),
        "clip_nan": ((u8,), {"clip_limit": float("nan")}),
        "eps_0": ((u8,), {"gf_eps": 0}),
        "radius_0": ((u8,), {"radius": 0}),
        "impl_typo": ((u8,), {"impl": "fussed"}),
    }[case]
    theirs = _raised(lambda: jax_enhance(*args, **kwargs))
    ours = _raised(lambda: enhance(torch.from_numpy(args[0]), **kwargs))
    assert ours == theirs


def test_3d_frame_is_a_shape_error():
    """tpuimg.clahe refuses a batch with ShapeError (its message points at
    jax.vmap); the port's clahe and enhance do the same."""
    batch = np.zeros((2, 64, 64), np.uint8)
    assert _raised(lambda: tpuimg.clahe(batch, 2.0, 4, 4))[0] == "ShapeError"
    for fn in (lambda: tpuimg_torch.clahe(torch.from_numpy(batch), 2.0, 4, 4),
               lambda: enhance(torch.from_numpy(batch))):
        name, msg = _raised(fn)
        assert name == "ShapeError" and "single (H, W) image" in msg


def test_same_typed_errors_from_the_ops(rng):
    f = rng.random((32, 32), dtype=np.float32)
    ours = _raised(lambda: tpuimg_torch.guided_filter(
        torch.from_numpy(f), torch.from_numpy(f), 4, 0.0,
        border="reflect101"))
    assert ours == _raised(lambda: tpuimg.guided_filter(
        f, f, 4, 0.0, border="reflect101"))
    ours = _raised(lambda: tpuimg_torch.gaussian(torch.from_numpy(f), 0, 1.0))
    assert ours == _raised(lambda: tpuimg.gaussian(f, 0, 1.0))
    u8 = np.zeros((4, 4), np.uint8)
    ours = _raised(lambda: tpuimg_torch.clahe(torch.from_numpy(u8), 2.0, 40,
                                              40))
    assert ours == _raised(lambda: tpuimg.clahe(u8, 2.0, 40, 40))
    i64 = np.zeros((4, 4), np.int64)
    ours = _raised(lambda: tv.check_image(torch.from_numpy(i64),
                                          dtypes=[torch.uint8]))
    from tpuimg.core.validate import check_image

    assert ours == _raised(lambda: check_image(i64, dtypes=[np.uint8]))


def test_box_and_guided_match_tpuimg(rng):
    I = rng.random((56, 72), dtype=np.float32)
    p = np.clip(I + 0.1 * rng.standard_normal((56, 72)), 0, 1).astype(
        np.float32)
    for r in (1, 4, 8):
        got = tpuimg_torch.box_filter(torch.from_numpy(I), r,
                                      border="reflect101").numpy()
        ref = np.asarray(tpuimg.box_filter(I, r, border="reflect101"))
        assert np.abs(got - ref).max() < 1e-5
        got = tpuimg_torch.guided_filter(
            torch.from_numpy(I), torch.from_numpy(p), r, 1e-3,
            border="reflect101").numpy()
        ref = np.asarray(tpuimg.guided_filter(I, p, r, 1e-3,
                                              border="reflect101"))
        assert np.abs(got - ref).max() < 1e-4
    It = torch.from_numpy(I)
    self_guided = tpuimg_torch.guided_filter(It, It, 4, 1e-2,
                                             border="reflect101")
    general = tpuimg_torch.guided_filter(It, It.clone(), 4, 1e-2,
                                         border="reflect101")
    assert torch.equal(self_guided, general)
    sm = tpuimg_torch.gaussian(It, 2, 1.5).numpy()
    assert np.abs(sm - np.asarray(tpuimg.gaussian(I, 2, 1.5))).max() < 1e-6


def test_cpu_dispatch_launches_no_kernel(rng):
    img = torch.from_numpy(rng.integers(0, 256, (80, 100), dtype=np.uint8))

    entries = ("tpuimg_tile_hist", "tpuimg_tile_tables", "tpuimg_clahe_map",
               "tpuimg_enhance_tail", "tpuimg_enhance_tail_clahe")

    def launches():
        return [kernels.launches[e] for e in entries]

    before = launches()
    enhance(img)
    enhance(img, impl="fused1")
    tpuimg_torch.clahe(img, 2.0, 4, 4)
    assert launches() == before == [0] * 5
    # the plain version is the blend times 1/255 through the plain tail
    front = torch_clahe_front(img, 2.0, 8, 8)
    q = enhance_tail_clahe_plain(img, front[0], 8, 8, *front[1:], 2, 1.5, 8,
                                 1e-3)
    blend = clahe_map(img, front[0], 8, 8, *front[1:], out_f32=True)
    assert torch.equal(q, enhance_tail(blend * (1.0 / 255.0), 2, 1.5, 8,
                                       1e-3))


def _store_model(q):
    """The kernels' u8 store (csrc/walker.cuh store_q) in NumPy: the f32
    product q * 255 rounded half to even, clamped to [0, 255]."""
    with np.errstate(over="ignore"):  # +-3.4e38 * 255 is +-inf, clamped
        p = q.astype(np.float32) * np.float32(255.0)
    return np.clip(np.rint(p), 0, 255).astype(np.uint8)


def _ties():
    """f32 q within 3 ulps of (k + 0.5) / 255 whose f32 product with 255 is
    exactly k + 0.5, for every k that has one."""
    out = []
    for k in range(255):
        q = np.float32((k + 0.5) / 255)
        for _ in range(3):
            q = np.nextafter(q, np.float32(0))
        for _ in range(7):
            if q * np.float32(255.0) == np.float32(k + 0.5):
                out.append(q)
            q = np.nextafter(q, np.float32(1))
    return np.array(out, np.float32)


def _beside(q):
    """Each q's f32 neighbours on both sides."""
    return np.concatenate([np.nextafter(q, np.float32(-1)),
                           np.nextafter(q, np.float32(2))])


STORE_CASES = {
    "half-way": _ties(),
    "beside half-way": _beside(_ties()),
    "negatives": np.float32([-0.0, -1e-30, -0.4 / 255, -0.5 / 255,
                             -0.6 / 255, -1.0, -3.4e38]),
    "above one": np.float32([254.5 / 255, 255.4 / 255, 255.5 / 255,
                             256 / 255, 1.5, 3.4e38]),
    "ends": np.float32([0.0, 1.0]),
}


@pytest.mark.parametrize("case", list(STORE_CASES))
def test_u8_store_model_matches_to_u8(case):
    """The tails' u8 store is pipeline._to_u8 of the f32 q: half-way
    products round to even, values outside [0, 1] clamp."""
    q = STORE_CASES[case]
    got = torch_to_u8(torch.from_numpy(q)).numpy()
    assert np.array_equal(got, _store_model(q))
    if case == "half-way":
        # both ways of a tie: k even keeps k, k odd goes up to k + 1
        ks = np.floor(q * np.float32(255.0)).astype(int)
        assert {0, 1} <= set(ks % 2)
        assert not (got % 2).any()


def test_cpu_u8_and_scaled_outputs_are_the_glue_they_replace(rng):
    """On the CPU the tails' u8 output is _to_u8 of their f32 q, and
    clahe_map's scaled blend the raw blend times the scale, bit for bit;
    a u8 map takes no scale."""
    img = torch.from_numpy(rng.integers(0, 256, (80, 100), dtype=np.uint8))
    tables, *geo = torch_clahe_front(img, 2.0, 8, 8)
    raw = clahe_map(img, tables, 8, 8, *geo, out_f32=True)
    f = clahe_map(img, tables, 8, 8, *geo, out_f32=True, scale=INV_255)
    assert torch.equal(f, raw * INV_255)
    assert torch.equal(clahe_map(img, tables, 8, 8, *geo, out_f32=True,
                                 scale=1.0), raw)
    with pytest.raises(ValueError, match="scale"):
        clahe_map(img, tables, 8, 8, *geo, scale=INV_255)
    q = enhance_tail(f, 2, 1.5, 8, 1e-3, out_u8=True)
    assert q.dtype == torch.uint8
    assert torch.equal(q, torch_to_u8(enhance_tail(f, 2, 1.5, 8, 1e-3)))
    args = (img, tables, 8, 8, *geo, 2, 1.5, 8, 1e-3)
    assert torch.equal(enhance_tail_clahe(*args, out_u8=True),
                       torch_to_u8(enhance_tail_clahe(*args)))


def test_fused_paths_store_in_the_kernels_and_others_round_in_glue(
        rng, monkeypatch):
    """Above the tail's gate the fused paths launch clahe_map with the
    scale INV_255 and the tail with its u8 store, and record no
    enhance.scale or enhance.to_u8 span; staged and frames under the gate
    still round q in _to_u8. (Meta tensors stand in for CUDA ones, with
    the launches recorded; the CPU runs the same dispatch with the plain
    versions.)"""
    from tpuimg_torch import pipeline, profiling
    from tpuimg_torch.kernels import boxsum, lut
    from tpuimg_torch.ops.histogram import _clahe_geometry

    launched = []
    rounded = []

    def record(name, device, *args):
        launched.append((name, args))

    def to_u8(q):
        rounded.append(q.shape)
        return torch_to_u8(q)

    def front(img, clip, xt, yt):
        geo = _clahe_geometry(*img.shape, xt, yt)
        return (torch.empty((yt * xt, 256), device="meta"), *geo)

    for mod in (lut, boxsum):
        monkeypatch.setattr(mod, "launch", record)
        monkeypatch.setattr(mod, "check_clahe_args", lambda *a: None)
    monkeypatch.setattr(boxsum, "require_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(boxsum, "_tail_scratch",
                        lambda *a: torch.empty(0, device="meta"))
    monkeypatch.setattr(pipeline, "_clahe_front", front)
    monkeypatch.setattr(pipeline, "_to_u8", to_u8)
    meta = torch.empty((2160, 3840), dtype=torch.uint8, device="meta")
    for impl, entries in (("fused", ["tpuimg_clahe_map",
                                     "tpuimg_enhance_tail"]),
                          ("fused1", ["tpuimg_enhance_tail_clahe"])):
        launched.clear()
        with profiling.recording() as rec:
            out = enhance(meta, impl=impl)
        assert out.dtype == torch.uint8 and out.shape == meta.shape
        assert [name for name, _ in launched] == entries
        for name, args in launched:
            if name == "tpuimg_clahe_map":  # ..., out_f32, scale, out
                assert args[-3:-1] == (1, INV_255)
            else:  # ..., scratch, out_u8, out
                assert args[-2] == 1
        names = {s.name for s in rec.spans}
        assert not names & {"enhance.scale", "enhance.to_u8"}, names
    assert rounded == []
    # on the CPU: the fused paths above the gate round nothing in glue,
    # staged and a frame under the gate do
    img = torch.from_numpy(rng.integers(0, 256, (72, 96), dtype=np.uint8))
    small = torch.from_numpy(rng.integers(0, 256, (30, 40), dtype=np.uint8))
    monkeypatch.undo()
    monkeypatch.setattr(pipeline, "_to_u8", to_u8)
    for frame, impl, rounds in ((img, "fused", 0), (img, "fused1", 0),
                                (img, "staged", 1), (small, "fused", 1),
                                (small, "fused1", 1)):
        rounded.clear()
        enhance(frame, impl=impl)
        assert len(rounded) == rounds, (frame.shape, impl)


def test_unported_paths_raise_off_the_cpu(monkeypatch):
    """A tensor off the CPU never runs a kernel's plain version: the paths
    that need a kernel reach its wrapper, which refuses any tensor but a
    CUDA one. (A meta tensor stands in for a CUDA one; the checks look at
    the device type.) The shrink border, XLA in tpuimg, takes the twopass
    kernel's shrink instance too at radius <= 16; above it stays plain
    PyTorch on the tensor's device."""
    from tpuimg_torch.kernels import boxsum, hist, lut, sep_stencil

    def must_not_run(*args, **kwargs):
        raise AssertionError("a plain version ran off the CPU")

    for mod, name in ((hist, "tile_hist_plain"), (lut, "clahe_map_plain"),
                      (boxsum, "enhance_tail_plain"),
                      (boxsum, "enhance_tail_clahe_plain"),
                      (boxsum, "guided_filter_plain"),
                      (sep_stencil, "gaussian_plain")):
        monkeypatch.setattr(mod, name, must_not_run)
    meta_u8 = torch.empty((2160, 3840), dtype=torch.uint8, device="meta")
    meta_f = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        enhance(meta_u8, impl="staged")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        enhance(meta_u8, impl="fused1")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        enhance(torch.empty((30, 40), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tpuimg_torch.gaussian(meta_f, 2, 1.5)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tpuimg_torch.guided_filter(meta_f, meta_f, 4, 1e-3,
                                   border="reflect101")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tpuimg_torch.guided_filter(meta_f, meta_f[None].expand(3, 64, 64), 4,
                                   1e-3, border="reflect101")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tpuimg_torch.guided_filter(meta_f, meta_f, 4, 1e-3)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tpuimg_torch.guided_filter(meta_f, meta_f[None].expand(3, 64, 64), 16,
                                   1e-3)
    shrink = tpuimg_torch.guided_filter(meta_f, meta_f, 17, 1e-3)
    assert shrink.device.type == "meta" and shrink.shape == (64, 64)


def test_guided_filter_first_call_imports_no_sympy():
    """The kernel route's CN1 branch broadcasts I over p's channels on
    tuples: torch.broadcast_shapes's first call imports sympy, seconds of
    every process's set-up."""
    code = ("import sys, torch, tpuimg_torch; "
            "q = tpuimg_torch.guided_filter(torch.rand(1, 20, 30), "
            "torch.rand(3, 2, 20, 30), 3, 1e-3); "
            "assert q.shape == (3, 2, 20, 30); "
            "print('sympy' in sys.modules); "
            "sys.exit(1 if 'sympy' in sys.modules else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_guided_sources_that_do_not_broadcast_are_a_shape_error():
    I = torch.rand(2, 20, 30)
    with pytest.raises(tv.ShapeError, match="broadcast"):
        tpuimg_torch.guided_filter(I, torch.rand(3, 20, 30), 3, 1e-3)


def test_import_pulls_in_no_jax_tpuimg_cv2_or_triton():
    code = ("import sys, tpuimg_torch, tpuimg_torch.pipeline; "
            "bad = [m for m in ('jax', 'tpuimg', 'cv2', 'triton') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
