"""tpuimg_torch's gaussian and guided filter against tpuimg's, on the CPU.

On a CPU tensor the kernel wrappers run their plain versions; these tests
hold them to the JAX package's Pallas kernels (interpret mode on the CPU
backend, called directly as tests/test_pallas_kernels.py calls them) and the
public ops to tpuimg's XLA paths: the shrink border, the C-channel (CN1)
form, radius > 16, and frames smaller than the reflect-101 halo. Tolerances
are tpuimg's contracts: gaussian 1e-5, the fused guided filter 1e-4, the
shrink and CN1 forms 1e-3, enhance 1 step.
"""

import numpy as np
import pytest
import torch

import tpuimg
import tpuimg_torch
from tpuimg_torch import kernels
from tpuimg.kernels.boxsum import enhance_tail_pallas, guided_filter_pallas
from tpuimg.kernels.sep_stencil import gaussian_pallas
from tpuimg.ops.gaussian import gaussian_ypadded as jax_gaussian_ypadded
from tpuimg.pipeline import enhance as jax_enhance
from tpuimg_torch.core.borders import pad_reflect101, reflect101_index
from tpuimg_torch.kernels.boxsum import (
    enhance_tail_plain, guided_filter_kernel)
from tpuimg_torch.kernels.sep_stencil import (
    _sep_pass, gaussian_kernel, gaussian_plain, gaussian_ypadded_plain, taps)

SHAPE = (70, 150)  # unaligned to every tile and lane width


def _pair(rng, shape):
    I = rng.random(shape, dtype=np.float32)
    p = np.clip(I + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return I, p


def _maxdiff(got, ref):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(ref, np.float64)).max())


@pytest.mark.parametrize("radius,sigma", [(1, 0.8), (2, 1.5), (7, 3.0)])
def test_gaussian_matches_pallas(rng, radius, sigma):
    img = rng.random(SHAPE, dtype=np.float32)
    ref = np.asarray(gaussian_pallas(img, radius, sigma))
    got = gaussian_kernel(torch.from_numpy(img), radius, sigma).numpy()
    assert got.dtype == np.float32 and got.shape == SHAPE
    assert _maxdiff(got, ref) <= 1e-5
    public = tpuimg_torch.gaussian(torch.from_numpy(img), radius, sigma)
    assert torch.equal(public, torch.from_numpy(got))


def test_gaussian_batch_matches_pallas(rng):
    img = rng.random((3, 45, 70), dtype=np.float32)
    ref = np.asarray(gaussian_pallas(img, 2, 1.5))
    got = tpuimg_torch.gaussian(torch.from_numpy(img), 2, 1.5).numpy()
    assert got.shape == (3, 45, 70)
    assert _maxdiff(got, ref) <= 1e-5


def test_gaussian_u8_and_f64_promote(rng):
    """u8 blurs the raw 0..255 values, in float32; the contract holds on
    the [0, 1] scale of the same frame."""
    img = rng.integers(0, 256, SHAPE, dtype=np.uint8)
    ref = np.asarray(gaussian_pallas(img, 2, 1.5))
    got = tpuimg_torch.gaussian(torch.from_numpy(img), 2, 1.5)
    assert got.dtype == torch.float32
    assert _maxdiff(got.numpy() / 255.0, ref / 255.0) <= 1e-5
    f64 = torch.from_numpy(img.astype(np.float64) / 255.0)
    got = tpuimg_torch.gaussian(f64, 2, 1.5)
    assert got.dtype == torch.float32
    ref = np.asarray(tpuimg.gaussian(img.astype(np.float64) / 255.0, 2, 1.5))
    assert _maxdiff(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("variant", ["onepass", "twopass"])
@pytest.mark.parametrize("self_guided", [False, True])
@pytest.mark.parametrize("radius", [1, 4, 8, 16])
def test_guided_matches_pallas(rng, variant, self_guided, radius):
    I, p = _pair(rng, SHAPE)
    if self_guided:
        p = I
    ref = np.asarray(guided_filter_pallas(I, p, radius, 1e-3, variant=variant,
                                          self_guided=self_guided))
    It = torch.from_numpy(I)
    got = guided_filter_kernel(It, It if self_guided else torch.from_numpy(p),
                               radius, 1e-3, variant=variant,
                               self_guided=self_guided).numpy()
    assert got.shape == SHAPE and np.isfinite(got).all()
    assert _maxdiff(got, ref) <= 1e-4


def test_guided_batch_matches_pallas(rng):
    I, p = _pair(rng, (2, 40, 90))
    ref = np.asarray(guided_filter_pallas(I, p, 4, 1e-3))
    got = tpuimg_torch.guided_filter(torch.from_numpy(I), torch.from_numpy(p),
                                     4, 1e-3, border="reflect101").numpy()
    assert got.shape == (2, 40, 90)
    assert _maxdiff(got, ref) <= 1e-4


@pytest.mark.parametrize("radius", [1, 4, 12])
def test_box_filter_shrink_matches_tpuimg(rng, radius):
    x = rng.random((2, 33, 57), dtype=np.float32)
    got = tpuimg_torch.box_filter(torch.from_numpy(x), radius).numpy()
    ref = np.asarray(tpuimg.box_filter(x, radius))
    assert _maxdiff(got, ref) <= 1e-3
    got = tpuimg_torch.box_filter(torch.from_numpy(x), radius,
                                  border="reflect101").numpy()
    ref = np.asarray(tpuimg.box_filter(x, radius, border="reflect101"))
    assert _maxdiff(got, ref) <= 1e-5


@pytest.mark.parametrize("radius", [2, 8, 20])
def test_guided_shrink_matches_tpuimg(rng, radius):
    """The default border, the reference class path, general and
    self-guided."""
    I, p = _pair(rng, (48, 64))
    It = torch.from_numpy(I)
    got = tpuimg_torch.guided_filter(It, torch.from_numpy(p), radius,
                                     1e-3).numpy()
    assert _maxdiff(got, tpuimg.guided_filter(I, p, radius, 1e-3)) <= 1e-3
    got = tpuimg_torch.guided_filter(It, It, radius, 1e-2).numpy()
    assert _maxdiff(got, tpuimg.guided_filter(I, I, radius, 1e-2)) <= 1e-3


@pytest.mark.parametrize("border", ["reflect101", "shrink"])
def test_guided_cn1_matches_tpuimg(rng, border):
    """A three-channel source with one shared guide."""
    I = rng.random((40, 56), dtype=np.float32)
    p = rng.random((3, 40, 56), dtype=np.float32)
    got = tpuimg_torch.guided_filter(torch.from_numpy(I), torch.from_numpy(p),
                                     4, 1e-3, border=border).numpy()
    ref = np.asarray(tpuimg.guided_filter(I, p, 4, 1e-3, border=border))
    assert got.shape == (3, 40, 56)
    assert _maxdiff(got, ref) <= 1e-3


def test_guided_radius_above_kernel_matches_tpuimg(rng):
    """radius > 16: tpuimg's XLA chain (cumsum window sums), in both."""
    I, p = _pair(rng, (60, 80))
    for q in (p, I):
        Iq = torch.from_numpy(I)
        got = tpuimg_torch.guided_filter(
            Iq, Iq if q is I else torch.from_numpy(q), 20, 1e-3,
            border="reflect101").numpy()
        ref = np.asarray(tpuimg.guided_filter(I, q, 20, 1e-3,
                                              border="reflect101"))
        assert _maxdiff(got, ref) <= 1e-4


@pytest.mark.parametrize("shape,radius", [((1, 7), 2), ((2, 5), 2),
                                          ((3, 9), 4), ((6, 40), 8)])
def test_tiny_frames_match_tpuimg(rng, shape, radius):
    """Frames smaller than the reflect-101 halo: the mirror repeats past
    each edge, as jnp.pad's does on tpuimg's XLA path."""
    I, p = _pair(rng, shape)
    got = tpuimg_torch.gaussian(torch.from_numpy(I), radius, 1.5).numpy()
    assert _maxdiff(got, tpuimg.gaussian(I, radius, 1.5)) <= 1e-5
    It = torch.from_numpy(I)
    for q, tq in ((p, torch.from_numpy(p)), (I, It)):
        got = tpuimg_torch.guided_filter(It, tq, radius, 1e-3,
                                         border="reflect101").numpy()
        ref = tpuimg.guided_filter(I, q, radius, 1e-3, border="reflect101")
        assert np.isfinite(got).all()
        assert _maxdiff(got, ref) <= 1e-4


@pytest.mark.parametrize("impl", ["fused", "staged"])
@pytest.mark.parametrize("shape", [(8, 8), (6, 40)])
def test_enhance_tiny_frames_match_tpuimg(rng, impl, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = tpuimg_torch.enhance(torch.from_numpy(img), impl=impl).numpy()
    ref = np.asarray(jax_enhance(img, impl=impl))
    assert got.dtype == np.uint8 and got.shape == shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_wrappers_take_plain_version_on_cpu(rng):
    """On a CPU tensor the new wrappers launch nothing."""
    entries = ("tpuimg_gaussian", "tpuimg_guided_onepass",
               "tpuimg_guided_twopass")
    before = [kernels.launches[e] for e in entries]
    f = torch.from_numpy(rng.random((40, 50), dtype=np.float32))
    tpuimg_torch.gaussian(f, 2, 1.5)
    tpuimg_torch.guided_filter(f, f, 4, 1e-3, border="reflect101")
    guided_filter_kernel(f, f.clone(), 4, 1e-3, variant="twopass")
    tpuimg_torch.enhance(torch.from_numpy(
        rng.integers(0, 256, (40, 50), dtype=np.uint8)), impl="staged")
    after = [kernels.launches[e] for e in entries]
    assert after == before == [0, 0, 0]


def test_guided_variant_is_checked(rng):
    f = torch.from_numpy(rng.random((20, 20), dtype=np.float32))
    with pytest.raises(tpuimg_torch.core.validate.ParamError,
                       match="variant"):
        guided_filter_kernel(f, f, 2, 1e-3, variant="threepass")
    # the shrink border has a twopass kernel only
    with pytest.raises(tpuimg_torch.core.validate.ParamError,
                       match="variant at the shrink border"):
        guided_filter_kernel(f, f, 2, 1e-3, variant="onepass",
                             border="shrink")


def _gauss_register_model(src, r, sigma, ypadded, kr, tw, th):
    """csrc/gaussian.cu's register route in NumPy, float32 rounding after
    every multiply and add: tiles of th rows by tw columns; each tile's
    extent, (th + 2r) rows by tw + 2*ra columns (ra = r rounded up to 4),
    through the iterated reflect-101 map (the block's own rows, clamped, for
    a row-padded block); then down each column a window of 2*kr + 1
    row-pass values (kr >= r: the taps past r switched off), from which the
    column pass takes each output."""
    wts = np.float32(taps(r, sigma))
    wk = [wts[r - k] if k <= r else np.float32(0) for k in range(kr + 1)]
    hin, w = src.shape
    h = hin - 2 * r if ypadded else hin
    ra = (r + 3) & ~3
    eh, ew = th + 2 * r, tw + 2 * ra
    out = np.empty((h, w), np.float32)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            ys = np.arange(y0 - r, y0 - r + eh)
            ys = (np.minimum(ys + r, hin - 1) if ypadded
                  else reflect101_index(ys, h))
            xs = reflect101_index(np.arange(x0 - ra, x0 - ra + ew), w)
            ext = src[np.ix_(ys, xs)]
            c = ra + np.arange(tw)  # each thread's column in the extent
            win = [np.zeros(tw, np.float32)] * (2 * kr + 1)
            rows = []
            for step in range(th + 2 * kr):
                q = step - kr + r
                v = np.zeros(tw, np.float32)
                if 0 <= q < eh:
                    v = wk[0] * ext[q, c]
                    for k in range(1, r + 1):
                        v = v + wk[k] * (ext[q, c - k] + ext[q, c + k])
                win = win[1:] + [v]
                if step >= 2 * kr:
                    acc = wk[0] * win[kr]
                    for k in range(1, r + 1):
                        acc = acc + wk[k] * (win[kr - k] + win[kr + k])
                    rows.append(acc)
            tile = np.stack(rows)
            ty, tx = min(th, h - y0), min(tw, w - x0)
            out[y0:y0 + ty, x0:x0 + tx] = tile[:ty, :tx]
    return out


@pytest.mark.parametrize("shape,radius,kr", [
    ((1, 7), 2, 2), ((3, 9), 4, 4), ((33, 1), 3, 3), ((45, 70), 1, 1),
    ((37, 131), 2, 2), ((20, 50), 5, 8), ((29, 61), 11, 16)])
def test_gaussian_kernel_model_matches_plain_and_pallas(rng, shape, radius,
                                                        kr):
    """The redesigned gaussian's register route (tiles cut by the frame's
    edges, reflect-101 extents, a register window down each column, r 5-16
    on the wider windows with taps switched off) equals the plain version
    bit for bit and tpuimg within its 1e-5 contract (its Pallas kernels in
    interpret mode; its XLA path where a frame is smaller than the halo,
    which the Pallas kernels refuse), frame and row-padded entries."""
    impl = "pallas" if min(shape) > radius else "xla"
    img = rng.random(shape, dtype=np.float32)
    got = _gauss_register_model(img, radius, 1.5, False, kr, 16, 8)
    want = gaussian_plain(torch.from_numpy(img), radius, 1.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert _maxdiff(got, tpuimg.gaussian(img, radius, 1.5, impl=impl)) <= 1e-5
    p = rng.random((shape[0] + 2 * radius, shape[1]), dtype=np.float32)
    got = _gauss_register_model(p, radius, 1.5, True, kr, 16, 8)
    want = gaussian_ypadded_plain(torch.from_numpy(p), radius, 1.5).numpy()
    np.testing.assert_array_equal(got, want)
    ref = jax_gaussian_ypadded(p, radius, 1.5, impl=impl)
    assert _maxdiff(got, ref) <= 1e-5


# csrc/walker.cuh's repair of a running sum: kept after its subtract while
# finite and while the term that left is at most kRebuildF32 (f32 sums
# along the rows) or kRebuildF64 (f64 sums down the columns, checked on
# their f32 values) times its magnitude; otherwise rebuilt from its window
REBUILD_F32, REBUILD_F64 = 64.0, 2.0 ** 20
F32_MAX = float(np.finfo(np.float32).max)


def _keeps(leaving, total, most):
    """walker::keeps on float32 tensors."""
    return (leaving.abs() <= most * total.abs()) & (total.abs() <= F32_MAX)


def _row_window_sums(src, r, length, repair=True):
    """walker::row_window_sums on (..., parts, length + 2r) float32 rows:
    2r warm-up adds, then one add and one subtract a column, each sum
    (but the last) kept or rebuilt as the next window's warm-up (the
    careful pass, whose outputs the kernel's fast pass equals wherever it
    keeps them); without ``repair`` (row_window_sums<false>) every sum is
    kept."""
    s = torch.zeros(src.shape[:-1], dtype=torch.float32)
    for t in range(2 * r):
        s = s + src[..., t]
    out = []
    for c in range(length):
        s = s + src[..., c + 2 * r]
        out.append(s)
        leaving = src[..., c]
        s = s - leaving
        bad = ~_keeps(leaving, s, REBUILD_F32)
        if repair and c + 1 < length and bool(bad.any()):
            d = torch.zeros_like(s)
            for t in range(2 * r):
                d = d + src[..., c + 1 + t]
            s = torch.where(bad, d, s)
    return torch.stack(out, -1)


def _twopass_walk_sums(X, Y, r, seg_rows, products, repair=True,
                       shrink=False):
    """The window sums one launch of csrc/guided.cu's twopass walk takes of
    its planes (X, Y, and with ``products`` X*Y and X*X) of an (h, w)
    frame: segments of ``seg_rows`` rows, walked 8 extended rows
    (reflect-101; with ``shrink``, zero outside the frame) a step; down
    each input column an f64 running sum, the
    entering row added and the one 2r + 1 rows up subtracted, rounded to f32
    once a row and checked on the planes of Y and X*X (of X and Y without
    ``products``); a column whose check fails at any row of a step has that
    step's sums taken again directly from their windows. Then along each
    row in f32, in parts of 128-column strips (walker::row_window_sums): 16
    columns a part for four planes, 8 for two (a step's 8 rows by its
    planes by the parts make the block's 256 threads). Without ``repair``
    (the enhance tail's walks, csrc/enhance_tail.cuh) no sum is checked."""
    h, w = X.shape
    k, strip, length, step = 2 * r + 1, 128, 16 if products else 8, 8
    width = -(-w // strip) * strip

    def index(i, n):
        # the source row or column of each extended one; under shrink, one
        # past the frame (a zero row or column appended) outside it
        if shrink:
            return torch.from_numpy(np.where((i >= 0) & (i < n), i, n))
        return torch.from_numpy(reflect101_index(i, n))

    if shrink:
        X = torch.nn.functional.pad(X, (0, 1, 0, 1))
        Y = torch.nn.functional.pad(Y, (0, 1, 0, 1))
    xs = index(np.arange(-r, width + r), w)
    out = []
    for y0 in range(0, h, seg_rows):
        n = min(seg_rows, h - y0) + 2 * r
        n_pad = -(-n // step) * step  # a step's rows past the walk are read
        ys = index(np.arange(y0 - r, y0 - r + n_pad), h)
        xe, ye = X[ys][:, xs], Y[ys][:, xs]

        def terms(u):
            x, y = xe[u].double(), ye[u].double()
            return torch.stack([x, y, x * y, x * x] if products else [x, y])

        def window(u):
            d = torch.zeros_like(v)
            for t in range(max(0, u - 2 * r), u + 1):
                d = d + terms(t)
            return d

        v = torch.zeros((4 if products else 2, width + 2 * r),
                        dtype=torch.float64)
        rows = []
        for s0 in range(0, n_pad, step):
            kept = torch.ones(width + 2 * r, dtype=torch.bool)
            sums = []
            for u in range(s0, s0 + step):
                zero = torch.zeros_like(xe[u])
                lx, ly = (xe[u - k], ye[u - k]) if u >= k else (zero, zero)
                v = v + (terms(u) - (terms(u - k) if u >= k else 0.0))
                f = v.float()
                kept &= _keeps(ly, f[1], REBUILD_F64) & (
                    _keeps(lx * lx, f[3], REBUILD_F64) if products
                    else _keeps(lx, f[0], REBUILD_F64))
                sums.append(f)
            if repair and not bool(kept.all()):
                for i, u in enumerate(range(s0, s0 + step)):
                    d = window(u)
                    sums[i] = torch.where(kept, sums[i], d.float())
                v = torch.where(kept, v, d)
            rows += [f for u, f in zip(range(s0, s0 + step), sums)
                     if 2 * r <= u < n]
        cols = torch.stack(rows, 1)  # (planes, rows, width + 2r)
        parts = cols.unfold(-1, length + 2 * r, length)
        out.append(_row_window_sums(parts, r, length, repair)
                   .flatten(-2)[..., :w])
    return torch.cat(out, 1)


def _shrink_coef(h, w, r):
    """The shrink instance's per-pixel coef: the f32 reciprocal of the
    window's area inside the frame, cy(y) cx(x) from the per-axis counts."""
    def counts(n):
        i = np.arange(n)
        return np.minimum(i + r, n - 1) - np.maximum(i - r, 0) + 1
    area = counts(h)[:, None] * counts(w)[None, :]
    return torch.from_numpy((1.0 / area.astype(np.float32)).astype(
        np.float32))


def _twopass_model(I, p, r, eps, seg_rows, shrink=False):
    """csrc/guided.cu's two walks on the CPU: a and b from launch 1's window
    sums (ab_of: each multiply and add rounded on its own, float32), then q
    from launch 2's window sums of a and b (q_of). ``shrink``: the shrink
    instance, zero outside the frame and each sum scaled by its own
    _shrink_coef."""
    k = 2 * r + 1
    coef = (_shrink_coef(*I.shape, r) if shrink
            else float(np.float32(1.0 / (k * k))))
    si, sp, sip, sii = _twopass_walk_sums(I, p, r, seg_rows, True,
                                          shrink=shrink)
    imu, pmu, ipmu, iimu = si * coef, sp * coef, sip * coef, sii * coef
    a = (ipmu - pmu * imu) / ((iimu - imu * imu) + eps)
    b = pmu - a * imu
    sa, sb = _twopass_walk_sums(a, b, r, seg_rows, False, shrink=shrink)
    return (sa * coef) * I + sb * coef


@pytest.mark.parametrize("shape,radius", [
    ((70, 150), 1), ((70, 150), 2), ((70, 150), 8), ((70, 150), 20),
    ((3, 9), 4), ((6, 40), 8), ((1, 7), 2), ((40, 200), 20)])
def test_twopass_walk_model_matches_plain_and_pallas(rng, shape, radius):
    """The redesigned twopass kernel's summation order (f64 running sums down
    the columns of 32-row segments, f32 running sums along 16- and 8-column
    parts of the rows, in each launch) stays within tpuimg's 1e-4 contract
    of the plain version's direct sums and of tpuimg's twopass (its Pallas
    kernels in interpret mode; its XLA path on frames smaller than the
    halo), at radii past the tile kernel's old ceiling of 16 and on frames
    smaller than the reflect-101 halo."""
    I, p = _pair(rng, shape)
    got = _twopass_model(torch.from_numpy(I), torch.from_numpy(p), radius,
                         1e-3, 32).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    plain = guided_filter_kernel(torch.from_numpy(I), torch.from_numpy(p),
                                 radius, 1e-3, variant="twopass").numpy()
    assert _maxdiff(got, plain) <= 1e-4
    if min(shape) > 2 * radius:
        ref = guided_filter_pallas(I, p, radius, 1e-3, variant="twopass")
    else:
        ref = tpuimg.guided_filter(I, p, radius, 1e-3, border="reflect101")
    assert _maxdiff(got, ref) <= 1e-4


def _rgb_shrink_config():
    from bench_torch import harness

    return harness.load_module(
        harness.HERE / "configs" / "guided-rgb-shrink-4k.py")


@pytest.mark.parametrize("shape", [(48, 64), (5, 7)])
@pytest.mark.parametrize("radius", [1, 8, 15, 16])
@pytest.mark.parametrize("form", ["general", "self", "cn1"])
def test_twopass_shrink_model_matches_tpuimg_and_reference(rng, shape,
                                                           radius, form):
    """The twopass kernel's shrink instance (zero outside the frame, each
    sum over its window's own area from the per-axis counts), summed as its
    two walks sum, stays within 1e-4 of tpuimg's shrink guided filter (the
    reference's class path, XLA on the CPU), of the rgb shrink cell's
    float64 reference and of the wrapper's plain version, general,
    self-guided and CN1, on frames where windows are clamped at both ends
    (5x7 at every radius here)."""
    I, p = _pair(rng, shape)
    if form == "cn1":
        p = np.clip(I + 0.1 * rng.standard_normal((3,) + shape), 0,
                    1).astype(np.float32)
    elif form == "self":
        p = I
    It, pt = torch.from_numpy(I), torch.from_numpy(p)
    got = torch.stack([_twopass_model(It, pc, radius, 1e-3, 32, shrink=True)
                       for pc in (pt if form == "cn1" else pt[None])])
    got = got.reshape(p.shape).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    ref = tpuimg.guided_filter(I, I if form == "self" else p, radius, 1e-3)
    assert _maxdiff(got, ref) <= 1e-4
    cfg = {"params": {"radius": radius, "eps": 1e-3}}
    ref64 = _rgb_shrink_config().reference(cfg, It, pt, torch.float64)
    assert _maxdiff(got, ref64.numpy()) <= 1e-4
    plain = guided_filter_kernel(It, It if form == "self" else pt, radius,
                                 1e-3, self_guided=form == "self",
                                 border="shrink")
    assert _maxdiff(got, plain.numpy()) <= 1e-4


def _tail_walks_model(f, rg, sigma, r, eps, seg_ab, seg_q):
    """csrc/enhance_tail.cuh's two walks on the CPU: p, the gaussian of the
    reflect-101 extended f (down the columns, then along the rows, in the
    plain version's symmetric form); walk 1's window sums of I = f, p, I*p
    and I*I over segments of ``seg_ab`` rows, a and b (ab_of); walk 2's
    window sums of a and b over segments of ``seg_q`` rows, q (q_of). Both
    walks sum as twopass's launches do, without the repair (f in [0, 1])."""
    k = 2 * r + 1
    coef = float(np.float32(1.0 / (k * k)))
    wts = taps(rg, sigma)
    p = _sep_pass(_sep_pass(pad_reflect101(f, rg, rg), wts, 0), wts, 1)
    si, sp, sip, sii = _twopass_walk_sums(f, p, r, seg_ab, True, repair=False)
    imu, pmu, ipmu, iimu = si * coef, sp * coef, sip * coef, sii * coef
    a = (ipmu - pmu * imu) / ((iimu - imu * imu) + eps)
    b = pmu - a * imu
    sa, sb = _twopass_walk_sums(a, b, r, seg_q, False, repair=False)
    return (sa * coef) * f + sb * coef


# (shape, r, rg): frames just above the callers' gate min(H, W) > 2(2r + rg)
# (37x70: r 1 at every rg, r 2 and 8 at rg <= 2), and 300x517, whose
# segments and 128-column strips end inside the frame, at every r by rg
TAIL_WALK_CASES = (
    [((37, 70), r, rg) for r, rg in ((1, 0), (1, 2), (1, 16), (2, 0), (2, 2),
                                     (8, 0), (8, 2))]
    + [((300, 517), r, rg) for r in (1, 2, 8, 20, 64) for rg in (0, 2, 16)])


@pytest.mark.parametrize("shape,radius,radius_g", TAIL_WALK_CASES)
def test_tail_walks_model_matches_plain_and_pallas(rng, shape, radius,
                                                   radius_g):
    """The enhance tail's two strip walks (csrc/enhance_tail.cuh: f64
    running sums down the columns of each segment, f32 running sums along
    16- and 8-column parts of the rows, a and b through device memory, no
    repair) stay within tpuimg's 1e-4 contract of the plain version's
    direct sums and of tpuimg's enhance_tail_pallas in interpret mode, at
    every radius the tail takes, walk 1's and walk 2's segments cut apart
    (their grids differ on the card)."""
    f = rng.random(shape, dtype=np.float32)
    sigma = 1.5 if radius_g <= 2 else 5.0
    seg_ab, seg_q = max(32, 2 * radius), max(48, 2 * radius)
    got = _tail_walks_model(torch.from_numpy(f), radius_g, sigma, radius,
                            1e-3, seg_ab, seg_q).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    plain = enhance_tail_plain(torch.from_numpy(f), radius_g, sigma, radius,
                               1e-3).numpy()
    assert _maxdiff(got, plain) <= 1e-4
    ref = enhance_tail_pallas(f, radius_g, sigma, radius, 1e-3)
    assert _maxdiff(got, ref) <= 1e-4


PLANTED = [float("nan"), float("inf"), float("-inf"), 1e3, 1e8, 1e20]


def _classes(x):
    """0 finite, 1 +inf, 2 -inf, 3 NaN."""
    x = np.asarray(x, np.float32)
    return np.select([np.isnan(x), np.isposinf(x), np.isneginf(x)], [3, 1, 2],
                     0)


@pytest.mark.parametrize("plane", ["I", "p"])
@pytest.mark.parametrize("value", PLANTED)
@pytest.mark.parametrize("radius", [2, 8])
def test_twopass_model_planted_value_matches_plain_and_pallas(radius, value,
                                                              plane):
    """The twopass walks' repaired running sums (walker::keeps: a sum that
    is not finite, or from which a term much larger than itself has just
    left, rebuilt from its window) with a NaN, an infinity or a large value
    at one pixel of I or p: at an inner pixel, on a 32-row segment boundary
    and 64-column strip edge, and on a 128-column strip edge. The model's
    non-finite outputs are the plain version's and tpuimg's twopass (NaN
    for NaN, the same infinities), and it is within 1e-4 of both outside
    the (4r + 1)^2 block around the pixel. Without the repair the value
    stays in the running sums of its strip: 1134 non-finite outputs at r 2
    where these give 81."""
    I0, p0 = _pair(np.random.default_rng(0), SHAPE)
    for y, x in ((5, 10), (32, 64), (50, 128)):
        I, p = I0.copy(), p0.copy()
        (I if plane == "I" else p)[y, x] = value
        got = _twopass_model(torch.from_numpy(I), torch.from_numpy(p), radius,
                             1e-3, 32).numpy()
        plain = guided_filter_kernel(torch.from_numpy(I), torch.from_numpy(p),
                                     radius, 1e-3, variant="twopass").numpy()
        ref = np.asarray(guided_filter_pallas(I, p, radius, 1e-3,
                                              variant="twopass"))
        far = np.ones(SHAPE, bool)
        far[max(0, y - 2 * radius):y + 2 * radius + 1,
            max(0, x - 2 * radius):x + 2 * radius + 1] = False
        for want in (plain, ref):
            np.testing.assert_array_equal(_classes(got), _classes(want))
            keep = far & np.isfinite(want)
            assert _maxdiff(got[keep], want[keep]) <= 1e-4
