"""tpuimg_torch kernel modules against tpuimg, on the CPU.

On a CPU tensor every wrapper runs its plain PyTorch version; these tests hold
those versions to the JAX package's Pallas kernels (interpret mode on the CPU
backend, as tests/test_pallas_kernels.py runs them) and to its NumPy oracles.
The CUDA kernels themselves run in chip_smoke.py and tests/test_torch_cuda.py
on the card.
"""

import collections
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpuimg.core.borders import reflect101_index as jax_reflect101_index
from tpuimg.kernels.boxsum import enhance_tail_pallas
from tpuimg.kernels.hist import hist_tiles_fused
from tpuimg.kernels.lut import clahe_map_full
from tpuimg.oracle import clahe_ref
from tpuimg.oracle.numpy_ref import clahe_tile_geometry, clahe_tile_hists_ref
from tpuimg.ops.histogram import _clahe_front, _map_bank, _tile_coord_runs
from tpuimg_torch import clahe, kernels, profiling
from tpuimg_torch.core.borders import pad_reflect101, reflect101_index
from tpuimg_torch.kernels.boxsum import enhance_tail, enhance_tail_plain
from tpuimg_torch.kernels.hist import (
    TILE_HIST_MAX_CLUSTER, tile_hist, tile_hist_plain, tile_hist_plan,
    tile_row, tile_runs)
from tpuimg_torch.ops.histogram import (
    _clahe_geometry, _clahe_scale, _clahe_tables, _clip_redistribute)
from tpuimg_torch.kernels.lut import clahe_map, clahe_map_plain

# the bound of clahe_ref's tile geometry (tpuimg/ops/histogram.py:272): every
# frame below needs at most pad < n of reflect-101 padding
HIST_CASES = [((96, 160), (4, 4)), ((130, 390), (2, 3)),
              ((90, 110), (8, 8))]  # the last one pads 3 rows, 1 column


@pytest.mark.parametrize("shape,grid", HIST_CASES)
def test_tile_hist_plain_matches_pallas_and_oracle(rng, shape, grid):
    """Bit-exact against hist_tiles_fused (interpret mode) over the same
    reflect-101 extension, and against the oracle's per-tile counts."""
    yt, xt = grid
    h, w = shape
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    tw, th, pad_left, pad_top = clahe_tile_geometry(h, w, xt, yt)
    ys = jax_reflect101_index(np.arange(th * yt) - pad_top, h)
    xs = jax_reflect101_index(np.arange(tw * xt) - pad_left, w)
    ext = jnp.asarray(img[np.ix_(ys, xs)])
    pallas = np.asarray(hist_tiles_fused(ext, yt, xt, th, tw))
    got = tile_hist_plain(torch.from_numpy(img), yt, xt, th, tw, pad_top,
                          pad_left).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, clahe_tile_hists_ref(img, xt, yt))
    assert (got.sum(axis=1) == th * tw).all()


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_reflect101_matches_tpuimg(n):
    x = np.arange(-n + 1, 2 * n - 1)
    np.testing.assert_array_equal(
        reflect101_index(torch.from_numpy(x), n).numpy(),
        jax_reflect101_index(x, n))


def test_pad_reflect101_bound(rng):
    """Any pad, past the first mirror too: np.pad(mode="reflect")'s map,
    which jnp.pad and so tpuimg's XLA paths follow (constant for n = 1)."""
    for n in (1, 2, 5):
        x = torch.from_numpy(rng.random((2, n, n + 1), dtype=np.float32))
        for pad in range(3 * n + 1):
            np.testing.assert_array_equal(
                pad_reflect101(x, pad, 3 * n - pad).numpy(),
                np.pad(x.numpy(), ((0, 0), (pad, pad),
                                   (3 * n - pad, 3 * n - pad)),
                       mode="reflect"))
        idx = np.arange(-3 * n, 4 * n)
        np.testing.assert_array_equal(
            reflect101_index(torch.from_numpy(idx), n).numpy(),
            np.pad(np.arange(n), 3 * n, mode="reflect"))


def _tpuimg_map(img, tiles):
    """tpuimg's CLAHE front end and clahe_map_full f32 blend of img."""
    h, w = img.shape
    tables, th, tw, pad_top, pad_left = _clahe_front(
        jnp.asarray(img), 2.0, tiles, tiles)
    xinfo = [(x0, x1, tx1) for x0, x1, tx1, _tx2, _ in
             _tile_coord_runs(w, tiles, tw, pad_left, use_recip=True)]
    blend = clahe_map_full(
        jnp.asarray(img), _map_bank(tables, tiles, tiles), xinfo,
        pad_top=float(pad_top), th=float(th), ytiles=tiles,
        pad_left=float(pad_left),
        inv_tw=float(np.float32(1.0) / np.float32(tw)), out_f32=True)
    return np.array(tables), (th, tw, pad_top, pad_left), np.asarray(blend)


@pytest.mark.parametrize("shape,tiles", [((150, 200), 4), ((220, 260), 8)])
def test_clahe_map_plain_matches_pallas(rng, shape, tiles):
    """The same tables through both mappings: f32 blends within 1e-3 on
    the [0, 255] scale (op order differs, KNOWN_DIVERGENCES.md section 3)."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    tables, geo, ref = _tpuimg_map(img, tiles)
    got = clahe_map_plain(torch.from_numpy(img), torch.from_numpy(tables),
                          tiles, tiles, *geo, out_f32=True).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-3
    u8 = clahe_map_plain(torch.from_numpy(img), torch.from_numpy(tables),
                         tiles, tiles, *geo).numpy()
    np.testing.assert_array_equal(
        u8, np.clip(np.trunc(got), 0, 255).astype(np.uint8))


@pytest.mark.parametrize("shape,tiles", [((128, 128), (4, 4)),
                                         ((90, 110), (8, 8)),
                                         ((64, 200), (2, 5)),
                                         ((256, 384), (16, 16))])
def test_clahe_u8_within_one_step_of_oracle(rng, shape, tiles):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    xt, yt = tiles
    for clip in (2.0, 40.0):
        out = clahe(torch.from_numpy(img), clip, xt, yt).numpy()
        ref = clahe_ref(img, clip, xt, yt)
        assert out.dtype == np.uint8
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("shape", [(96, 150), (200, 260)])
def test_enhance_tail_plain_matches_pallas(rng, shape):
    """The bound of tests/test_pallas_kernels.py:353."""
    f = rng.random(shape, dtype=np.float32)
    ref = np.asarray(enhance_tail_pallas(f, 2, 1.5, 8, 1e-3))
    got = enhance_tail_plain(torch.from_numpy(f), 2, 1.5, 8, 1e-3).numpy()
    assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("rg,r", [(1, 1), (3, 4)])
def test_enhance_tail_plain_other_radii(rng, rg, r):
    f = rng.random((70, 90), dtype=np.float32)
    ref = np.asarray(enhance_tail_pallas(f, rg, 1.2, r, 1e-2))
    got = enhance_tail_plain(torch.from_numpy(f), rg, 1.2, r, 1e-2).numpy()
    assert np.abs(got - ref).max() < 1e-5


def test_wrappers_take_plain_version_on_cpu(rng):
    """On a CPU tensor each wrapper returns its plain version's result and
    launches nothing."""
    img = torch.from_numpy(rng.integers(0, 256, (90, 110), dtype=np.uint8))
    entries = ("tpuimg_tile_hist", "tpuimg_clahe_map", "tpuimg_enhance_tail")
    before = [kernels.launches[e] for e in entries]
    geo = (8, 8, 12, 14, 3, 1)  # ytiles, xtiles, th, tw, pad_top, pad_left
    assert torch.equal(tile_hist(img, *geo), tile_hist_plain(img, *geo))
    tables = torch.from_numpy(rng.random((64, 256), dtype=np.float32) * 255)
    assert torch.equal(clahe_map(img, tables, *geo, out_f32=True),
                       clahe_map_plain(img, tables, *geo, out_f32=True))
    f = torch.from_numpy(rng.random((90, 110), dtype=np.float32))
    assert torch.equal(enhance_tail(f, 2, 1.5, 8, 1e-3),
                       enhance_tail_plain(f, 2, 1.5, 8, 1e-3))
    after = [kernels.launches[e] for e in entries]
    assert after == before


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a card never runs the
    plain version: the wrapper raises before any launch."""
    img = torch.empty((64, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tile_hist(img, 4, 4, 16, 16, 0, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        clahe_map(img, torch.empty((16, 256), device="meta"), 4, 4, 16, 16,
                  0, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        enhance_tail(torch.empty((64, 64), device="meta"), 2, 1.5, 8, 1e-3)


class _FakeLib:
    """C entries that return cudaSuccess (tpuimg_a), then a CUDA error
    (tpuimg_b), and the error-string query."""

    def tpuimg_a(self, *args):
        return 0

    def tpuimg_b(self, *args):
        return 700

    def tpuimg_cuda_error_string(self, err):
        return b"an illegal memory access was encountered"


def test_launch_counts_each_entry_and_marks_its_first_span(monkeypatch):
    """kernels.launch is the one record of launches: one count a call of
    an entry, by entry, the span of its first call marked ``first``, and a
    call that returns an error counted and raised."""
    monkeypatch.setattr(kernels, "launches", collections.Counter())
    monkeypatch.setattr(kernels, "load", lambda: _FakeLib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(kernels, "_stream", lambda index: 7)
    cpu = torch.device("cpu")
    with profiling.recording() as rec:
        kernels.launch("tpuimg_a", cpu, 1)
        kernels.launch("tpuimg_a", cpu, 2)
        with pytest.raises(kernels.KernelLaunchError,
                           match=r"tpuimg_b: CUDA error 700 \(an illegal"):
            kernels.launch("tpuimg_b", cpu)
        kernels.launch("tpuimg_a", cpu, 3)
    assert kernels.launches == {"tpuimg_a": 3, "tpuimg_b": 1}
    assert [(s.name, s.detail, s.first) for s in rec.spans] == [
        ("kernels.launch", "tpuimg_a", True),
        ("kernels.launch", "tpuimg_a", False),
        ("kernels.launch", "tpuimg_b", True),
        ("kernels.launch", "tpuimg_a", False)]


def _clip_serial(hists, limit: int) -> list:
    """gClipLimit as the reference writes it, a tile at a time: the excess
    over limit stolen, every bin clipped and given steal >> 8, then the
    residual r = steal & 255 one count each to bins (i << 8) // r, i < r."""
    out = []
    for hv in hists.tolist():
        steal = sum(max(v - limit, 0) for v in hv)
        hv = [min(v, limit) + (steal >> 8) for v in hv]
        r = steal & 255
        for i in range(r):
            hv[(i << 8) // r] += 1
        out.append(hv)
    return out


@pytest.mark.parametrize("limit", [0, 1, 5, 37, 100, 299, 300])
def test_clip_redistribute_matches_serial_loop(rng, limit):
    """The closed form that csrc/tile_hist.cu's tables and the plain tables
    share, against the serial loop on random histograms (limit 0: every
    count redistributed; 300: nothing clipped)."""
    hists = rng.integers(0, 300, (6, 256))
    got = _clip_redistribute(torch.from_numpy(hists).to(torch.int32), limit)
    assert got.tolist() == _clip_serial(hists, limit)


@pytest.mark.parametrize("limit", [0, 10])
@pytest.mark.parametrize("steal", [256, 3 * 256, 1, 128, 255, 3 * 256 + 77])
def test_clip_redistribute_steal_multiple_of_256(rng, limit, steal):
    """Histograms built to steal exactly ``steal`` counts a tile: a
    multiple of 256 leaves no residual, the others every kind of one."""
    hists = rng.integers(0, limit + 1, (4, 256))
    for hv in hists:
        bins = rng.choice(256, 5, replace=False)
        cuts = np.sort(rng.integers(0, steal + 1, 4))
        hv[bins] = limit + np.diff(np.concatenate([[0], cuts, [steal]]))
    assert ((hists - limit).clip(min=0).sum(axis=1) == steal).all()
    got = _clip_redistribute(torch.from_numpy(hists).to(torch.int32), limit)
    assert got.tolist() == _clip_serial(hists, limit)
    assert (got.sum(dim=1) == torch.from_numpy(hists.sum(axis=1))).all()


def test_clahe_scale_caps_the_limit_at_the_tile(rng):
    """A clip limit whose count passes a tile's pixels clips nothing: the
    limit is capped at th*tw (clip 1e9 over 271x480 tiles would not fit an
    int32) and the tables are the unclipped cdf times fr."""
    th, tw = 271, 480
    fr = float(np.float32(255.0 / (th * tw)))
    assert _clahe_scale(1e9, th, tw) == (th * tw, fr)
    assert _clahe_scale(2.0, th, tw) == (int(th * tw * 2.0 / 256 + 0.5), fr)
    hists = torch.from_numpy(rng.integers(0, 2000, (4, 256))).to(torch.int32)
    got = _clahe_tables(hists, 1e9, th, tw)
    assert torch.equal(got, torch.cumsum(hists, -1).to(torch.float32) * fr)
    assert torch.equal(got, _clahe_tables(hists, 256.0, th, tw))


def test_clahe_front_builds_tables_by_device(monkeypatch, rng):
    """A CPU tensor builds the tables on the host (tile_hist, then
    _clahe_tables inside clahe.tables); a tensor on any other device asks
    the tile kernel's tile_tables for them, with _clahe_scale's limit and
    scale, inside clahe.hist. (A meta tensor stands in for a CUDA one.)"""
    from tpuimg_torch.ops import histogram

    calls = []

    def fake_tables(img, *args):
        calls.append(args)
        return torch.empty((64, 256), dtype=torch.float32, device=img.device)

    monkeypatch.setattr(histogram, "tile_tables", fake_tables)
    img = torch.from_numpy(rng.integers(0, 256, (90, 110), dtype=np.uint8))
    geo = _clahe_geometry(90, 110, 8, 8)
    with profiling.recording() as rec:
        tables, *got_geo = histogram._clahe_front(img, 2.0, 8, 8)
    assert calls == [] and tuple(got_geo) == geo
    assert [s.name for s in rec.spans] == ["clahe.hist", "clahe.tables"]
    assert torch.equal(tables, _clahe_tables(
        tile_hist_plain(img, 8, 8, *geo), 2.0, *geo[:2]))
    meta = torch.empty((90, 110), dtype=torch.uint8, device="meta")
    with profiling.recording() as rec:
        tables, *got_geo = histogram._clahe_front(meta, 2.0, 8, 8)
    assert tables.device.type == "meta" and tuple(got_geo) == geo
    assert calls == [(8, 8, *geo, *_clahe_scale(2.0, *geo[:2]))]
    assert [s.name for s in rec.spans] == ["clahe.hist"]


def test_tile_tables_refuses_other_devices():
    """tile_tables is the kernel alone: its plain version is _clahe_tables
    of tile_hist, so a CPU or meta tensor raises before any launch."""
    from tpuimg_torch.kernels.hist import tile_tables

    before = kernels.launches["tpuimg_tile_tables"]
    for dev in ("cpu", "meta"):
        img = torch.empty((64, 64), dtype=torch.uint8, device=dev)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tile_tables(img, 4, 4, 16, 16, 0, 0, 10, 0.5)
    assert kernels.launches["tpuimg_tile_tables"] == before


# the tile geometries of tests/test_torch_cuda.py::CLAHE_CASES, 4K and 1080p
# at 1, 2, 8, 16 and 64 tiles, and short or narrow frames whose pads reach
# the tile's side (9x9 at 8x8: pads 3 and 4 of 2-pixel tiles) or whose
# tiles are one column wide
RUN_CASES = ([((90, 110), (8, 8)), ((257, 511), (3, 5)), ((64, 64), (16, 16)),
              ((33, 1000), (1, 1)), ((2161, 3839), (8, 8))]
             + [(shape, (t, t)) for shape in ((2160, 3840), (1080, 1920))
                for t in (1, 2, 8, 16, 64)]
             + [((9, 9), (8, 8)), ((5, 7), (4, 6)), ((2, 300), (2, 64)),
                ((33, 7), (3, 7))])


@pytest.mark.parametrize("shape,grid", RUN_CASES)
def test_tile_runs_model_counts_the_extension(rng, shape, grid):
    """csrc/tile_hist.cu's row map and column runs (tile_row, tile_runs):
    each tile's frame rows, and the multiset of its run columns, are
    reflect-101 of the extension's indices; a NumPy count through them
    equals tile_hist_plain and tpuimg's hist_tiles_fused (interpret mode)
    over the materialised extension."""
    h, w = shape
    yt, xt = grid
    th, tw, pad_top, pad_left = _clahe_geometry(h, w, xt, yt)
    rows = [[tile_row(h, th, pad_top, ty, r) for r in range(th)]
            for ty in range(yt)]
    cols = []
    for tx in range(xt):
        runs = tile_runs(w, tw, pad_left, tx)
        assert len(runs) == 3 and all(n >= 0 for _, n in runs)
        got = np.concatenate([np.arange(x0, x0 + n) for x0, n in runs])
        want = jax_reflect101_index(np.arange(tw) + tx * tw - pad_left, w)
        np.testing.assert_array_equal(np.sort(got), np.sort(want))
        assert got.min() >= 0 and got.max() < w
        cols.append(got)
    for ty in range(yt):
        np.testing.assert_array_equal(
            rows[ty],
            jax_reflect101_index(np.arange(th) + ty * th - pad_top, h))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    counts = np.stack([
        np.bincount(img[np.ix_(rows[ty], cols[tx])].ravel(), minlength=256)
        for ty in range(yt) for tx in range(xt)]).astype(np.int32)
    plain = tile_hist_plain(torch.from_numpy(img), yt, xt, th, tw, pad_top,
                            pad_left).numpy()
    np.testing.assert_array_equal(counts, plain)
    ys = jax_reflect101_index(np.arange(th * yt) - pad_top, h)
    xs = jax_reflect101_index(np.arange(tw * xt) - pad_left, w)
    pallas = hist_tiles_fused(jnp.asarray(img[np.ix_(ys, xs)]), yt, xt, th,
                              tw)
    np.testing.assert_array_equal(counts, np.asarray(pallas))


@settings(max_examples=300, deadline=None)
@given(ytiles=st.integers(1, 64), xtiles=st.integers(1, 64),
       th=st.integers(1, 5000), tw=st.integers(1, 5000),
       sms=st.sampled_from([1, 66, 132, 144]))
def test_tile_hist_plan_counts_each_row_once(ytiles, xtiles, th, tw, sms):
    """A tile's cluster holds 1 to 8 blocks, a power of two that divides the
    grid (tiles x cluster blocks), and its blocks' row ranges take every
    row of the tile exactly once."""
    cluster, rows = tile_hist_plan(ytiles, xtiles, th, tw, sms)
    assert 1 <= cluster <= TILE_HIST_MAX_CLUSTER
    assert cluster & (cluster - 1) == 0
    assert (ytiles * xtiles * cluster) % cluster == 0
    assert rows >= 1 and cluster * rows >= th
    seen = np.zeros(th, np.int64)
    for k in range(cluster):
        seen[k * rows:min(th, (k + 1) * rows)] += 1
    assert (seen == 1).all()
    if ytiles * xtiles >= sms * 4 or th * tw < 2 * 4096:
        assert cluster == 1  # the tiles fill the card, or are small
