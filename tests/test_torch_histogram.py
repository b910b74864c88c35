"""tpuimg_torch's histogram equalization against tpuimg's, on the CPU.

On a CPU tensor the kernel wrappers run their plain versions; these tests
hold them to the JAX package's Pallas kernels (interpret mode on the CPU
backend, called directly as tests/test_pallas_kernels.py calls them), to its
XLA path and to its NumPy oracle. Histograms, table entries and HE output
are integers or copied bits, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tpuimg
import tpuimg_torch
from tpuimg_torch import kernels
from tpuimg.kernels.hist import (
    hist256_frames_pallas, hist256_groups_pallas,
    hist256_groups_pallas_packed, hist256_pallas)
from tpuimg.kernels.lut import lut_gather as jax_lut_gather
from tpuimg.kernels.lut import lut_gather_frames as jax_lut_gather_frames
from tpuimg.oracle.numpy_ref import hist_equalize_ref
from tpuimg.ops.histogram import apply_lut as jax_apply_lut
from tpuimg.ops.histogram import bincount256 as jax_bincount256
from tpuimg_torch.kernels.hist import (
    he_tables, he_tables_frames, hist256, hist256_frames, hist256_groups,
    hist256_groups_packed, hist256_groups_plain)
from tpuimg_torch.kernels.lut import (
    LUT_BLOCKS_PER_SM, LUT_CHUNK, LUT_ITER_CHUNKS, lut_gather,
    lut_gather_frames, lut_gather_frames_plain, lut_gather_plain,
    lut_gather_plan)
from tpuimg_torch.ops.histogram import _he_tables, apply_lut, bincount256


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def _bits(x):
    """An array's bits as integers of its width, so -0.0 and NaN payloads
    compare exactly."""
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32}[x.itemsize])


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (33, 130), (200, 300)])
def test_hist256_plain_matches_pallas(rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = hist256(torch.from_numpy(img)).numpy()
    assert got.dtype == np.int32 and got.shape == (256,)
    np.testing.assert_array_equal(got, np.asarray(hist256_pallas(img)))


@pytest.mark.parametrize("shape", [(3, 40, 50), (2, 33, 130)])
def test_hist256_frames_plain_matches_pallas(rng, shape):
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    got = hist256_frames(torch.from_numpy(frames)).numpy()
    assert got.dtype == np.int32 and got.shape == (shape[0], 256)
    np.testing.assert_array_equal(got,
                                  np.asarray(hist256_frames_pallas(frames)))


@pytest.mark.parametrize("shape", [(1, 7), (5, 1000), (64, 813)])
def test_hist256_groups_plain_matches_pallas(rng, shape):
    groups = rng.integers(0, 256, shape, dtype=np.uint8)
    got = hist256_groups(torch.from_numpy(groups))
    assert torch.equal(got, hist256_groups_plain(torch.from_numpy(groups)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(hist256_groups_pallas(groups)))


@pytest.mark.parametrize("shape", [(6, 256), (3, 1000), (1, 8161)])
def test_hist256_groups_packed_matches_pallas(rng, shape):
    """(G, P4) int32 words of four pixels, packed as
    tests/test_pallas_kernels.py packs them; words with the top bit set
    included (bytes >= 128 in the fourth place)."""
    g, p4 = shape
    pixels = rng.integers(0, 256, (g, 4 * p4), dtype=np.uint8)
    words = np.array(jax.lax.bitcast_convert_type(
        pixels.reshape(g, p4, 4), np.int32))
    assert (words < 0).any()
    got = hist256_groups_packed(torch.from_numpy(words))
    assert got.dtype == torch.int32 and got.shape == (g, 256)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(hist256_groups_pallas_packed(words)))
    assert torch.equal(got, hist256_groups(torch.from_numpy(pixels)))


def _table(rng, kind):
    """A 256-entry table: u8; int32 from random bits (values > 255 and
    negatives); float32 from random bits with -0.0, inf and a NaN with a
    payload; int16 (tpuimg's int32 round trip)."""
    bits = rng.integers(-2 ** 31, 2 ** 31, 256).astype(np.int32)
    if kind == "uint8":
        return rng.integers(0, 256, 256, dtype=np.uint8)
    if kind == "int32":
        return bits
    if kind == "int16":
        return bits.astype(np.int16)
    f32 = bits.view(np.float32).copy()
    f32[:3] = (-0.0, np.inf, np.nan)
    f32[3] = np.array([0x7FC00123], dtype=np.uint32).view(np.float32)[0]
    return f32


@pytest.mark.parametrize("kind", ["uint8", "int32", "float32", "int16"])
def test_lut_gather_plain_matches_pallas(rng, kind):
    table = _table(rng, kind)
    img = rng.integers(0, 256, (45, 70), dtype=np.uint8)
    ref = np.asarray(jax_lut_gather(table, img))
    got = lut_gather(torch.from_numpy(table), torch.from_numpy(img)).numpy()
    assert got.dtype == ref.dtype == table.dtype and got.shape == img.shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(got), _bits(table[img]))
    plain = lut_gather_plain(torch.from_numpy(table), torch.from_numpy(img))
    np.testing.assert_array_equal(_bits(plain.numpy()), _bits(got))


def test_lut_gather_frames_plain_matches_pallas(rng):
    tables = rng.integers(0, 256, (3, 256), dtype=np.uint8)
    imgs = rng.integers(0, 256, (3, 45, 70), dtype=np.uint8)
    got = lut_gather_frames(torch.from_numpy(tables), torch.from_numpy(imgs))
    ref = np.asarray(jax_lut_gather_frames(tables, imgs))
    assert got.dtype == torch.uint8 and got.shape == imgs.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, lut_gather_frames_plain(torch.from_numpy(tables),
                                                    torch.from_numpy(imgs)))


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (33, 130), (200, 300),
                                   (16, 32), (3, 40, 50), (2, 3, 40, 50)])
def test_hist_equalize_matches_tpuimg(rng, shape):
    """Against both of tpuimg's impls and the oracle, frame by frame for a
    batch. 16x32 has N = 512: factor 0.5, so every odd cdf is a tie."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = tpuimg_torch.hist_equalize(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8 and got.shape == shape
    for impl in ("pallas", "xla"):
        np.testing.assert_array_equal(
            got, np.asarray(tpuimg.hist_equalize(img, impl=impl)))
    frames = img.reshape((-1,) + shape[-2:])
    want = np.stack([hist_equalize_ref(f) for f in frames]).reshape(shape)
    np.testing.assert_array_equal(got, want)


def test_ties_round_half_to_even():
    """A 16x32 frame whose histogram alternates 1, 3: the cdf of every even
    value is odd, so cdf * 0.5 ends in .5 and rounds to the even side
    (floor(x + 0.5) would round up)."""
    counts = np.tile([1, 3], 128)
    img = np.repeat(np.arange(256), counts).astype(np.uint8).reshape(16, 32)
    got = tpuimg_torch.hist_equalize(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, hist_equalize_ref(img))
    np.testing.assert_array_equal(
        got, np.asarray(tpuimg.hist_equalize(img, impl="pallas")))
    assert got[0, 0] == 0 and got[0, 1] == 2  # rint(0.5), rint(2.0)
    assert got[0, 4] == 2  # value 2: cdf 5, rint(2.5) = 2


def test_flat_frame_maps_to_255(rng):
    """min(255, ...) before the rounding: a flat frame's cdf * 256/N is 256
    at its value, which becomes 255, not 256 wrapped to 0."""
    for shape in ((40, 50), (2, 40, 50)):
        img = np.full(shape, 77, np.uint8)
        got = tpuimg_torch.hist_equalize(torch.from_numpy(img)).numpy()
        assert (got == 255).all()
        np.testing.assert_array_equal(
            got, np.asarray(tpuimg.hist_equalize(img, impl="pallas")))


def test_tables_round_cdf_above_2_24(rng):
    """An 8K frame's cdf passes 2^24, where the int -> float32 conversion
    rounds (to nearest even, in NumPy, XLA and PyTorch alike). Checked on
    8K-sized histograms, without the frame."""
    n = 4320 * 7680
    hists = rng.integers(100_000, 150_000, (2, 256))
    hists[:, -1] = n - hists[:, :-1].sum(axis=1)
    cdf = np.cumsum(hists, axis=-1)
    assert (hists > 0).all() and (cdf[:, -1] == n).all()
    assert ((cdf > 2 ** 24) & (cdf % 2 == 1)).any()
    got = _he_tables(torch.from_numpy(hists.astype(np.int32)), n).numpy()
    factor = np.float32(256.0 / n)
    oracle = np.rint(np.minimum(np.float32(255.0),
                                cdf.astype(np.float32) * factor))
    np.testing.assert_array_equal(got, oracle.astype(np.uint8))
    jcdf = jnp.cumsum(jnp.asarray(hists, jnp.int32), axis=-1)
    xla = jnp.rint(jnp.minimum(jnp.float32(255.0), jcdf.astype(jnp.float32)
                               * jnp.float32(256.0 / n))).astype(jnp.uint8)
    np.testing.assert_array_equal(got, np.asarray(xla))


def _exact_tables(frames):
    """The published rule from its definition, frame by frame: an integer
    histogram, the inclusive cdf, rint(min(255, cdf * 256 / N)) from the
    float64 quotient (exact here: a quotient that is not a tie lies at
    least 1/N from one), halves to even."""
    n = frames[0].size
    cdf = np.stack([np.cumsum(np.bincount(f.ravel(), minlength=256))
                    for f in frames])
    return np.rint(np.minimum(255.0, cdf * 256.0 / n)).astype(np.uint8)


@pytest.mark.parametrize("shape", [(3, 72, 96), (2, 1080, 1920)])
def test_batched_hist_equalize_equals_the_definition(shape):
    """A seeded stack, each frame by its own table, equal everywhere."""
    frames = np.random.default_rng(24 + shape[0]).integers(
        0, 256, shape, dtype=np.uint8)
    got = tpuimg_torch.hist_equalize(torch.from_numpy(frames)).numpy()
    tables = _exact_tables(frames)
    want = np.stack([t[f] for t, f in zip(tables, frames)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [16 * 32, 72 * 96, 1080 * 1920])
def test_tables_equal_the_exact_quotient_at_every_cdf(n):
    """Every cdf value from 0 to N through ``_he_tables`` (the f32 cdf
    times the f32 of 256/N, min 255, halves to even) against the float64
    rint(min(255, cdf * 256 / N)): equal at each, the ties included (N =
    512 makes every odd cdf one). Histograms of rows of 256 consecutive
    cdf values, the last row held at N."""
    rows = -(-(n + 1) // 256)
    cdf = np.minimum(np.arange(rows * 256), n).reshape(rows, 256)
    hists = np.diff(cdf, axis=1, prepend=0).astype(np.int32)
    got = _he_tables(torch.from_numpy(hists), n).numpy()
    want = np.rint(np.minimum(255.0, cdf * 256.0 / n)).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_bincount256_and_apply_lut_match_tpuimg(rng):
    x = rng.integers(0, 256, (3, 40, 50), dtype=np.uint8)
    for per_leading in (False, True):
        got = bincount256(torch.from_numpy(x), per_leading=per_leading)
        ref = np.asarray(jax_bincount256(x, per_leading=per_leading))
        np.testing.assert_array_equal(got.numpy(), ref)
    # finite float tables without -0.0: tpuimg's one-hot contraction sums
    # the selected entry with zeros
    for table in (rng.integers(0, 256, 256, dtype=np.uint8),
                  _table(rng, "int32"),
                  rng.standard_normal(256).astype(np.float32)):
        got = apply_lut(torch.from_numpy(table), torch.from_numpy(x))
        ref = np.asarray(jax_apply_lut(table, x))
        assert got.numpy().dtype == ref.dtype and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", ["float32", "float16", "int16", "1d",
                                  "empty"])
def test_same_typed_errors_as_tpuimg(case):
    """(float64 is left out: JAX without x64 narrows it to float32 before
    the check, so tpuimg's message names float32.)"""
    x = {"float32": np.zeros((8, 8), np.float32),
         "float16": np.zeros((8, 8), np.float16),
         "int16": np.zeros((8, 8), np.int16),
         "1d": np.zeros(8, np.uint8),
         "empty": np.zeros((0, 8), np.uint8)}[case]
    ours = _raised(lambda: tpuimg_torch.hist_equalize(torch.from_numpy(x)))
    theirs = _raised(lambda: tpuimg.hist_equalize(x))
    assert ours == theirs
    assert ours[0] == ("ShapeError" if case in ("1d", "empty")
                       else "DTypeError")


def test_wrappers_take_plain_version_on_cpu(rng):
    entries = ("tpuimg_hist256", "tpuimg_he_tables", "tpuimg_lut_gather")
    before = [kernels.launches[e] for e in entries]
    img = torch.from_numpy(rng.integers(0, 256, (2, 30, 40), dtype=np.uint8))
    tpuimg_torch.hist_equalize(img)
    tpuimg_torch.hist_equalize(img[0])
    bincount256(img, per_leading=True)
    apply_lut(torch.arange(256, dtype=torch.int32), img)
    he_tables(img.reshape(2, -1))
    he_tables_frames(img)
    assert [kernels.launches[e] for e in entries] == before == [0, 0, 0]


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 16, 32), (3, 41, 67),
                                   (2, 1080, 1920)])
def test_he_tables_take_plain_version_on_cpu(shape):
    """On a CPU tensor ``he_tables`` and ``he_tables_frames`` are the
    plain rule on the plain histograms (the definition too), launch
    nothing, and ``hist_equalize`` still builds its tables in ``he.tables``
    between the histogram and the mapping."""
    from tpuimg_torch import profiling

    frames = np.random.default_rng(25 + shape[1]).integers(
        0, 256, shape, dtype=np.uint8)
    x = torch.from_numpy(frames)
    groups = x.reshape(shape[0], -1)
    want = _he_tables(hist256_groups_plain(groups), groups.shape[1])
    before = kernels.launches["tpuimg_he_tables"]
    got = he_tables(groups)
    assert got.dtype == torch.uint8 and got.shape == (shape[0], 256)
    assert torch.equal(got, want)
    assert torch.equal(he_tables_frames(x), want)
    assert kernels.launches["tpuimg_he_tables"] == before == 0
    np.testing.assert_array_equal(got.numpy(), _exact_tables(frames))
    for img in (x, x[0]):
        with profiling.recording() as rec:
            tpuimg_torch.hist_equalize(img)
        assert [s.name for s in rec.spans] == [
            "ops.hist_equalize", "he.hist", "he.tables", "he.map"]


def test_wrappers_refuse_non_cuda_devices(monkeypatch):
    """A tensor neither on the CPU nor on a card never runs a plain
    version: each wrapper, and hist_equalize through them, raises. (A meta
    tensor stands in for a CUDA one; the checks look at the device type.)"""
    from tpuimg_torch.kernels import hist, lut

    def must_not_run(*args, **kwargs):
        raise AssertionError("a plain version ran off the CPU")

    for mod, name in ((hist, "hist256_groups_plain"),
                      (hist, "hist256_groups_packed_plain"),
                      (lut, "lut_gather_plain"),
                      (lut, "lut_gather_frames_plain")):
        monkeypatch.setattr(mod, name, must_not_run)
    img = torch.empty((64, 64), dtype=torch.uint8, device="meta")
    words = torch.empty((64, 16), dtype=torch.int32, device="meta")
    table = torch.empty(256, dtype=torch.uint8, device="meta")
    for call in (lambda: hist256_groups(img),
                 lambda: hist256_groups_packed(words),
                 lambda: he_tables(img),
                 lambda: he_tables_frames(img[None]),
                 lambda: lut_gather(table, img),
                 lambda: lut_gather_frames(table[None], img[None]),
                 lambda: tpuimg_torch.hist_equalize(img),
                 lambda: tpuimg_torch.hist_equalize(img[None])):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            call()


def _chunk_words(k: int, total: int, offset: int) -> list[int]:
    """The aligned 16-byte input words that csrc/lut_gather.cu's load16
    reads for chunk k of an input at ``offset`` past a 16-byte boundary
    (the word at and the word after its first byte; only the first when
    the input is aligned); a short last chunk reads byte by byte: none."""
    if (k + 1) * LUT_CHUNK > total:
        return []
    first = (offset + k * LUT_CHUNK) // 16
    return [first] if offset % 16 == 0 else [first, first + 1]


def _chunk_frames(i0: int, count: int, n: int) -> list[int]:
    """The frame of each pixel of a chunk as the kernel tracks it: the
    chunk's first pixel's, then one more each time a pixel reaches the next
    frame's start."""
    f, nxt, out = i0 // n, (i0 // n + 1) * n, []
    for i in range(i0, i0 + count):
        if i >= nxt:
            f, nxt = f + 1, nxt + n
        out.append(f)
    return out


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 2 ** 25), frames=st.integers(1, 70000),
       offset=st.integers(0, 15), sms=st.sampled_from([1, 66, 132, 144]),
       pick=st.integers(0, 2 ** 62))
def test_lut_gather_plan_covers_each_pixel_once(n, frames, offset, sms,
                                                pick):
    """The blocks' chunk ranges cover the chunks of (frames x n) pixels
    once, in at most LUT_BLOCKS_PER_SM blocks an SM and none empty; every
    pixel falls in the one chunk k = i // 16; a full chunk's loads, at any
    input offset, are aligned words that each hold a byte of it and
    together hold all 16; and the frame tracked pixel by pixel is i // n."""
    total = n * frames
    chunks = -(-total // LUT_CHUNK)
    blocks, per_block = lut_gather_plan(total, sms)
    assert 1 <= blocks <= sms * LUT_BLOCKS_PER_SM
    assert per_block % LUT_ITER_CHUNKS == 0
    assert (blocks - 1) * per_block < chunks <= blocks * per_block
    for k in {0, chunks - 1, max(chunks - 2, 0), pick % chunks}:
        b = k // per_block  # the one block whose range holds chunk k
        assert b * per_block <= k < min(chunks, (b + 1) * per_block) and (
            b < blocks)
        lo, hi = k * LUT_CHUNK, min(total, (k + 1) * LUT_CHUNK)
        assert hi > lo and (k == chunks - 1) == (hi == total)
        words = _chunk_words(k, total, offset)
        if words:
            span = set()
            for word in words:
                got = set(range(16 * word, 16 * word + 16)) & set(
                    range(offset + lo, offset + hi))
                assert got, "a load that holds no byte of the chunk"
                span |= got
            assert span == set(range(offset + lo, offset + hi))
        else:
            assert hi - lo < LUT_CHUNK
        assert _chunk_frames(lo, hi - lo, n) == [i // n
                                                 for i in range(lo, hi)]
