"""tpuimg_torch's integral image against tpuimg's, on the CPU.

On a CPU tensor the scan wrapper runs its plain version; these tests hold it
bit for bit to the JAX package's Pallas scan (interpret mode on the CPU
backend), to its XLA path for every integer dtype and bool, and to its NumPy
oracle, including sums that wrap past 2^31.
"""

import numpy as np
import pytest
import torch

import tpuimg
import tpuimg_torch
from tpuimg_torch import kernels
from tpuimg.kernels.scan2d import integral_pallas
from tpuimg.oracle.numpy_ref import integral_ref
from tpuimg_torch.kernels.scan2d import integral_kernel, integral_plain

SHAPES = [(1, 1), (7, 5), (24, 128), (49, 300), (2, 3, 40, 50)]
DTYPES = [np.uint8, np.int8, np.int16, np.uint16, np.int32, np.bool_]


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def _values(rng, shape, dtype):
    """Values over the dtype's whole range (int32's sums wrap)."""
    if dtype is np.bool_:
        return rng.integers(0, 2, shape).astype(bool)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_integral_plain_matches_pallas(rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = integral_kernel(torch.from_numpy(img)).numpy()
    assert got.dtype == np.int32 and got.shape == shape
    np.testing.assert_array_equal(got, np.asarray(integral_pallas(img)))
    frames = img.reshape((-1,) + shape[-2:])
    want = np.stack([integral_ref(f) for f in frames]).reshape(shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES)
def test_integral_matches_tpuimg(rng, shape, dtype):
    x = _values(rng, shape, dtype)
    got = tpuimg_torch.integral(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == shape
    impls = ("xla", "pallas") if dtype is np.uint8 else ("xla",)
    for impl in impls:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(tpuimg.integral(x, impl=impl)))


def test_integral_wraps_like_the_oracle():
    """A 3000x3000 frame of 255s sums to 2,295,000,000 > 2^31: int32 wraps
    it to -1999967296 in tpuimg, in the oracle and here."""
    frame = np.full((3000, 3000), 255, np.uint8)
    got = tpuimg_torch.integral(torch.from_numpy(frame)).numpy()
    assert got[-1, -1] == -1999967296
    np.testing.assert_array_equal(got, integral_ref(frame))
    np.testing.assert_array_equal(
        got, np.asarray(tpuimg.integral(frame, impl="xla")))


def test_integral_plain_wraps_int32_input(rng):
    """Sums of int32 values wrap mod 2^32 from the first row on."""
    x = np.full((3, 4), 2 ** 31 - 1, np.int32)
    got = integral_plain(torch.from_numpy(x)).numpy()
    want = (np.cumsum(np.cumsum(x.astype(np.int64), 1), 0)
            .astype(np.uint64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["float32", "float16", "1d", "empty"])
def test_same_typed_errors_as_tpuimg(case):
    """tpuimg's message points at jnp.cumsum, the port's at torch.cumsum.
    (float64 is left out: JAX without x64 narrows it to float32 before the
    check, so tpuimg's message names float32.)"""
    x = {"float32": np.zeros((8, 8), np.float32),
         "float16": np.zeros((8, 8), np.float16),
         "1d": np.zeros(8, np.uint8),
         "empty": np.zeros((8, 0), np.uint8)}[case]
    ours = _raised(lambda: tpuimg_torch.integral(torch.from_numpy(x)))
    theirs = _raised(lambda: tpuimg.integral(x))
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1].replace("jnp.cumsum", "torch.cumsum")
    assert ours[0] == ("ShapeError" if case in ("1d", "empty")
                       else "DTypeError")


def test_cpu_dispatch_launches_nothing_and_meta_raises(rng, monkeypatch):
    from tpuimg_torch.kernels import scan2d

    before = kernels.launches["tpuimg_integral"]
    tpuimg_torch.integral(torch.from_numpy(
        rng.integers(0, 256, (2, 20, 30), dtype=np.uint8)))
    assert kernels.launches["tpuimg_integral"] == before == 0
    meta = torch.empty((64, 64), dtype=torch.uint8, device="meta")
    with monkeypatch.context() as m:
        m.setattr(scan2d, "integral_plain", lambda *a: 1 / 0)
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            tpuimg_torch.integral(meta)
    # other dtypes are plain PyTorch on the tensor's device, as in XLA
    out = tpuimg_torch.integral(meta.to(torch.int16))
    assert out.device.type == "meta" and out.dtype == torch.int32


def _band_threads(w):
    """csrc/integral.cu's band-rows block: 4 columns a thread, a multiple of
    32 threads, at most kMaxThreads = 512 (chunks of 2048 columns)."""
    return min(512, (-(-w // 4) + 31) // 32 * 32)


def _integral_band_model(frames, rows):
    """csrc/integral.cu's band scan in NumPy, in uint32 (every sum wraps mod
    2^32) for (F, H, W) u8 frames cut into bands of ``rows`` rows (the card
    plans ``rows`` from its occupancy; this takes it as given):
    1. the band sums S_j of each column over band j's rows, j < bands - 1,
       and their inclusive sums down the bands, E_1 .. E_(bands - 1), in 32
       segments of bands: each segment's sum, the segments' exclusive scan,
       then a running sum through the segment;
    2. each band's rows: running column sums from E_b (0 for band 0), then
       each row's prefix from the parts the block sums: a thread's 4-column
       prefix, the exclusive scan of the run totals over a warp's 32 lanes,
       the exclusive scan of the warp totals, and the carry of the chunks of
       4 * threads columns to the left."""
    f, h, w = frames.shape
    x = frames.astype(np.uint32)
    bands = -(-h // rows)
    threads = _band_threads(w)
    chunk = 4 * threads
    nchunks = -(-w // chunk)
    # 1. band sums, and their scan down the bands in segments
    sums = [x[:, j * rows:(j + 1) * rows].sum(1, dtype=np.uint32)
            for j in range(bands - 1)]
    n = bands - 1
    carried = [np.zeros((f, w), np.uint32)]
    if n:
        seg = -(-n // 32)
        carry = np.zeros((f, w), np.uint32)
        for j0 in range(0, n, seg):
            run = carry.copy()
            for j in range(j0, min(n, j0 + seg)):
                run = run + sums[j]
                carried.append(run)
            carry = carry + np.sum(sums[j0:j0 + seg], 0, dtype=np.uint32)
    # 2. the band rows
    out = np.empty((f, h, w), np.uint32)
    for b in range(bands):
        y0, y1 = b * rows, min(h, (b + 1) * rows)
        cols = carried[b][:, None, :] + np.cumsum(x[:, y0:y1], 1,
                                                  dtype=np.uint32)
        padded = np.zeros((f, y1 - y0, nchunks * chunk), np.uint32)
        padded[..., :w] = cols
        runs = padded.reshape(f, y1 - y0, nchunks, threads // 32, 32, 4)
        pre = np.cumsum(runs, -1, dtype=np.uint32)
        tot = pre[..., -1]
        lanes = np.cumsum(tot, -1, dtype=np.uint32) - tot
        warps = np.cumsum(tot, -1, dtype=np.uint32)[..., -1]
        warp_ex = np.cumsum(warps, -1, dtype=np.uint32) - warps
        chunk_tot = warps.sum(-1, dtype=np.uint32)
        chunk_ex = np.cumsum(chunk_tot, -1, dtype=np.uint32) - chunk_tot
        row = (pre + lanes[..., None] + warp_ex[..., None, None]
               + chunk_ex[..., None, None, None])
        out[:, y0:y1] = row.reshape(f, y1 - y0, -1)[..., :w]
    return out.view(np.int32)


@pytest.mark.parametrize("shape,rows", [
    ((15, 17), 16), ((16, 3), 16), ((17, 1), 16), ((53, 4099), 16),
    ((3, 53, 17), 16), ((2, 40, 50), 7), ((300, 2100), 68)])
def test_integral_band_model_matches_pallas(rng, shape, rows):
    """The redesigned scan's decomposition (band sums and their scan down the
    bands, the band rows with chunk, warp and lane carries) equals tpuimg's
    Pallas scan (interpret mode) and its NumPy oracle bit for bit, on frames
    that end one row short of a band, on one, one row past one and five rows
    into a fourth, at widths of one column, of a partial 4-column run, and
    past one chunk of 2048 columns."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    frames = img.reshape((-1,) + shape[-2:])
    got = _integral_band_model(frames, rows).reshape(shape)
    np.testing.assert_array_equal(got, np.asarray(integral_pallas(img)))
    want = np.stack([integral_ref(f) for f in frames]).reshape(shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, integral_plain(torch.from_numpy(img)).numpy())


def test_integral_band_model_wraps_like_the_oracle():
    """All 255s over 3000x3000 in bands of 23 rows (131 bands, as one wave
    of the card plans them): the sums wrap mod 2^32 as the oracle's do."""
    frame = np.full((3000, 3000), 255, np.uint8)
    got = _integral_band_model(frame[None], 23)[0]
    assert got[-1, -1] == -1999967296
    np.testing.assert_array_equal(got, integral_ref(frame))
