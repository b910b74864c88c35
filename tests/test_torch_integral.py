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

    before = integral_kernel.launches
    tpuimg_torch.integral(torch.from_numpy(
        rng.integers(0, 256, (2, 20, 30), dtype=np.uint8)))
    assert integral_kernel.launches == before == 0
    meta = torch.empty((64, 64), dtype=torch.uint8, device="meta")
    with monkeypatch.context() as m:
        m.setattr(scan2d, "integral_plain", lambda *a: 1 / 0)
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            tpuimg_torch.integral(meta)
    # other dtypes are plain PyTorch on the tensor's device, as in XLA
    out = tpuimg_torch.integral(meta.to(torch.int16))
    assert out.device.type == "meta" and out.dtype == torch.int32
