"""tpuimg_torch's comparison metrics against tpuimg's, exact, on the CPU."""

import numpy as np
import pytest
import torch

from tpuimg.ops.metrics import max_abs_diff as jax_mad
from tpuimg.ops.metrics import max_abs_diff_loc as jax_loc
from tpuimg_torch.ops.metrics import max_abs_diff, max_abs_diff_loc


def _cases(rng):
    big = rng.integers(2**24, 2**30, (6, 9)).astype(np.int32)
    tie_a = np.zeros((5, 7), np.int32)
    tie_b = tie_a.copy()
    tie_b[1, 2] = tie_b[3, 4] = 9  # first maximum: (1, 2)
    f = rng.random((8, 8), dtype=np.float32)
    return {
        "int32 above 2^24": (big, big + rng.integers(0, 3, big.shape,
                                                     dtype=np.int32)),
        "int32 one apart at 2^24": (np.full((4, 4), 2**24, np.int32),
                                    np.full((4, 4), 2**24 + 1, np.int32)),
        "uint8 0 vs 255": (np.zeros((3, 5), np.uint8),
                           np.full((3, 5), 255, np.uint8)),
        "uint8 255 vs 0": (np.full((3, 5), 255, np.uint8),
                           np.zeros((3, 5), np.uint8)),
        "uint8 vs int32": (rng.integers(0, 256, (6, 6), dtype=np.uint8),
                           rng.integers(-9, 300, (6, 6)).astype(np.int32)),
        "tie": (tie_a, tie_b),
        "float32": (f, f + rng.random((8, 8), dtype=np.float32)),
        "bool": (rng.integers(0, 2, (5, 6)).astype(bool),
                 rng.integers(0, 2, (5, 6)).astype(bool)),
        "float32 vs uint8": (f * 255, rng.integers(0, 256, (8, 8),
                                                   dtype=np.uint8)),
    }


@pytest.mark.parametrize("case", ["int32 above 2^24", "int32 one apart at 2^24",
                                  "uint8 0 vs 255", "uint8 255 vs 0",
                                  "uint8 vs int32", "tie", "float32", "bool",
                                  "float32 vs uint8"])
def test_matches_tpuimg_exactly(rng, case):
    a, b = _cases(rng)[case]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = max_abs_diff(ta, tb)
    ref = np.asarray(jax_mad(a, b))
    assert got.ndim == 0 and got.device == ta.device
    assert got.numpy().dtype == ref.dtype and got.item() == ref.item()
    loc = max_abs_diff_loc(ta, tb)
    jloc = jax_loc(a, b)
    assert all(t.ndim == 0 for t in loc)
    assert [t.item() for t in loc] == [np.asarray(v).item() for v in jloc]


def test_uint8_does_not_wrap():
    a = torch.zeros((2, 2), dtype=torch.uint8)
    b = torch.full((2, 2), 255, dtype=torch.uint8)
    assert max_abs_diff(a, b).item() == 255
    assert max_abs_diff(a, b).dtype == torch.int32


def test_loc():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 255, (8, 16)).astype(np.int32)
    b = a.copy()
    b[3, 7] += 42
    d, y, x = max_abs_diff_loc(torch.from_numpy(a), torch.from_numpy(b))
    assert (int(d), int(y), int(x)) == (42, 3, 7)
