"""tpuimg_torch's colour conversions against tpuimg's and cv2's, on the CPU.

tpuimg computes them as XLA elementwise math; the port's are plain PyTorch.
PyTorch has no cube root, so the Lab forward may differ from tpuimg's by
one step on a few channels: the contract against tpuimg is <= 1 step, and
against cv2 the contracts of tests/test_color.py (<= 1 forward, <= 2 for
the inverse on the same Lab input).
"""

import numpy as np
import pytest
import torch

from tpuimg.ops import color as jax_color
from tpuimg_torch.core.validate import DeviceError, ShapeError
from tpuimg_torch.ops.color import (
    bgr_to_lab, lab_to_bgr, lab_to_rgb, rgb_to_gray, rgb_to_lab)

SHAPES = [(32, 48, 3), (2, 17, 23, 3)]
FUNCS = ["rgb_to_lab", "lab_to_rgb", "bgr_to_lab", "lab_to_bgr", "rgb_to_gray"]


def _steps(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", FUNCS)
def test_matches_tpuimg_within_one_step(rng, name, shape):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = globals()[name](torch.from_numpy(x))
    ref = np.asarray(getattr(jax_color, name)(x))
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    assert _steps(got.numpy(), ref) <= 1


def test_every_colour_within_one_step_of_tpuimg():
    """All 2^24 colours would be slow; 2^16 seeded ones plus the corners and
    the grays."""
    rng = np.random.default_rng(7)
    corners = np.array([[r, g, b] for r in (0, 255) for g in (0, 255)
                        for b in (0, 255)], np.uint8)
    grays = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    rgb = np.concatenate([rng.integers(0, 256, (1 << 16, 3), dtype=np.uint8),
                          corners, grays])
    for name in ("rgb_to_lab", "lab_to_rgb", "rgb_to_gray"):
        got = globals()[name](torch.from_numpy(rgb)).numpy()
        assert _steps(got, np.asarray(getattr(jax_color, name)(rgb))) <= 1


def test_lab_matches_opencv(rng):
    cv2 = pytest.importorskip("cv2")
    rgb = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    ours = rgb_to_lab(torch.from_numpy(rgb)).numpy()
    ref = cv2.cvtColor(rgb[..., ::-1], cv2.COLOR_BGR2Lab)
    assert _steps(ours, ref) <= 1


def test_lab_inverse_matches_opencv(rng):
    # the inverse on identical Lab inputs: a round trip is ill-conditioned
    # (one Lab step can move saturated RGB by ~15 levels)
    cv2 = pytest.importorskip("cv2")
    lab = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    ours = lab_to_rgb(torch.from_numpy(lab)).numpy()
    ref = cv2.cvtColor(lab, cv2.COLOR_Lab2BGR)[..., ::-1]
    assert _steps(ours, ref) <= 2


def test_gray_matches_opencv(rng):
    cv2 = pytest.importorskip("cv2")
    rgb = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    ours = rgb_to_gray(torch.from_numpy(rgb)).numpy()
    ref = cv2.cvtColor(rgb[..., ::-1], cv2.COLOR_BGR2GRAY)
    assert _steps(ours, ref) <= 1


def test_lab_roundtrip_mean(rng):
    rgb = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    back = lab_to_rgb(rgb_to_lab(torch.from_numpy(rgb))).numpy()
    assert np.abs(back.astype(int) - rgb.astype(int)).mean() < 1.0


def test_bgr_wrappers(rng):
    rgb = torch.from_numpy(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    assert torch.equal(bgr_to_lab(rgb.flip(-1)), rgb_to_lab(rgb))
    lab = rgb_to_lab(rgb)
    assert torch.equal(lab_to_bgr(lab), lab_to_rgb(lab).flip(-1))


def test_numpy_input_needs_a_card_and_channels_are_checked(rng):
    x = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError, match="CUDA card"):
            rgb_to_lab(x)
    with pytest.raises(ShapeError):
        rgb_to_lab(torch.zeros((4, 4, 4), dtype=torch.uint8))
