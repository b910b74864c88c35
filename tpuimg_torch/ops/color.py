"""Colour conversions: RGB/BGR <-> CIE L*a*b* and RGB -> gray (port of
``tpuimg.ops.color``).

The reference converts colour on the host with OpenCV (BGR -> Lab, process
L, merge back; Histogram/main.cpp:99-117). tpuimg computes the conversions
as fused elementwise math with no Pallas kernel, so here they are plain
PyTorch on the input's device: a CUDA tensor (or a NumPy array, which goes
to the card) converts on the card. Formulas are OpenCV's 8-bit Lab (D65,
sRGB linearisation, L*255/100 and a, b + 128), within 1 step of
``cv2.cvtColor`` and of tpuimg.

Each 3x3 product is three explicit multiply-adds, not a matmul, so no TF32
setting of the card touches it. PyTorch has no cube root: the Lab forward
takes ``x ** (1/3)`` on the branch where x > 0.008856, which moves a few
channels by one step against tpuimg's ``cbrt``.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.validate import ShapeError

# RGB(linear) -> XYZ, D65 (OpenCV's matrix)
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.240479, -1.537150, -0.498535),
    (-0.969256, 1.875992, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
_WHITE = (0.950456, 1.0, 1.088754)
_EPS = 0.008856  # (6/29)^3
_KAPPA = 903.3
_GRAY = (0.299, 0.587, 0.114)


def _channels(x, name: str):
    """The three channels of a (..., 3) tensor as float32 planes."""
    x = as_image(x)
    if x.ndim < 1 or x.shape[-1] != 3:
        raise ShapeError(f"{name} must be (..., 3), got {tuple(x.shape)}")
    return x.to(torch.float32).unbind(-1)


def _mix(m, c):
    """The 3x3 product m @ (c0, c1, c2), one multiply-add chain a row."""
    return [c[0] * r[0] + c[1] * r[1] + c[2] * r[2] for r in m]


def _round_u8(x):
    """Round half to even (``jnp.rint``), clamp to 0..255, uint8."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _srgb_to_linear(x):
    return torch.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)


def _linear_to_srgb(x):
    x = torch.clamp(x, min=0.0)
    return torch.where(x > 0.0031308, 1.055 * x ** (1.0 / 2.4) - 0.055,
                       12.92 * x)


def rgb_to_lab(rgb):
    """uint8 (..., 3) RGB -> uint8 (..., 3) Lab with OpenCV's 8-bit scaling."""
    lin = [_srgb_to_linear(c * (1.0 / 255.0)) for c in _channels(rgb, "rgb")]
    xyz = [v / wt for v, wt in zip(_mix(_RGB2XYZ, lin), _WHITE)]
    f = [torch.where(v > _EPS, torch.clamp(v, min=0.0) ** (1.0 / 3.0),
                     7.787 * v + 16.0 / 116.0) for v in xyz]
    y = xyz[1]
    L = torch.where(y > _EPS, 116.0 * f[1] - 16.0, _KAPPA * y)
    a = 500.0 * (f[0] - f[1]) + 128.0
    b = 200.0 * (f[1] - f[2]) + 128.0
    return _round_u8(torch.stack([L * (255.0 / 100.0), a, b], dim=-1))


def lab_to_rgb(lab):
    """uint8 (..., 3) Lab (OpenCV 8-bit scaling) -> uint8 (..., 3) RGB."""
    L, a, b = _channels(lab, "lab")
    L = L * (100.0 / 255.0)
    fy = (L + 16.0) / 116.0
    fx = fy + (a - 128.0) / 500.0
    fz = fy - (b - 128.0) / 200.0

    def cube(f):
        return f * f * f  # jnp's integer power: (f * f) * f

    def finv(f):
        return torch.where(cube(f) > _EPS, cube(f), (116.0 * f - 16.0) / _KAPPA)

    Y = torch.where(L > _KAPPA * _EPS, cube(fy), L / _KAPPA)
    xyz = [v * wt for v, wt in zip((finv(fx), Y, finv(fz)), _WHITE)]
    rgb = [_linear_to_srgb(v) * 255.0 for v in _mix(_XYZ2RGB, xyz)]
    return _round_u8(torch.stack(rgb, dim=-1))


def bgr_to_lab(bgr):
    return rgb_to_lab(as_image(bgr).flip(-1))


def lab_to_bgr(lab):
    return lab_to_rgb(lab).flip(-1)


def rgb_to_gray(rgb):
    """uint8 (..., 3) RGB -> uint8 (...) gray, OpenCV weights + rounding."""
    r, g, b = _channels(rgb, "rgb")
    return _round_u8(r * _GRAY[0] + g * _GRAY[1] + b * _GRAY[2])
