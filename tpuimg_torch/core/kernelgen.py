"""Gaussian kernel weights with OpenCV semantics (port of
``tpuimg.core.kernelgen``: ``gaussian_kernel_1d`` and ``gaussian_kernel_2d``).

The same NumPy arithmetic as the JAX package, so the taps are the same bits:
``cv::getGaussianKernel(ksize, sigma)`` computed in float64, then cast.
"""

from __future__ import annotations

import numpy as np

from tpuimg_torch.core.validate import ParamError

# OpenCV's fixed small-kernel table, used when ksize <= 7 and sigma <= 0.
_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel_1d(ksize: int, sigma: float, dtype=np.float32) -> np.ndarray:
    """Equivalent of ``cv::getGaussianKernel(ksize, sigma)`` (normalized, CV_64F math)."""
    if ksize < 1 or ksize % 2 == 0:
        raise ParamError(f"ksize must be a positive odd integer, got {ksize}")
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        k = _SMALL_GAUSSIAN[ksize]
    else:
        s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
        x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
        k = np.exp(-(x * x) / (2.0 * s * s))
        k = k / k.sum()
    return k.astype(dtype)


def gaussian_kernel_2d(radius: int, sigma: float, dtype=np.float32) -> np.ndarray:
    """(2r+1, 2r+1) kernel = outer product of the 1D kernel (reference `gaussian.cu:445`)."""
    k1 = gaussian_kernel_1d(2 * radius + 1, sigma, dtype=np.float64)
    return np.outer(k1, k1).astype(dtype)
