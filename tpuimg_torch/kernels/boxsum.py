"""The enhance pipeline's tail, ``q = guided(I=f, p=gaussian(f))``: the tail
kernel (csrc/enhance_tail.cu) and its plain PyTorch version.

Replaces ``tpuimg/kernels/boxsum.py::enhance_tail_pallas``. The plain
version is ``_tail_chain``'s algebra on the whole frame: pad once by the
total halo 2r + rg (reflect-101), smooth (down the columns, then along the
rows), then the guided chain in valid mode, so it never pads again.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuimg_torch.core.borders import pad_reflect101
from tpuimg_torch.core.validate import ParamError
from tpuimg_torch.kernels import MAX_TAPS, Taps, launch, require_cuda_tensor
from tpuimg_torch.ops.gaussian import _sep_pass, taps
from tpuimg_torch.ops.guided import _window_sum


def enhance_tail_plain(f, radius_g: int, sigma: float, radius: int,
                       eps: float):
    """q = guided_filter(I=f, p=gaussian(f, radius_g, sigma), radius, eps)
    for a float32 (H, W) frame, reflect-101 borders, 1/ksz^2."""
    rg, r = radius_g, radius
    h, w = f.shape
    ksz = 2 * r + 1
    coef = float(np.float32(1.0 / (ksz * ksz)))
    wts = taps(rg, sigma)
    fv = pad_reflect101(f, 2 * r + rg, 2 * r + rg)
    s = _sep_pass(_sep_pass(fv, wts, 0), wts, 1)  # (h + 4r, w + 4r)
    i = fv[rg:rg + h + 4 * r, rg:rg + w + 4 * r]

    def box_sum(x):
        return _window_sum(_window_sum(x, ksz, 1), ksz, 0)

    imu = box_sum(i) * coef
    pmu = box_sum(s) * coef
    ipmu = box_sum(i * s) * coef
    iimu = box_sum(i * i) * coef
    a = (ipmu - pmu * imu) / (iimu - imu * imu + eps)
    b = pmu - a * imu
    icen = i[2 * r:2 * r + h, 2 * r:2 * r + w]
    return (box_sum(a) * icen + box_sum(b)) * coef


def enhance_tail(f, radius_g: int, sigma: float, radius: int, eps: float):
    """``enhance_tail_plain`` on a CPU tensor; the CUDA kernel otherwise.
    Needs min(H, W) > 2*radius + radius_g."""
    if f.device.type == "cpu":
        return enhance_tail_plain(f, radius_g, sigma, radius, eps)
    require_cuda_tensor(f, "f", torch.float32)
    h, w = f.shape
    if 2 * radius_g + 1 > MAX_TAPS:
        raise ParamError(
            f"the tail kernel takes a gaussian radius <= {MAX_TAPS // 2}, "
            f"got {radius_g}")
    if min(h, w) <= 2 * radius + radius_g:
        raise ValueError(
            f"the tail kernel needs min(H, W) > 2*radius + radius_g = "
            f"{2 * radius + radius_g}, got {h}x{w}")
    tp = Taps()
    wts = taps(radius_g, sigma)
    tp.w[:len(wts)] = wts
    out = torch.empty_like(f)
    launch("tpuimg_enhance_tail", f.device, f.data_ptr(), h, w, tp, radius_g,
           radius, eps, out.data_ptr())
    enhance_tail.launches += 1
    return out


enhance_tail.launches = 0
