"""Integral image: the scan kernel (csrc/integral.cu) and its plain PyTorch
version.

Replaces ``tpuimg/kernels/scan2d.py::integral_pallas``. The plain version is
tpuimg's XLA form: a cumulative sum along each of the two trailing axes, here
in int64 and then wrapped to int32, which gives the same numbers as tpuimg's
int32 sums, wrapped mod 2^32 (``tpuimg.oracle.integral_ref`` wraps alike).
"""

from __future__ import annotations

import torch

from tpuimg_torch.kernels import launch, require_cuda_tensor


def integral_plain(img):
    """Inclusive 2-D prefix sum over the two trailing dims of an integer or
    bool tensor: int32, wrapped mod 2^32."""
    wide = img.to(torch.int64)
    return wide.cumsum(dim=-1).cumsum(dim=-2).to(torch.int32)


def integral_kernel(img):
    """``integral_plain`` on a CPU tensor; on a CUDA tensor the band scan
    over all leading dims of a contiguous u8 (..., H, W) tensor: one C call
    of up to three launches (band sums, their scan down the bands, the band
    rows), which keeps its column sums in the output it overwrites, so the
    wrapper allocates nothing else."""
    if img.device.type == "cpu":
        return integral_plain(img)
    require_cuda_tensor(img, "img", torch.uint8, batched=True)
    h, w = img.shape[-2:]
    out = torch.empty(img.shape, dtype=torch.int32, device=img.device)
    if out.numel() == 0:
        return out
    frames = img.numel() // (h * w)
    if frames * h >= 2 ** 31:
        raise ValueError(
            f"the scan kernel takes fewer than 2^31 rows in all, got "
            f"{frames} frames of {h}")
    launch("tpuimg_integral", img.device, img.data_ptr(), frames, h, w,
           out.data_ptr())
    return out
