"""Box sums and the guided filter: the guided-filter kernels
(csrc/guided.cu), the enhance pipeline's tail kernel (csrc/enhance_tail.cu),
and their plain PyTorch versions.

``guided_filter_kernel`` replaces ``tpuimg/kernels/boxsum.py::
guided_filter_pallas`` (variants "onepass" and "twopass"); its plain version
is tpuimg's reflect-101 chain with direct window sums: box means of I, p,
I*p and I*I, then a and b, then q = mean_a*I + mean_b. At the shrink border
(the reference's class path, which tpuimg computes in XLA) it runs the
twopass kernel's shrink instance, and its plain version is the same chain
with ``box_mean_shrink``: windows clamped to the frame, each mean over its
true area.

``guided_ypadded_kernel`` (the onepass kernel's row-padded entry) replaces
``guided_pallas_ypadded``: I and p blocks whose rows already carry 2r halo
rows on each side (a shard of ``parallel/sharding.py`` with its neighbours'
rows), (..., H + 4r, W) in and (..., H, W) out, at any radius (above
GUIDED_SMEM_MAX_RADIUS the kernel keeps its workspace in a device-memory
scratch, the scratch route). Its plain version is tpuimg's XLA form of
``guided_ypadded``: pad x only by 2r (reflect-101), the same chain with
valid-window box sums, q on the block's centre.

``enhance_tail``, q = guided(I=f, p=gaussian(f)), replaces
``enhance_tail_pallas``. Its kernel is two strip walks of the twopass
kernel's design in one C call (csrc/enhance_tail.cuh): walk 1 makes f once
per pixel of a strip and its halo and p = gaussian(f) from a ring of f rows,
on chip, and writes a and b to a device-memory scratch this module
allocates; walk 2 box-sums them and writes q. gf radius <= TAIL_MAX_RADIUS,
gaussian radius <= MAX_TAPS // 2; past a block's shared memory walk 1 keeps
the leaving rows' I and p in the scratch too (the scratch route). At 4K,
r8, rg2, u8 q: 0.2045 ms on an NVIDIA H100 80GB HBM3 at 700.00 W (bound
0.0124 ms, by bytes; PERF.md §6). Its plain version is ``_tail_chain``'s algebra on the whole
frame: pad once by the total halo 2r + rg (reflect-101), smooth (down the
columns, then along the rows), then the guided chain in valid mode, so it
never pads again. With ``out_u8`` either tail returns the u8 frame that the
enhance pipeline returns, ``q_to_u8(q)``, which the kernel computes in its
store (1 byte a pixel written instead of 4, and no elementwise pass after
it).

``enhance_tail_clahe`` (csrc/enhance_tail_clahe.cu), the same tail with f =
clahe_blend(img) / 255 computed inside the kernels (once per staged pixel
of walk 1 and per output pixel of walk 2), replaces
``enhance_tail_clahe_pallas`` (4K, u8 q: 0.2744 ms, same card; bound
0.0050 ms). Its plain version is the f32 CLAHE blend times 1/255,
then ``enhance_tail_plain``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpuimg_torch.core.borders import REFLECT101, SHRINK, pad_reflect101
from tpuimg_torch.core.validate import ParamError
from tpuimg_torch.kernels import (
    GUIDED_SMEM_MAX_RADIUS, GUIDED_TWOPASS_MAX_RADIUS, MAX_TAPS,
    TAIL_MAX_RADIUS, Taps, launch, load, require_cuda_tensor)
from tpuimg_torch.kernels.lut import (
    check_clahe_args, clahe_map_plain, inv_tile_width)
from tpuimg_torch.kernels.sep_stencil import _sep_pass, taps

# the f32 factor that takes the CLAHE blend to the tail's f, applied in the
# stores of clahe_map (its ``scale``) and enhance_tail_clahe.cu on the card:
# np.float32(1 / 255), bits 998277249
INV_255 = float(np.float32(1.0 / 255.0))

VARIANTS = ("onepass", "twopass")
# the radius each variant of guided_filter_kernel takes on the card
GUIDED_MAX_RADIUS = {"onepass": GUIDED_SMEM_MAX_RADIUS,
                     "twopass": GUIDED_TWOPASS_MAX_RADIUS}
# the variants with a kernel at each border, the default first: the shrink
# border has twopass alone, the faster at 4K (csrc/guided.cu's header)
BORDER_VARIANTS = {REFLECT101: VARIANTS, SHRINK: ("twopass",)}


def window_sum(x, ksz: int, dim: int):
    """Sum over every length-``ksz`` window along ``dim`` (valid mode: the
    caller supplies ksz - 1 taps of halo), as direct shifted adds."""
    n = x.shape[dim] - ksz + 1
    acc = x.narrow(dim, 0, n)
    for k in range(1, ksz):
        acc = acc + x.narrow(dim, k, n)
    return acc


def box_mean(x, radius: int):
    """Box mean over (2r+1)^2 windows of (..., H, W), reflect-101 border,
    fixed 1/ksz^2; direct window sums along the rows, then the columns."""
    ksz = 2 * radius + 1
    xp = pad_reflect101(x, radius, radius)
    s = window_sum(window_sum(xp, ksz, -1), ksz, -2)
    return s * (1.0 / (ksz * ksz))


def cumsum0(x, dim: int):
    """Inclusive cumsum along ``dim`` with a leading zero."""
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([zero, torch.cumsum(x, dim)], dim)


def _axis_counts(n: int, radius: int, device):
    """The rows (or columns) of each position's window inside the frame."""
    idx = torch.arange(n, device=device)
    return (torch.clamp(idx + 1 + radius, max=n)
            - torch.clamp(idx - radius, min=0))


def box_mean_shrink(x, radius: int):
    """Shrink-window box mean (gIntegralToMean): zero padding, cumsum window
    sums along the rows, then the columns, divided by the true area."""
    h, w = x.shape[-2], x.shape[-1]
    ksz = 2 * radius + 1
    xp = torch.nn.functional.pad(x, (radius, radius, radius, radius))
    c = cumsum0(xp, -1)
    rows = c[..., ksz:ksz + w] - c[..., :w]
    c2 = cumsum0(rows, -2)
    s = c2[..., ksz:ksz + h, :] - c2[..., :h, :]
    area = (_axis_counts(h, radius, x.device)[:, None]
            * _axis_counts(w, radius, x.device)[None, :]).to(x.dtype)
    return s / area


def guided_ab(I, p, eps: float, box, self_guided: bool = False):
    """a and b from the box means of I, p, I*p and I*I. ``p`` may carry one
    more leading dim than ``I`` (C channels guided by one I, broadcast).
    ``self_guided``: p is I, two of the four means."""
    mean_I = box(I)
    mean_II = box(I * I)
    mean_p = mean_I if self_guided else box(p)
    mean_Ip = mean_II if self_guided else box(I * p)
    a = (mean_Ip - mean_p * mean_I) / (mean_II - mean_I * mean_I + eps)
    return a, mean_p - a * mean_I


def guided_chain(I, p, eps: float, box, self_guided: bool = False):
    """q = box(a)*I + box(b), a and b from ``guided_ab``."""
    a, b = guided_ab(I, p, eps, box, self_guided)
    return box(a) * I + box(b)


def guided_filter_plain(I, p, radius: int, eps: float,
                        self_guided: bool = False, border: str = REFLECT101):
    """The guided filter of float32 (..., H, W) frames: reflect-101 border,
    1/ksz^2 normalisation (both kernel variants compute this), or the shrink
    border (``box_mean_shrink``, the twopass kernel's shrink instance)."""
    box = box_mean_shrink if border == SHRINK else box_mean
    return guided_chain(I, p, eps, functools.partial(box, radius=radius),
                        self_guided)


def _checked_pair(I, p, self_guided: bool):
    """The guided kernels' checks on the card; returns p (I when
    ``self_guided``)."""
    require_cuda_tensor(I, "I", torch.float32, batched=True)
    if self_guided:
        p = I
    require_cuda_tensor(p, "p", torch.float32, batched=True)
    if p.device != I.device or p.shape[-I.ndim:] != I.shape or (
            p.ndim not in (I.ndim, I.ndim + 1)):
        raise ValueError(
            f"p {tuple(p.shape)} on {p.device} must have the shape of I "
            f"{tuple(I.shape)}, or one more leading dim, on {I.device}")
    return p


def guided_filter_kernel(I, p, radius: int, eps: float,
                         variant: str | None = None,
                         self_guided: bool = False, border: str = REFLECT101):
    """``guided_filter_plain`` on a CPU tensor; on a CUDA tensor one launch
    (onepass) or one pair of launches (twopass) over all frames.

    I: float32 (..., H, W). p: float32 of I's shape, or with one more leading
    dim of C channels that share the guide (CN1). ``self_guided``: p is I,
    the onepass kernel's two-sum form (twopass always takes the four sums).
    ``variant``: one of BORDER_VARIANTS[border], by default its first
    (onepass at reflect-101, twopass at shrink). Takes radius <=
    GUIDED_MAX_RADIUS[variant] on the card (64 for both). Twopass writes a
    and b to device memory the wrapper allocates and reads them back in its
    second launch."""
    if border not in BORDER_VARIANTS:
        raise ParamError(f"border must be one of {list(BORDER_VARIANTS)}, "
                         f"got {border!r}")
    variants = BORDER_VARIANTS[border]
    variant = variants[0] if variant is None else variant
    if variant not in variants:
        raise ParamError(f"variant at the {border} border must be one of "
                         f"{variants}, got {variant!r}")
    if I.device.type == "cpu":
        return guided_filter_plain(I, p, radius, eps, self_guided, border)
    p = _checked_pair(I, p, self_guided)
    if radius > GUIDED_MAX_RADIUS[variant]:
        raise ParamError(
            f"the {variant} guided-filter kernel takes radius <= "
            f"{GUIDED_MAX_RADIUS[variant]}, got {radius}")
    h, w = I.shape[-2:]
    q = torch.empty_like(p)
    if q.numel() == 0:
        return q
    n_i, n = I.numel() // (h * w), p.numel() // (h * w)
    if variant == "onepass":
        launch("tpuimg_guided_onepass", I.device, I.data_ptr(), n_i,
               p.data_ptr(), n, h, w, radius, eps, int(self_guided),
               q.data_ptr())
    else:
        a, b = torch.empty_like(p), torch.empty_like(p)
        entry = ("tpuimg_guided_twopass_shrink" if border == SHRINK
                 else "tpuimg_guided_twopass")
        launch(entry, I.device, I.data_ptr(), n_i, p.data_ptr(), n, h, w,
               radius, eps, a.data_ptr(), b.data_ptr(), q.data_ptr())
    return q


def guided_ypadded_plain(Ipad, ppad, radius: int, eps: float,
                         self_guided: bool = False):
    """The guided filter of float32 (..., H + 4r, W) row-padded blocks:
    (..., H, W). x is padded by 2r (reflect-101); the box means are valid
    window sums times 1/ksz^2, so a and b on the ring rows come from the
    block's own halo rows."""
    r = radius
    ksz = 2 * r + 1
    I2 = pad_reflect101(Ipad, 0, 2 * r)
    p2 = I2 if self_guided else pad_reflect101(ppad, 0, 2 * r)

    def box(x):
        s = window_sum(window_sum(x, ksz, -1), ksz, -2)
        return s * (1.0 / (ksz * ksz))

    a, b = guided_ab(I2, p2, eps, box, self_guided)
    h, w = Ipad.shape[-2] - 4 * r, Ipad.shape[-1]
    return box(a) * I2[..., 2 * r:2 * r + h, 2 * r:2 * r + w] + box(b)


def guided_ypadded_kernel(Ipad, ppad, radius: int, eps: float,
                          self_guided: bool = False):
    """``guided_ypadded_plain`` on a CPU tensor; on a CUDA tensor one launch
    of the onepass kernel's row-padded entry over all frames, at any radius.
    Ipad: float32 (..., H + 4r, W), H >= 1; ppad: of its shape, or with one
    more leading dim (CN1); ignored when ``self_guided``. Above
    GUIDED_SMEM_MAX_RADIUS the launch takes the scratch route (its workspace
    in device memory), an entry of its own."""
    if Ipad.device.type == "cpu":
        return guided_ypadded_plain(Ipad, ppad, radius, eps, self_guided)
    p = _checked_pair(Ipad, ppad, self_guided)
    hin, w = Ipad.shape[-2:]
    h = hin - 4 * radius
    q = torch.empty(p.shape[:-2] + (h, w), dtype=torch.float32,
                    device=p.device)
    if q.numel() == 0:
        return q
    n_i, n = Ipad.numel() // (hin * w), p.numel() // (hin * w)
    args = (Ipad.data_ptr(), n_i, p.data_ptr(), n, h, w, radius, eps,
            int(self_guided))
    if radius <= GUIDED_SMEM_MAX_RADIUS:
        launch("tpuimg_guided_onepass_ypadded", Ipad.device, *args,
               q.data_ptr())
    else:
        floats = load().tpuimg_guided_onepass_scratch_floats(
            n, h, w, radius, int(self_guided))
        if floats < 0:
            raise ParamError(f"the guided-filter kernel takes radius < 2^22, "
                             f"got {radius}")
        scratch = torch.empty(floats, dtype=torch.float32, device=p.device)
        launch("tpuimg_guided_onepass_ypadded_scratch", Ipad.device, *args,
               scratch.data_ptr(), q.data_ptr())
    return q


def q_to_u8(q):
    """The u8 frame of a float32 q: clamp(round(q * 255), 0, 255), the f32
    product rounded half to even (torch.round; the kernels' store_q)."""
    return torch.clamp(torch.round(q * 255.0), 0.0, 255.0).to(torch.uint8)


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
        return window_sum(window_sum(x, ksz, 1), ksz, 0)

    imu = box_sum(i) * coef
    pmu = box_sum(s) * coef
    ipmu = box_sum(i * s) * coef
    iimu = box_sum(i * i) * coef
    a = (ipmu - pmu * imu) / (iimu - imu * imu + eps)
    b = pmu - a * imu
    icen = i[2 * r:2 * r + h, 2 * r:2 * r + w]
    return (box_sum(a) * icen + box_sum(b)) * coef


def _tail_taps(h: int, w: int, radius_g: int, sigma: float, radius: int):
    """The tail kernels' limits, checked before any launch, then their
    gaussian taps."""
    if 2 * radius_g + 1 > MAX_TAPS:
        raise ParamError(
            f"the tail kernel takes a gaussian radius <= {MAX_TAPS // 2}, "
            f"got {radius_g}")
    if not 1 <= radius <= TAIL_MAX_RADIUS:
        raise ParamError(
            f"the tail kernel takes 1 <= radius <= {TAIL_MAX_RADIUS}, got "
            f"{radius}")
    if min(h, w) <= 2 * radius + radius_g:
        raise ValueError(
            f"the tail kernel needs min(H, W) > 2*radius + radius_g = "
            f"{2 * radius + radius_g}, got {h}x{w}")
    tp = Taps()
    wts = taps(radius_g, sigma)
    tp.w[:len(wts)] = wts
    return tp


def _tail_scratch_floats(h: int, w: int, radius_g: int, radius: int) -> int:
    """The floats of device memory a tail call needs: the a and b planes,
    and past a block's shared memory (the scratch route) walk 1's rings of
    the leaving rows."""
    floats = load().tpuimg_enhance_tail_scratch_floats(h, w, radius_g,
                                                       radius)
    if floats < 0:
        raise ParamError(f"the tail kernel refuses radius {radius}, gaussian "
                         f"radius {radius_g} on {h}x{w}")
    return floats


def _tail_scratch(h: int, w: int, radius_g: int, radius: int, device):
    """A tail call's scratch on ``device``."""
    return torch.empty(_tail_scratch_floats(h, w, radius_g, radius),
                       dtype=torch.float32, device=device)


def enhance_tail(f, radius_g: int, sigma: float, radius: int, eps: float,
                 out_u8: bool = False):
    """``enhance_tail_plain`` on a CPU tensor; the CUDA kernel otherwise.
    Needs min(H, W) > 2*radius + radius_g, radius <= TAIL_MAX_RADIUS and
    radius_g <= MAX_TAPS // 2 (``ParamError`` before any launch). Returns
    float32 q, or ``q_to_u8(q)`` when ``out_u8``."""
    if f.device.type == "cpu":
        q = enhance_tail_plain(f, radius_g, sigma, radius, eps)
        return q_to_u8(q) if out_u8 else q
    require_cuda_tensor(f, "f", torch.float32)
    h, w = f.shape
    tp = _tail_taps(h, w, radius_g, sigma, radius)
    scratch = _tail_scratch(h, w, radius_g, radius, f.device)
    out = torch.empty((h, w), dtype=torch.uint8 if out_u8 else torch.float32,
                      device=f.device)
    launch("tpuimg_enhance_tail", f.device, f.data_ptr(), h, w, tp, radius_g,
           radius, eps, scratch.data_ptr(), int(out_u8), out.data_ptr())
    return out


def enhance_tail_clahe_plain(img, tables, ytiles: int, xtiles: int, th: int,
                             tw: int, pad_top: int, pad_left: int,
                             radius_g: int, sigma: float, radius: int,
                             eps: float):
    """q = enhance_tail_plain(f) with f = the f32 CLAHE blend of the u8
    (H, W) frame (``clahe_map_plain`` of the (ytiles*xtiles, 256) tables)
    times 1/255."""
    blend = clahe_map_plain(img, tables, ytiles, xtiles, th, tw, pad_top,
                            pad_left, out_f32=True)
    return enhance_tail_plain(blend * INV_255, radius_g, sigma, radius, eps)


def enhance_tail_clahe(img, tables, ytiles: int, xtiles: int, th: int,
                       tw: int, pad_top: int, pad_left: int, radius_g: int,
                       sigma: float, radius: int, eps: float,
                       out_u8: bool = False):
    """``enhance_tail_clahe_plain`` on a CPU tensor; on a CUDA tensor one
    call of two launches, the blend computed in the kernels and never
    stored. Takes any tile grid; the limits and the output of
    ``enhance_tail``."""
    if img.device.type == "cpu":
        q = enhance_tail_clahe_plain(img, tables, ytiles, xtiles, th, tw,
                                     pad_top, pad_left, radius_g, sigma,
                                     radius, eps)
        return q_to_u8(q) if out_u8 else q
    check_clahe_args(img, tables, ytiles, xtiles, th, tw, pad_top, pad_left)
    h, w = img.shape
    tp = _tail_taps(h, w, radius_g, sigma, radius)
    scratch = _tail_scratch(h, w, radius_g, radius, img.device)
    out = torch.empty((h, w), dtype=torch.uint8 if out_u8 else torch.float32,
                      device=img.device)
    launch("tpuimg_enhance_tail_clahe", img.device, img.data_ptr(), h, w,
           tables.data_ptr(), ytiles, xtiles, th, pad_top, pad_left,
           inv_tile_width(tw), INV_255, tp, radius_g, radius, eps,
           scratch.data_ptr(), int(out_u8), out.data_ptr())
    return out
