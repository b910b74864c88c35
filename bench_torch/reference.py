"""Plain PyTorch references of the entry points the benchmark times.

Written from the published definitions, with no code of the program:
CLAHE as the reference CUDA code computes it (tile histograms over a
centred reflect-101 extension, clip with redistribution, cumulative tables,
bilinear blend of the four nearest tiles' tables), OpenCV's gaussian kernel
with a reflect-101 border, and He et al.'s guided filter with reflect-101
box means normalised by (2r + 1)^2. Every floating-point value is computed
in ``dtype``: float64 for the reference that decides ``correct``, bfloat16
for the control (the nearest precision below the float32 the program
states). Integer work (histograms, clipping, table indices) is exact in
either.
"""

from __future__ import annotations

import math

import torch


def reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Index map of the mirror without repeat of the edge, for any index."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m >= n, period - m, m)


def pad2d(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """``x`` (H, W) extended by ``ph`` rows and ``pw`` columns on each side,
    reflect-101."""
    h, w = x.shape
    ys = reflect101(torch.arange(-ph, h + ph, device=x.device), h)
    xs = reflect101(torch.arange(-pw, w + pw, device=x.device), w)
    return x.index_select(0, ys).index_select(1, xs)


def window_sum(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sums of every ``k`` consecutive values along ``dim`` (valid windows),
    added one shifted slice at a time."""
    n = x.shape[dim] - k + 1
    acc = x.narrow(dim, 0, n).clone()
    for j in range(1, k):
        acc.add_(x.narrow(dim, j, n))
    return acc


def clahe_blend(img: torch.Tensor, clip_limit: float, tiles: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The CLAHE blend of a u8 (H, W) frame in [0, 255], before any
    rounding, on a ``tiles`` x ``tiles`` grid."""
    h, w = img.shape
    dev = img.device
    th, tw = -(-h // tiles), -(-w // tiles)
    pad_top, pad_left = (th * tiles - h) // 2, (tw * tiles - w) // 2
    ys = reflect101(torch.arange(th * tiles, device=dev) - pad_top, h)
    xs = reflect101(torch.arange(tw * tiles, device=dev) - pad_left, w)
    ext = img.index_select(0, ys).index_select(1, xs).long()
    tile = ((torch.arange(th * tiles, device=dev) // th)[:, None] * tiles
            + (torch.arange(tw * tiles, device=dev) // tw)[None, :])
    hists = torch.bincount((tile * 256 + ext).flatten(),
                           minlength=tiles * tiles * 256).view(-1, 256)
    # clip each bin at the limit; the excess goes back evenly, its
    # remainder r one count each to bins (i << 8) // r, i < r
    limit = int(tw * th * clip_limit / 256 + 0.5)
    steal = (hists - limit).clamp(min=0).sum(1, keepdim=True)
    hists = hists.clamp(max=limit) + (steal >> 8)
    rest = steal - ((steal >> 8) << 8)
    i = torch.arange(256, device=dev)[None, :]
    hists.scatter_add_(1, ((i << 8) // rest.clamp(min=1)).clamp(max=255),
                       (i < rest).long())
    tables = hists.cumsum(1).to(dtype) * (255.0 / (tw * th))

    def coords(n, pad, size):
        pos = (torch.arange(n, device=dev, dtype=torch.float64) + pad) / size
        pos = pos - 0.5
        t1 = torch.trunc(pos)  # toward zero: the first row of tiles extrapolates
        frac = (pos - t1).to(dtype)
        t1 = t1.long()
        return t1, (t1 + 1).clamp(max=tiles - 1), frac

    ty1, ty2, ya = coords(h, pad_top, th)
    tx1, tx2, xa = coords(w, pad_left, tw)
    v = img.long()
    flat = tables.flatten()

    def lut(ty, tx):
        return flat[(ty[:, None] * tiles + tx[None, :]) * 256 + v]

    ya, xa = ya[:, None], xa[None, :]
    top = lut(ty1, tx1) * (1 - xa) + lut(ty1, tx2) * xa
    bottom = lut(ty2, tx1) * (1 - xa) + lut(ty2, tx2) * xa
    return top * (1 - ya) + bottom * ya


def gaussian_taps(radius: int, sigma: float, dtype: torch.dtype,
                  device) -> torch.Tensor:
    """cv::getGaussianKernel(2 * radius + 1, sigma) for sigma > 0."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float64)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).to(dtype=dtype, device=device)


def gaussian(x: torch.Tensor, radius: int, sigma: float) -> torch.Tensor:
    """Separable gaussian of (H, W) ``x``, reflect-101 border."""
    k = gaussian_taps(radius, sigma, x.dtype, x.device)
    h, w = x.shape
    xp = pad2d(x, radius, radius)
    rows = sum(k[j] * xp[:, j:j + w] for j in range(2 * radius + 1))
    return sum(k[j] * rows[j:j + h, :] for j in range(2 * radius + 1))


def box_mean(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean over (2r + 1)^2 windows, reflect-101 border."""
    k = 2 * radius + 1
    s = window_sum(window_sum(pad2d(x, radius, radius), k, 1), k, 0)
    return s * (1.0 / (k * k))


def guided_filter(I: torch.Tensor, p: torch.Tensor, radius: int,
                  eps: float) -> torch.Tensor:
    """He et al.'s guided filter of p by I, box means by ``box_mean``."""
    mean_I, mean_p = box_mean(I, radius), box_mean(p, radius)
    cov = box_mean(I * p, radius) - mean_I * mean_p
    var = box_mean(I * I, radius) - mean_I * mean_I
    a = cov / (var + eps)
    b = mean_p - a * mean_I
    return box_mean(a, radius) * I + box_mean(b, radius)


def to_u8(q: torch.Tensor) -> torch.Tensor:
    """clip(round(q * 255)) as u8, halves to even."""
    return torch.round(q * 255).clamp(0, 255).to(torch.uint8)


def enhance(img: torch.Tensor, clip_limit: float, tiles: int, radius: int,
            sigma: float, gf_radius: int, gf_eps: float,
            dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """CLAHE, then the guided filter of the gaussian of the blend, guided by
    the blend, as u8: tpuimg's enhance pipeline without rounding between
    its stages."""
    f = clahe_blend(img, clip_limit, tiles, dtype) / 255.0
    return to_u8(guided_filter(f, gaussian(f, radius, sigma), gf_radius,
                               gf_eps))


def u8_gaps(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far a u8 frame lies from the reference's: the widest gap in
    steps, the share of pixels that differ at all, and the share that
    differ by more than one step (a rounding flip gives one)."""
    if out.shape != ref.shape or out.dtype != torch.uint8:
        return {"max_step": math.inf, "off_share": 1.0, "wide_share": 1.0}
    gap = (out.int() - ref.int().to(out.device)).abs()
    return {"max_step": float(gap.max()),
            "off_share": float((gap > 0).sum()) / gap.numel(),
            "wide_share": float((gap > 1).sum()) / gap.numel()}


def float_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest absolute gap of a float frame from the reference's; a NaN
    or an infinity on either side reads as infinite."""
    if out.shape != ref.shape or not out.is_floating_point():
        return math.inf
    gap = (out.double() - ref.double().to(out.device)).abs()
    return float(torch.nan_to_num(gap, nan=math.inf).max())
