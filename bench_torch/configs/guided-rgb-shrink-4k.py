"""guided-rgb-shrink-4k: ``tpuimg_torch.guided_filter`` at its default
(shrink) border, of three-channel f32 4K frames by their gray guide, and its
plain reference beside it.

The reference is He et al.'s guided filter with the reference's class-path
box means (gIntegralToMean): each window clamped to the frame, its sum taken
as a difference of cumulative sums over the frame, divided by the window's
true area. Every floating-point value is computed in ``dtype`` (float64 for
the reference that decides ``correct``, bfloat16 for the control); it uses
nothing of the program.
"""

import functools

import torch

from bench_torch import frames
from bench_torch.reference import float_gap

LUMA = (0.299, 0.587, 0.114)  # BT.601: the gray guide of an RGB frame


def make_args(cfg, seed, device):
    """The ring: per slot, a scene s / 255; p, three channels of s each with
    its own noise of sigma 0.1, clipped to [0, 1]; I, the luma of p."""
    n, h, w, c = cfg["ring"], cfg["height"], cfg["width"], cfg["channels"]
    g = frames.generator(seed, device)
    s = frames.scenes(n, h, w, g).float().div_(255.0)
    p = torch.randn((n, c, h, w), generator=g, device=device)
    p = p.mul_(0.1).add_(s[:, None]).clamp_(0.0, 1.0)
    I = LUMA[0] * p[:, 0] + LUMA[1] * p[:, 1] + LUMA[2] * p[:, 2]
    return [(I[i], p[i]) for i in range(n)]


def entry(cfg):
    """The program's entry with the radius and eps; the border is its
    default."""
    import tpuimg_torch

    return functools.partial(tpuimg_torch.guided_filter, **cfg["params"])


def window_sums(x: torch.Tensor, radius: int, dim: int):
    """Sums of ``x`` over the windows [i - r, i + r] clamped to the frame
    along ``dim``, by differences of its cumulative sums, and the windows'
    lengths."""
    n = x.shape[dim]
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    c = torch.cat([zero, torch.cumsum(x, dim)], dim)
    i = torch.arange(n, device=x.device)
    hi, lo = (i + radius + 1).clamp(max=n), (i - radius).clamp(min=0)
    return c.index_select(dim, hi) - c.index_select(dim, lo), hi - lo


def box_mean(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean over each pixel's (2r + 1)^2 window clamped to the frame."""
    rows, cx = window_sums(x, radius, -1)
    s, cy = window_sums(rows, radius, -2)
    return s / (cy[:, None] * cx[None, :]).to(x.dtype)


def reference(cfg, I, p, dtype):
    """q for the (C, H, W) source p by the (H, W) guide I."""
    r, eps = cfg["params"]["radius"], cfg["params"]["eps"]
    I, p = I.to(dtype), p.to(dtype)
    mean_I, mean_p = box_mean(I, r), box_mean(p, r)
    cov = box_mean(I * p, r) - mean_I * mean_p
    var = box_mean(I * I, r) - mean_I * mean_I
    a = cov / (var + eps)
    b = mean_p - a * mean_I
    return box_mean(a, r) * I + box_mean(b, r)


def compare(out, expected):
    return {"max_abs": float_gap(out, expected)}
