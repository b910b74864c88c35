"""morph-open-4k-b2: ``tpuimg_torch.morph_open`` on stacks of two u8 4K
frames, opened by a 31x31 square, and its plain reference beside it."""

import functools

import torch
import torch.nn.functional as F

from bench_torch import frames
from bench_torch.reference import u8_gaps

# frames made at once while the ring is built: frames.scenes takes a few
# float32 planes a frame
CHUNK = 4


def make_args(cfg, seed, device):
    """The ring: ``ring`` distinct (batch, H, W) u8 stacks of scenes."""
    n, b = cfg["ring"], cfg["batch"]
    h, w = cfg["height"], cfg["width"]
    g = frames.generator(seed, device)
    ring = torch.empty((n * b, h, w), dtype=torch.uint8, device=device)
    for i in range(0, n * b, CHUNK):
        k = min(CHUNK, n * b - i)
        ring[i:i + k] = frames.scenes(k, h, w, g)
    return [(ring[i * b:(i + 1) * b],) for i in range(n)]


def entry(cfg):
    import tpuimg_torch

    return functools.partial(tpuimg_torch.morph_open,
                             radius=cfg["params"]["radius"])


def _extreme(x: torch.Tensor, r: int, sign: float) -> torch.Tensor:
    """The maximum (sign 1) or minimum (sign -1) of (B, H, W) ``x`` over
    every (2r + 1)^2 square, replicate border."""
    k = 2 * r + 1
    p = F.pad(sign * x[:, None], (r, r, r, r), mode="replicate")
    p = F.max_pool2d(F.max_pool2d(p, (1, k), stride=1), (k, 1), stride=1)
    return sign * p[:, 0]


def reference(cfg, imgs, dtype):
    """The opened (B, H, W) stack: the minimum over the square, then the
    maximum over it, each with its own replicate border.

    A square's extremes are separable: the minimum over the square is the
    minimum down each column of the minima along the rows, and a replicate
    border, which clamps row and column indices each on its own, keeps it
    so. Both run as pooling windows over ``dtype`` values. Values 0-255 are
    exact in ``dtype`` (bfloat16's 8 bits of significand hold every integer
    up to 256), and a minimum or a maximum picks one of them without
    rounding, so ``dtype`` changes nothing here."""
    r = cfg["params"]["radius"]
    opened = _extreme(_extreme(imgs.to(dtype), r, -1.0), r, 1.0)
    return torch.round(opened).to(torch.uint8)


def compare(out, expected):
    gaps = u8_gaps(out, expected)
    return {"max_step": gaps["max_step"], "off_share": gaps["off_share"]}
