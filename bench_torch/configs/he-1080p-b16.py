"""he-1080p-b16: ``tpuimg_torch.hist_equalize`` on stacks of 16 u8 1080p
frames, each equalized by its own histogram, and its plain reference beside
it.

The reference is global histogram equalization as published
(HistEqualizer::run, Histogram/hist_equalization.cpp:37-77; the table of
image_process.cu:72-124): each frame's histogram counted exactly as
integers, its inclusive cdf, the table rint(min(255, cdf * 256 / N)) with
halves to even, then the lookup. The table is computed in ``dtype`` from
the exact quotient (float64 for the reference that decides ``correct``,
bfloat16 for the control); it uses nothing of the program.
"""

import torch

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

    return tpuimg_torch.hist_equalize


def table(img: torch.Tensor, dtype) -> torch.Tensor:
    """The u8 (256,) table of one u8 (H, W) frame."""
    hist = torch.bincount(img.reshape(-1).long(), minlength=256)
    cdf = torch.cumsum(hist, 0)
    scaled = cdf.to(dtype) * 256 / img.numel()
    return torch.round(scaled.clamp(max=255)).to(torch.uint8)


def reference(cfg, imgs, dtype):
    """The equalized (B, H, W) stack, frame by frame."""
    return torch.stack([table(img, dtype)[img.long()] for img in imgs])


def compare(out, expected):
    gaps = u8_gaps(out, expected)
    return {"max_step": gaps["max_step"], "off_share": gaps["off_share"]}
