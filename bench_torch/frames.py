"""Rings of input frames, made on the device from the run's seed.

Each ring is made in a few large calls from one ``torch.Generator`` on the
device, so the same seed on the same device gives the same bits, and the
reference can make the ring again after the window instead of reading
frames the program could have written to.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    return g


def scenes(n: int, h: int, w: int, g: torch.Generator) -> torch.Tensor:
    """``n`` u8 (h, w) scenes with what CLAHE acts on: smooth illumination,
    a dark low-contrast disc, a checker of edges and sensor noise
    (sigma 6). Each frame has its own illumination phase, disc position and
    noise."""
    dev = g.device
    draw = torch.rand((n, 2, 1, 1), generator=g, device=dev)
    scene = torch.randn((n, h, w), generator=g, device=dev).mul_(6.0)
    y = torch.linspace(0.0, 1.0, h, device=dev)[:, None]
    x = torch.linspace(0.0, 1.0, w, device=dev)[None, :]
    light = torch.sin(7 * x + 3 * y + 2 * math.pi * draw[:, 0]) * torch.cos(
        5 * y)
    scene.add_(light.mul_(50.0)).add_(70 + 60 * x * y)
    disc = (x - (0.2 + 0.6 * draw[:, 1])) ** 2 + (y - 0.6) ** 2 < 0.04
    scene = torch.where(disc, scene * 0.25, scene)
    scene.add_(40 * torch.remainder(torch.floor(x * 12) + torch.floor(y * 7),
                                    2))
    return scene.clamp_(0, 255).to(torch.uint8)  # truncates, as a cast does


def scene_ring(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """(n, h, w) u8 frames."""
    return scenes(n, h, w, generator(seed, device))


def guide_ring(n: int, h: int, w: int, seed: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, h, w) float32 guides I in [0, 1], scenes scaled, and sources p,
    each a noisy copy of its guide (sigma 0.1, clipped to [0, 1])."""
    g = generator(seed, device)
    I = scenes(n, h, w, g).float().div_(255.0)
    p = torch.randn((n, h, w), generator=g, device=g.device)
    return I, p.mul_(0.1).add_(I).clamp_(0.0, 1.0)
