"""Op configuration dataclasses (port of ``tpuimg.core.params``) and the
carry-across of ``tpuimg``'s CLAHE front-end state.

For an image library, the state worth carrying from one package to the other
is what CLAHE's front end computes before the mapping: the per-tile float
tables and the tile geometry. ``carry_enhance_state`` takes them as NumPy
(``tpuimg.ops.histogram._clahe_front``'s return value) with the ``enhance``
keyword arguments, validates them, and returns the port's configs and the
table tensor, so one set of tables can drive both packages' mapping and tail
stages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.layout import cdiv
from tpuimg_torch.core.validate import (
    ParamError, ShapeError, check_positive, check_radius)


@dataclass(frozen=True)
class GaussianConfig:
    radius: int = 1
    sigma: float = 1.0  # <=0 selects OpenCV's derived sigma / small-kernel table

    def __post_init__(self):
        check_radius(self.radius)


@dataclass(frozen=True)
class ClaheConfig:
    clip_limit: float = 1.0
    xtiles: int = 8
    ytiles: int = 8

    def __post_init__(self):
        check_positive(self.clip_limit, "clip_limit")
        check_radius(self.xtiles, name="xtiles")
        check_radius(self.ytiles, name="ytiles")


@dataclass(frozen=True)
class GuidedConfig:
    radius: int = 4
    eps: float = 0.3
    border: str = "shrink"  # class path; "reflect101" = fused path

    def __post_init__(self):
        check_radius(self.radius)
        check_positive(self.eps, "eps")


@dataclass(frozen=True)
class MorphConfig:
    radius: int = 5
    mode: int = 0  # 0 = erode/min, 1 = dilate/max (fn table image_process.cu:11-26)

    def __post_init__(self):
        check_radius(self.radius)
        if self.mode not in (0, 1):
            raise ParamError(
                f"mode must be 0 (erode) or 1 (dilate), got {self.mode}")


class EnhanceState(NamedTuple):
    """Everything ``enhance`` needs after CLAHE's histogram front end."""

    clahe: ClaheConfig
    gaussian: GaussianConfig
    guided: GuidedConfig
    tables: torch.Tensor  # (ytiles * xtiles, 256) float32
    th: int
    tw: int
    pad_top: int
    pad_left: int


def carry_enhance_state(tables, th, tw, pad_top, pad_left, *, h: int, w: int,
                        clip_limit: float = 2.0, tiles: int = 8,
                        radius: int = 2, sigma: float = 1.5,
                        gf_radius: int = 8, gf_eps: float = 1e-3,
                        device=None) -> EnhanceState:
    """Carry ``tpuimg``'s CLAHE front-end state for an (h, w) frame across.

    ``tables, th, tw, pad_top, pad_left`` are what
    ``tpuimg.ops.histogram._clahe_front`` returns (the tables as a NumPy
    array); the keywords are ``enhance``'s. The geometry is checked against
    the one this package derives from (h, w, tiles), so state from another
    frame size or tile grid is refused. The tables go to ``device``; by
    default the current CUDA card (``DeviceError`` without one), so pass
    ``device="cpu"`` for the CPU path."""
    cl = ClaheConfig(clip_limit, tiles, tiles)
    ga = GaussianConfig(radius, sigma)
    gu = GuidedConfig(gf_radius, gf_eps, border="reflect101")
    tables = np.asarray(tables)
    if tables.dtype != np.float32 or tables.shape != (tiles * tiles, 256):
        raise ShapeError(
            f"tables must be float32 ({tiles * tiles}, 256), got "
            f"{tables.dtype} {tables.shape}")
    geometry = (int(th), int(tw), int(pad_top), int(pad_left))
    ctw, cth = cdiv(w, tiles), cdiv(h, tiles)
    expect = (cth, ctw, (cth * tiles - h) >> 1, (ctw * tiles - w) >> 1)
    if geometry != expect:
        raise ParamError(
            f"CLAHE geometry (th, tw, pad_top, pad_left) = {geometry} does not "
            f"match {expect} for a {h}x{w} frame with {tiles}x{tiles} tiles")
    t = (as_image(tables) if device is None
         else torch.from_numpy(tables.copy()).to(device))
    return EnhanceState(cl, ga, gu, t, *geometry)
