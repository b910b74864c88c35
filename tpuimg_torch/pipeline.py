"""The enhance pipeline: u8 frame -> CLAHE -> Gaussian -> guided -> u8
(port of ``tpuimg.pipeline``).

impl="fused" (default): the CLAHE mapping emits its f32 blend times 1/255,
which feeds the gaussian + guided tail directly. On a CUDA tensor that is
three kernels and nothing between them: the tile histograms, which end in
CLAHE's clipped tables, the CLAHE mapping, which scales the blend in its
store, and the tail, which rounds q to the u8 frame in its store
(kernels/hist.py, lut.py, boxsum.py). The tail kernel needs min(H, W) >
2*(2*gf_radius + radius), the JAX package's gate; smaller frames compose
``gaussian`` and ``guided_filter``, whose kernels (csrc/gaussian.cu,
csrc/guided.cu) take any frame size and return f32, rounded by ``_to_u8``.

impl="fused1" folds the CLAHE mapping into the tail: above the same gate, a
CUDA tensor runs the tile kernel (histograms and tables), then one kernel
(csrc/enhance_tail_clahe.cu) that recomputes the blend on each tile's halo,
so the f32 blend never reaches device memory; two kernel launches, no
``clahe_map``, and q stored as u8 as the fused tail stores it. It computes
"fused"'s values. tpuimg also requires tiles of at least 32 rows and a
table bank of at most 4 MB, limits of the TPU's VMEM; the per-pixel table
reads here take any tile grid. Under the gate it composes as "fused"
does.

impl="staged" composes the public ops with a u8 round trip between CLAHE and
the tail: on a CUDA tensor the two CLAHE kernels, then the gaussian and
guided-filter kernels.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.validate import (
    check_impl, check_positive, check_radius)
from tpuimg_torch.kernels.boxsum import (
    INV_255, enhance_tail, enhance_tail_clahe, q_to_u8)
from tpuimg_torch.kernels.lut import clahe_map
from tpuimg_torch.ops.gaussian import gaussian
from tpuimg_torch.ops.guided import guided_filter
from tpuimg_torch.ops.histogram import _clahe_front, clahe
from tpuimg_torch.profiling import span


def _to_u8(q):
    """clip(rint(q * 255)) as PyTorch glue, where no kernel's store rounds
    q: the staged path, frames under the tail's gate, the CLI's gaussian and
    the sharded path."""
    with span("enhance.to_u8", "glue"):
        return q_to_u8(q)


def enhance(
    img,
    clip_limit: float = 2.0,
    tiles: int = 8,
    radius: int = 2,
    sigma: float = 1.5,
    gf_radius: int = 8,
    gf_eps: float = 1e-3,
    impl: str = "fused",
):
    """Contrast-enhance + denoise a uint8 (H, W) frame, edges preserved.
    The device is the input tensor's."""
    with span("pipeline.enhance", "entry"):
        check_impl(impl, allowed=("fused", "staged", "fused1"))
        img = as_image(img)
        if impl == "staged":
            eq = clahe(img, clip_limit, tiles, tiles)
            with span("enhance.scale", "glue"):
                f = eq.to(torch.float32) * (1.0 / 255.0)
            with span("enhance.gaussian", "entry"):
                smooth = gaussian(f, radius, sigma)
            out = guided_filter(f, smooth, gf_radius, gf_eps,
                                border="reflect101")
            return _to_u8(out)
        img = img.contiguous()
        tables, *geo = _clahe_front(img, clip_limit, tiles, tiles)
        # the checks gaussian and guided_filter make on the composed path
        check_radius(radius)
        check_radius(gf_radius)
        check_positive(gf_eps, "eps")
        tail_fits = min(img.shape) > 2 * (2 * gf_radius + radius)
        if impl == "fused1" and tail_fits:
            with span("enhance.tail", "entry"):
                return enhance_tail_clahe(img, tables, tiles, tiles, *geo,
                                          radius, sigma, gf_radius, gf_eps,
                                          out_u8=True)
        with span("clahe.map", "entry"):
            f = clahe_map(img, tables, tiles, tiles, *geo, out_f32=True,
                          scale=INV_255)
        if tail_fits:
            with span("enhance.tail", "entry"):
                return enhance_tail(f, radius, sigma, gf_radius, gf_eps,
                                    out_u8=True)
        with span("enhance.gaussian", "entry"):
            smooth = gaussian(f, radius, sigma)
        return _to_u8(guided_filter(f, smooth, gf_radius, gf_eps,
                                    border="reflect101"))
