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

On a u8 (H, W) CUDA frame above the gate, "fused" and "fused1" run from a
plan (kernels/enhance_plan.py), made on the first call of its card, frame
shape and parameters and kept in a small cache: the checks, the geometry
and the kernels' grids are worked out once, and each call is two
allocations and one C call that queues the chain's kernels (the same
kernels, in the same order, as the wrappers compose below). ``plans``
counts the plans built and the calls that reused one. Every other call, a
CPU tensor's included, composes the wrappers.
"""

from __future__ import annotations

import collections
import threading

import torch

from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.validate import (
    check_impl, check_positive, check_radius)
from tpuimg_torch.kernels.boxsum import (
    INV_255, enhance_tail, enhance_tail_clahe, q_to_u8)
from tpuimg_torch.kernels.enhance_plan import EnhancePlan
from tpuimg_torch.kernels.lut import clahe_map
from tpuimg_torch.ops.gaussian import gaussian
from tpuimg_torch.ops.guided import guided_filter
from tpuimg_torch.ops.histogram import _clahe_checks, _clahe_front, clahe
from tpuimg_torch.profiling import span

# plans kept; past this many the least recently used is dropped
PLAN_CACHE_SIZE = 64
_PLANS: collections.OrderedDict = collections.OrderedDict()
# "built": plans made; "reused": calls that ran a plan made before
plans: collections.Counter[str] = collections.Counter()
# held while _PLANS and plans change: callers on several threads share them
_PLANS_LOCK = threading.Lock()


def _to_u8(q):
    """clip(rint(q * 255)) as PyTorch glue, where no kernel's store rounds
    q: the staged path, frames under the tail's gate, the CLI's gaussian and
    the sharded path."""
    with span("enhance.to_u8", "glue"):
        return q_to_u8(q)


def _tail_fits(h: int, w: int, radius: int, gf_radius: int) -> bool:
    """The tail kernels' gate, the JAX package's."""
    return min(h, w) > 2 * (2 * gf_radius + radius)


def _plan(img, clip_limit, tiles, radius, sigma, gf_radius, gf_eps, impl):
    """The plan of a fused call on a u8 (H, W) CUDA frame, or None for a
    frame under the tail's gate. A parameter that fails a check raises what
    the composed path raises, before any launch."""
    params = (clip_limit, tiles, radius, sigma, gf_radius, gf_eps)
    # the types too: 8 and 8.0, or 1 and True, are equal keys that the
    # checks tell apart
    key = (img.get_device(), img.shape, impl, params,
           tuple(map(type, params)))
    with _PLANS_LOCK:
        try:
            plan = _PLANS.get(key)
        except TypeError:  # an unhashable parameter: the checks refuse it
            plan = key = None
        if plan is not None:
            _PLANS.move_to_end(key)
            plans["reused"] += 1
    if plan is not None:
        return plan
    h, w = img.shape
    geometry = _clahe_checks(img, clip_limit, tiles, tiles)
    check_radius(radius)
    check_radius(gf_radius)
    check_positive(gf_eps, "eps")
    if not _tail_fits(h, w, radius, gf_radius):
        return None
    with span("enhance.plan", "entry"):
        plan = EnhancePlan(img.device, h, w, geometry, clip_limit, tiles,
                           radius, sigma, gf_radius, gf_eps,
                           impl == "fused1")
    with _PLANS_LOCK:
        plans["built"] += 1
        if key is not None:
            _PLANS[key] = plan
            if len(_PLANS) > PLAN_CACHE_SIZE:
                _PLANS.popitem(last=False)
    return plan


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
        if (impl != "staged" and img.is_cuda and img.dtype == torch.uint8
                and img.ndim == 2):
            plan = _plan(img, clip_limit, tiles, radius, sigma, gf_radius,
                         gf_eps, impl)
            if plan is not None:
                return plan.run(img.contiguous())
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
        tail_fits = _tail_fits(*img.shape, radius, gf_radius)
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
