"""enhance's plan (kernels/enhance_plan.py, csrc/enhance_plan.cu) on the
CPU: what a plan computes against what the wrappers it replaces compute,
its cache and counters, its errors, the calls that take no plan, and the
C entries' ctypes declarations against the sources. Meta tensors stand in
for CUDA ones and a fake library for the kernels; the card tests
(tests/test_torch_cuda.py) run the plan's launches."""

import collections
import contextlib
import ctypes
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from tpuimg_torch import kernels, pipeline
from tpuimg_torch.core.validate import ParamError, ShapeError
from tpuimg_torch.kernels import Taps, boxsum, enhance_plan, hist, lut
from tpuimg_torch.kernels.boxsum import INV_255
from tpuimg_torch.pipeline import enhance

SMS = 132


class _FakeLib:
    """The plan's C entries and the tail's scratch query, recorded."""

    def __init__(self):
        self.plans = []

    def tpuimg_enhance_tail_scratch_floats(self, h, w, rg, r):
        # a different number for every argument
        return 2 * h * ((w + 3) & ~3) + 1000 * rg + r

    def tpuimg_enhance_plan_bytes(self):
        return 404

    def tpuimg_enhance_plan(self, *args):
        self.plans.append(args)
        return 0

    def tpuimg_cuda_error_string(self, err):
        return b"invalid argument"


@pytest.fixture
def fake(monkeypatch):
    """A fake library and card for the plan and for the wrappers, whose
    launches are recorded as (entry, args) and whose CUDA checks pass a
    meta tensor; a fresh plan cache and counter."""
    lib = _FakeLib()
    launched = []

    def record(name, device, *args):
        launched.append((name, args))

    for mod in (boxsum, enhance_plan):
        monkeypatch.setattr(mod, "load", lambda: lib)
    for mod in (hist, lut, boxsum, enhance_plan):
        monkeypatch.setattr(mod, "launch", record)
    for mod in (hist, enhance_plan):
        monkeypatch.setattr(mod, "sm_count", lambda device: SMS)
    monkeypatch.setattr(hist, "require_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(boxsum, "require_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(lut, "check_clahe_args", lambda *a: None)
    monkeypatch.setattr(boxsum, "check_clahe_args", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(pipeline, "_PLANS", collections.OrderedDict())
    monkeypatch.setattr(pipeline, "plans", collections.Counter())
    return lib, launched


def _meta(h, w):
    return torch.empty((h, w), dtype=torch.uint8, device="meta")


def _plan(img, clip=2.0, tiles=8, radius=2, sigma=1.5, gf_radius=8,
          eps=1e-3, impl="fused"):
    return pipeline._plan(img, clip, tiles, radius, sigma, gf_radius, eps,
                          impl)


def _composed_launches(launched, img, clip, tiles, radius, sigma, gf_radius,
                       eps, impl):
    """The (entry, args) of each launch the wrappers make for the call (a
    meta tensor takes the composed path)."""
    launched.clear()
    enhance(img, clip, tiles, radius, sigma, gf_radius, eps, impl)
    got = {name: args for name, args in launched}
    launched.clear()
    return got


# (h, w, tiles, clip, radius, sigma, gf_radius): 4K, 8K, odd sizes, tile
# grids 4-16, clip limits that clip everything and nothing, walk 1's
# scratch route (gf r 54), gaussian radii 1-16
GEOMETRIES = [
    (2160, 3840, 8, 2.0, 2, 1.5, 8), (4320, 7680, 8, 2.0, 2, 1.5, 8),
    (2161, 3839, 8, 2.0, 2, 1.5, 8), (1080, 1920, 4, 0.01, 2, 1.5, 8),
    (1080, 1920, 16, 40.0, 2, 1.5, 8), (540, 960, 8, 2.0, 2, 1.5, 54),
    (300, 517, 5, 3.25, 3, 2.0, 4), (37, 70, 2, 1.0, 2, 1.5, 8),
    (600, 400, 16, 1e9, 16, 5.0, 1), (257, 511, 3, 0.5, 1, 0.8, 60),
]


@pytest.mark.parametrize("impl", ["fused", "fused1"])
@pytest.mark.parametrize("h,w,tiles,clip,radius,sigma,gf_radius",
                         GEOMETRIES)
def test_plan_passes_what_the_wrappers_pass(fake, h, w, tiles, clip, radius,
                                            sigma, gf_radius, impl):
    """The C plan gets, argument for argument, what the wrappers' C entries
    get for the same call: the tile grid, pads, limit, fr, clusters and
    rows (tpuimg_tile_tables), inv_tw and the scale (tpuimg_clahe_map, or
    the fused tail), the taps, radii and eps (the tail); its workspace
    holds the tables, the blend (fused) and the tail's scratch, each at a
    512-byte boundary."""
    lib, launched = fake
    img = _meta(h, w)
    eps = 1e-3
    wrap = _composed_launches(launched, img, clip, tiles, radius, sigma,
                              gf_radius, eps, impl)
    plan = _plan(img, clip, tiles, radius, sigma, gf_radius, eps, impl)
    (args,) = lib.plans
    (fused1, ph, pw, yt, xt, th, tw, pt, pl, cluster, rows, limit, fr,
     inv_tw, scale, taps, rg, r, peps, tables_at, blend_at, scratch_at,
     ptr) = args
    tiles_args = wrap["tpuimg_tile_tables"]
    assert (ph, pw, yt, xt, th, tw, pt, pl, cluster, rows, limit, fr) == (
        tiles_args[1:13])
    if impl == "fused":
        m = wrap["tpuimg_clahe_map"]  # img, h, w, y0, tables, yt, xt, th,
        assert (m[5:10], m[10], m[11:13]) == (  # pt, pl, inv_tw, f32, scale
            (yt, xt, th, pt, pl), inv_tw, (1, scale))
        t = wrap["tpuimg_enhance_tail"]  # f, h, w, taps, rg, r, eps, ...
        tail_taps, tail_rest = t[3], t[4:7]
        assert t[-2] == 1  # u8 q
    else:
        t = wrap["tpuimg_enhance_tail_clahe"]
        assert t[4:11] == (yt, xt, th, pt, pl, inv_tw, scale)
        tail_taps, tail_rest = t[11], t[12:15]
        assert t[-2] == 1
    assert fused1 == (impl == "fused1") and scale == INV_255
    assert list(taps.w) == list(tail_taps.w)
    assert (rg, r, peps) == tail_rest == (radius, gf_radius, eps)
    # the workspace
    floats = lib.tpuimg_enhance_tail_scratch_floats(h, w, radius, gf_radius)
    assert tables_at == 0 and blend_at >= tiles * tiles * 256 * 4
    blend = 0 if fused1 else h * w * 4
    assert scratch_at >= blend_at + blend
    assert blend_at % 512 == scratch_at % 512 == 0
    assert scratch_at - blend_at - blend < 512 and blend_at < (
        tiles * tiles * 1024 + 512)
    assert plan.workspace_bytes == scratch_at + 4 * floats
    assert ptr == plan.ptr and isinstance(taps, Taps)


def test_plan_run_is_one_launch_of_the_run_entry(fake):
    lib, launched = fake
    img = _meta(2160, 3840)
    plan = _plan(img)
    out = plan.run(img)
    assert out.shape == (2160, 3840) and out.dtype == torch.uint8
    assert [(name, args[0]) for name, args in launched] == [
        ("tpuimg_enhance_run", plan.ptr)]
    assert len(launched[0][1]) == 4  # plan, img, workspace, out


def test_a_key_builds_one_plan_and_later_calls_reuse_it(fake):
    """The first call of a key builds (inside enhance.plan), the next
    reuse; another parameter, shape or impl is another key; 8 and 8.0
    compare equal as keys but are told apart by type."""
    from tpuimg_torch import profiling

    lib, _ = fake
    img = _meta(540, 960)
    with profiling.recording() as rec:
        first = _plan(img)
    assert [s.name for s in rec.spans] == ["enhance.plan"]
    assert _plan(img) is first and _plan(img) is first
    assert pipeline.plans == {"built": 1, "reused": 2}
    assert len(lib.plans) == 1
    with profiling.recording() as rec:
        _plan(img)
    assert rec.spans == []
    others = [_plan(img, clip=2.5), _plan(_meta(541, 960)),
              _plan(img, impl="fused1"), _plan(img, radius=3)]
    assert len({id(p) for p in others + [first]}) == 5
    assert pipeline.plans["built"] == 5
    with pytest.raises(ParamError, match="tiles"):
        _plan(img, tiles=8.0)
    assert pipeline.plans["built"] == 5


def test_plan_cache_evicts_the_least_recently_used(fake, monkeypatch):
    monkeypatch.setattr(pipeline, "PLAN_CACHE_SIZE", 3)
    img = _meta(540, 960)
    a, b, c = (_plan(img, clip=x) for x in (1.0, 2.0, 3.0))
    assert _plan(img, clip=1.0) is a  # a is now the most recent
    _plan(img, clip=4.0)  # evicts b
    assert len(pipeline._PLANS) == 3
    assert _plan(img, clip=1.0) is a and _plan(img, clip=3.0) is c
    assert _plan(img, clip=2.0) is not b  # built again
    assert pipeline.plans["built"] == 5


def test_plan_cache_is_shared_by_threads(fake, monkeypatch):
    """Callers on more threads than cores, the interpreter switching
    often, over more keys than the cache holds: no call fails, every call
    counts once as built or reused, and the cache keeps its size."""
    monkeypatch.setattr(pipeline, "PLAN_CACHE_SIZE", 3)
    # a plan that costs nothing to build, so that builds, evictions and
    # reuses interleave densely
    monkeypatch.setattr(pipeline, "EnhancePlan", lambda *a: object())
    imgs = [_meta(540 + i, 960) for i in range(4)]
    calls, errors = 400, []

    def work(k):
        order = np.random.default_rng(k).integers(0, len(imgs), calls)
        try:
            for i in order:
                assert _plan(imgs[i]) is not None
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range((os.cpu_count() or 1) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert sum(pipeline.plans.values()) == len(threads) * calls
    assert len(pipeline._PLANS) == 3


# (parameters, the error): each in the order the composed path checks them
BAD = [
    (dict(tiles=0), ParamError), (dict(tiles=8.0), ParamError),
    (dict(tiles=True), ParamError), (dict(clip=0.0), ParamError),
    (dict(clip=float("nan")), ParamError), (dict(clip=[2.0]), ParamError),
    (dict(tiles=6500), ParamError), (dict(radius=0), ParamError),
    (dict(gf_radius=-1), ParamError), (dict(eps=0.0), ParamError),
    (dict(gf_radius=65), ParamError), (dict(radius=17), ParamError),
    (dict(radius=17, gf_radius=65), ParamError),
]


@pytest.mark.parametrize("impl", ["fused", "fused1"])
@pytest.mark.parametrize("bad,error", BAD)
def test_plan_errors_are_the_composed_paths_before_any_launch(
        fake, bad, error, impl):
    """A parameter that fails a check raises the type and message the
    composed path raises (which launches the tile kernel, and for fused the
    mapping, before the tail's checks), with no launch and no plan kept."""
    lib, launched = fake
    params = dict(clip=2.0, tiles=8, radius=2, sigma=1.5, gf_radius=8,
                  eps=1e-3)
    params.update(bad)
    args = [params[k] for k in ("clip", "tiles", "radius", "sigma",
                                "gf_radius", "eps")]
    img = _meta(2160, 3840)
    with pytest.raises(error) as composed:
        enhance(img, *args, impl)
    launched.clear()
    with pytest.raises(error) as planned:
        pipeline._plan(img, *args, impl)
    assert str(planned.value) == str(composed.value)
    assert launched == [] and lib.plans == []
    assert len(pipeline._PLANS) == 0 and pipeline.plans["built"] == 0


def test_empty_frames_raise_the_composed_paths_shape_error(fake):
    for shape in ((0, 64), (64, 0)):
        with pytest.raises(ShapeError) as composed:
            enhance(_meta(*shape))
        with pytest.raises(ShapeError) as planned:
            _plan(_meta(*shape))
        assert str(planned.value) == str(composed.value)


def test_cpu_staged_and_under_gate_calls_take_no_plan(fake, monkeypatch,
                                                      rng):
    """CPU tensors and staged calls never ask for a plan; a CUDA frame at
    or under the tail's gate (min(H, W) <= 2*(2*gf_radius + radius)) gets
    none, and nothing is built or kept."""
    lib, launched = fake
    asked = []
    real_plan = pipeline._plan
    monkeypatch.setattr(pipeline, "_plan",
                        lambda *a: asked.append(a) or real_plan(*a))
    img = torch.from_numpy(rng.integers(0, 256, (72, 96), dtype=np.uint8))
    for impl in ("fused", "fused1", "staged"):
        enhance(img, impl=impl)
    assert asked == []
    with pytest.raises(ValueError, match="CUDA tensor"):
        enhance(_meta(2160, 3840), impl="staged")  # the wrappers' check
    assert asked == []
    for shape, gf_radius in (((36, 60), 8), ((30, 40), 8), ((2160, 20), 4)):
        assert real_plan(_meta(*shape), 2.0, 8, 2, 1.5, gf_radius, 1e-3,
                         "fused") is None
    assert real_plan(_meta(37, 60), 2.0, 2, 2, 1.5, 8, 1e-3,
                     "fused") is not None
    assert lib.plans and len(lib.plans) == 1 == pipeline.plans["built"]


def test_plan_raises_the_c_plans_error(fake):
    lib, _ = fake
    lib.tpuimg_enhance_plan = lambda *args: 1
    with pytest.raises(kernels.KernelLaunchError,
                       match=r"tpuimg_enhance_plan: CUDA error 1 \(invalid"):
        _plan(_meta(540, 960))
    assert len(pipeline._PLANS) == 0


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong, "Taps": kernels.Taps,
            "GaussTaps": kernels.GaussTaps, "cudaStream_t": ctypes.c_void_p}


def _c_entries():
    """Each extern "C" function of csrc/*.cu: (name, result, [param
    types])."""
    out = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" ([\w ]+?\*?)\s*(tpuimg_\w+)\(([^)]*)\)'
                             r'\s*\{', text):
            params = []
            for p in filter(None, (s.strip() for s in m[3].split(","))):
                p = re.sub(r"\s+", " ", p)
                if "*" in p:
                    params.append(ctypes.c_void_p)
                else:
                    params.append(_C_TYPES[p.rsplit(" ", 1)[0].replace(
                        "const ", "")])
            out[m[2]] = (m[1].strip(), params)
    return out


def test_ctypes_declarations_match_the_c_sources():
    """Every entry kernels.bind declares has the parameters its C source
    takes, in order, and the plan's entries are among them."""
    entries = _c_entries()
    assert {"tpuimg_enhance_plan", "tpuimg_enhance_run",
            "tpuimg_enhance_plan_bytes"} <= set(entries)
    declared = {name: list(args)
                for name, args in kernels._SIGNATURES.items()}
    declared.update({name: list(args)
                     for name, (args, _) in kernels._QUERIES.items()})
    for name, types in declared.items():
        assert name in entries, name
        assert entries[name][1] == types, name
