#!/usr/bin/env python3
"""Drive tpuimg_torch's enhance pipeline, filters, histogram equalization and
integral image once on one CUDA card and check them.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (nvidia-smi name and power limit); no card -> exit 1;
2. build the CUDA kernels from tpuimg_torch/csrc (one nvcc per source, all
   at once, sm_90a);
3. each kernel against its plain PyTorch version on the same card tensors,
   at 2160x3840, 2161x3839 (unaligned tiles and padding) and 1080x1920:
   tile histograms bit-exact, CLAHE f32 blend <= 1e-3 and u8 <= 1 step,
   enhance tail <= 1e-4 (the fused guided-filter contract); gaussian
   (r 1, 2, 7, plus a batch of three 1080p frames and a 3x9 frame at r 4)
   <= 1e-5; guided filter onepass (self-guided and general) and twopass
   (r 1, 8, 16, plus a 6x40 frame at r 8) <= 1e-4 and finite; bit-exact:
   hist256 at those sizes, at 4320x7680 and on a flat 4K frame,
   hist256_frames on 16 frames of 1080p and on 3 odd-sized frames,
   hist256_groups on (64, 8161) groups, lut_gather with u8, int32 and
   float32 tables (compared as int32 bits), lut_gather_frames on 16 frames
   of 1080p, integral at 4K, 2161x3839, on three 1080p frames and on an
   all-255 4320x7680 frame whose sums wrap; hist_equalize at 8K and on a
   flat frame, and every integral, also against NumPy formulas;
4. the main paths, each run once with every launch counter reset just
   before and read just after, and each of its kernels launched:
   enhance at 4K (impl="fused": tile_hist, clahe_map, enhance_tail),
   enhance at 4K with impl="staged" and enhance on a 32x48 frame (under the
   tail kernel's gate; both: tile_hist, clahe_map, gaussian, guided), and
   the stand-alone filters (gaussian r2 at 1080p, guided r8 at 4K
   self-guided, general, and twopass), hist_equalize at 4K (hist256,
   lut_gather) and on 16 frames of 1080p (the same two kernels, frames
   form, one launch each) and integral at 4K (integral). Each enhance output
   is u8 of the frame's shape, within 1 step of the plain composition on the
   card and within 1 step of the CPU run on a crop; each filter output is
   within its contract of the plain version; hist_equalize and integral
   equal the plain composition, the NumPy formula and the CPU run on a crop
   bit for bit;
5. CUDA-event timing (median of 30 after 3 warm-up runs) of every kernel and
   its plain version, of enhance on both impls, and of hist_equalize (one
   frame, and 16 frames of 1080p) and integral end to end against their
   plain compositions, at 4K and 1080p.

Then one JSON line with the kernels (launches summed over phase 4's runs),
and last the device line. Any failed check raises, so the script exits
non-zero without printing the device line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tpuimg_torch import (
    gaussian, guided_filter, hist_equalize, integral, kernels)
from tpuimg_torch.core.timing import card_label, time_cuda
from tpuimg_torch.kernels.boxsum import (
    enhance_tail, enhance_tail_plain, guided_filter_kernel,
    guided_filter_plain)
from tpuimg_torch.kernels.hist import (
    hist256, hist256_frames, hist256_groups, hist256_groups_plain, tile_hist,
    tile_hist_plain)
from tpuimg_torch.kernels.lut import (
    clahe_map, clahe_map_plain, lut_gather, lut_gather_frames,
    lut_gather_frames_plain, lut_gather_plain)
from tpuimg_torch.kernels.scan2d import integral_kernel, integral_plain
from tpuimg_torch.kernels.sep_stencil import gaussian_kernel, gaussian_plain
from tpuimg_torch.ops.histogram import (
    _clahe_geometry, _clahe_tables, _he_tables)
from tpuimg_torch.pipeline import _to_u8, enhance

SEED = 0
SHAPES = [(2160, 3840), (2161, 3839), (1080, 1920)]
TIMED = [(2160, 3840), (1080, 1920)]
# enhance's defaults (tpuimg/pipeline.py, the enhance_pipeline_4k bench row)
CLIP, TILES, RG, SIGMA, GF_R, GF_EPS = 2.0, 8, 2, 1.5, 8, 1e-3
GAUSS = [(1, 0.8), (2, 1.5), (7, 3.0)]  # radius, sigma
GUIDED_R = [1, 8, 16]
SMALL = (32, 48)  # under the tail kernel's gate: 32 <= 2*(2*8 + 2)
UHD8K = (4320, 7680)  # 33 Mpx: more than 2^24 pixels, and all-255 sums wrap
BATCH = (16, 1080, 1920)  # the hist_equalize_1080p_b16 bench row (bench.py:58)
ITERS = 30

KERNELS = [  # name, wrapper, its launch counter, source, TPU kernel replaced
    ("tile_hist", tile_hist, "launches", "tpuimg_torch/csrc/tile_hist.cu",
     "tpuimg/kernels/hist.py:213"),
    ("clahe_map", clahe_map, "launches", "tpuimg_torch/csrc/clahe_map.cu",
     "tpuimg/kernels/lut.py:341"),
    ("enhance_tail", enhance_tail, "launches",
     "tpuimg_torch/csrc/enhance_tail.cu", "tpuimg/kernels/boxsum.py:396"),
    ("gaussian", gaussian_kernel, "launches", "tpuimg_torch/csrc/gaussian.cu",
     "tpuimg/kernels/sep_stencil.py:542"),
    ("guided", guided_filter_kernel, "launches",
     "tpuimg_torch/csrc/guided.cu", "tpuimg/kernels/boxsum.py:632"),
    ("guided_twopass", guided_filter_kernel, "twopass_launches",
     "tpuimg_torch/csrc/guided.cu", "tpuimg/kernels/boxsum.py:108"),
    ("hist256", hist256_groups, "launches", "tpuimg_torch/csrc/hist256.cu",
     "tpuimg/kernels/hist.py:115 (also :126, :145)"),
    ("lut_gather", lut_gather, "launches", "tpuimg_torch/csrc/lut_gather.cu",
     "tpuimg/kernels/lut.py:77 (also :193)"),
    ("integral", integral_kernel, "launches", "tpuimg_torch/csrc/integral.cu",
     "tpuimg/kernels/scan2d.py:216"),
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def make_frame(h: int, w: int, seed: int) -> np.ndarray:
    """A u8 scene with what CLAHE acts on: smooth illumination, a dark
    low-contrast region, edges and sensor noise."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    scene = 70 + 50 * np.sin(7 * x + 3 * y) * np.cos(5 * y) + 60 * x * y
    scene = np.where((x - 0.3) ** 2 + (y - 0.6) ** 2 < 0.04, scene * 0.25,
                     scene)
    scene = scene + 40 * ((np.floor(x * 12) + np.floor(y * 7)) % 2)
    scene = scene + rng.normal(0.0, 6.0, (h, w)).astype(np.float32)
    return np.clip(scene, 0, 255).astype(np.uint8)


def guide_pair(shape, seed: int, dev):
    """A [0, 1] guide I and a noisy source p of it, on the card."""
    rng = np.random.default_rng(seed)
    I = rng.random(shape, dtype=np.float32)
    p = np.clip(I + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return torch.from_numpy(I).to(dev), torch.from_numpy(p).to(dev)


def front(img):
    """CLAHE geometry and tables of a frame (plain versions)."""
    h, w = img.shape
    th, tw, pt, pl = _clahe_geometry(h, w, TILES, TILES)
    hists = tile_hist_plain(img, TILES, TILES, th, tw, pt, pl)
    return (th, tw, pt, pl), _clahe_tables(hists, CLIP, th, tw)


def enhance_plain(img, impl: str = "fused"):
    """enhance(img, impl=impl) composed from the kernels' plain versions."""
    geo, tables = front(img)
    if impl == "staged":
        eq = clahe_map_plain(img, tables, TILES, TILES, *geo)
        f = eq.to(torch.float32) * (1.0 / 255.0)
    else:
        f = clahe_map_plain(img, tables, TILES, TILES, *geo,
                            out_f32=True) * (1.0 / 255.0)
        if min(img.shape) > 2 * (2 * GF_R + RG):
            return _to_u8(enhance_tail_plain(f, RG, SIGMA, GF_R, GF_EPS))
    smooth = gaussian_plain(f, RG, SIGMA)
    return _to_u8(guided_filter_plain(f, smooth, GF_R, GF_EPS))


def kernel_args(img):
    """The arguments each kernel gets on the enhance paths for this frame."""
    geo, tables = front(img)
    blend = clahe_map_plain(img, tables, TILES, TILES, *geo, out_f32=True)
    f = blend * (1.0 / 255.0)
    return {
        "tile_hist": (img, TILES, TILES, *geo),
        "clahe_map": (img, tables, TILES, TILES, *geo, True),
        "enhance_tail": (f, RG, SIGMA, GF_R, GF_EPS),
        "gaussian": (f, RG, SIGMA),
        "guided": (f, gaussian_plain(f, RG, SIGMA), GF_R, GF_EPS),
        "guided_twopass": (f, gaussian_plain(f, RG, SIGMA), GF_R, GF_EPS,
                           "twopass"),
    }


def check_enhance_kernels(dev, card: str, errs: dict) -> None:
    """Phase 3, the kernels of the fused enhance path."""
    for h, w in SHAPES:
        img = torch.from_numpy(make_frame(h, w, SEED)).to(dev)
        args = kernel_args(img)
        got = tile_hist(*args["tile_hist"])
        ref = tile_hist_plain(*args["tile_hist"])
        check(torch.equal(got, ref), f"tile_hist {h}x{w} bit-exact")
        check(int(got.sum()) == TILES * TILES * args["tile_hist"][3]
              * args["tile_hist"][4], f"tile_hist {h}x{w} counts every pixel")
        hist_err = max_err(got, ref)
        got = clahe_map(*args["clahe_map"])
        map_err = max_err(got, clahe_map_plain(*args["clahe_map"]))
        check(map_err <= 1e-3, f"clahe_map f32 {h}x{w}: {map_err} <= 1e-3")
        u8_args = args["clahe_map"][:-1] + (False,)
        step = int((clahe_map(*u8_args).int()
                    - clahe_map_plain(*u8_args).int()).abs().max())
        check(step <= 1, f"clahe_map u8 {h}x{w}: {step} <= 1 step")
        got = enhance_tail(*args["enhance_tail"])
        tail_err = max_err(got, enhance_tail_plain(*args["enhance_tail"]))
        check(bool(torch.isfinite(got).all()), f"enhance_tail {h}x{w} finite")
        check(tail_err <= 1e-4, f"enhance_tail {h}x{w}: {tail_err} <= 1e-4")
        torch.cuda.synchronize()
        print(f"phase 3 kernels vs plain {h}x{w}: tile_hist exact, "
              f"clahe_map f32 {map_err:.3g} u8 {step} step, "
              f"enhance_tail {tail_err:.3g} [{card}]")
        for name, err in (("tile_hist", hist_err), ("clahe_map", map_err),
                          ("enhance_tail", tail_err)):
            errs[name] = max(errs.get(name, 0.0), err)


def check_filter_kernels(dev, card: str, errs: dict) -> None:
    """Phase 3, the gaussian and guided-filter kernels."""
    cases = [(shape, r, s) for shape in SHAPES for r, s in GAUSS]
    cases += [((3, 1080, 1920), 2, 1.5), ((3, 9), 4, 1.5)]
    for shape, r, sigma in cases:
        f, _ = guide_pair(shape, SEED + r, dev)
        got = gaussian_kernel(f, r, sigma)
        err = max_err(got, gaussian_plain(f, r, sigma))
        label = "x".join(map(str, shape))
        check(bool(torch.isfinite(got).all()), f"gaussian {label} finite")
        check(err <= 1e-5, f"gaussian {label} r{r}: {err} <= 1e-5")
        errs["gaussian"] = max(errs.get("gaussian", 0.0), err)
        print(f"phase 3 gaussian vs plain {label} r{r}: {err:.3g} [{card}]")
    cases = [(shape, r) for shape in SHAPES for r in GUIDED_R]
    cases += [((6, 40), 8)]
    for shape, r in cases:
        I, p = guide_pair(shape, SEED + 10 + r, dev)
        general = guided_filter_plain(I, p, r, GF_EPS)
        runs = {
            "guided self": (guided_filter_kernel(I, I, r, GF_EPS,
                                                 self_guided=True),
                            guided_filter_plain(I, I, r, GF_EPS, True)),
            "guided general": (guided_filter_kernel(I, p, r, GF_EPS),
                               general),
            "guided_twopass": (guided_filter_kernel(I, p, r, GF_EPS,
                                                    variant="twopass"),
                               general),
        }
        label = f"{shape[0]}x{shape[1]} r{r}"
        line = []
        for what, (got, ref) in runs.items():
            err = max_err(got, ref)
            check(bool(torch.isfinite(got).all()), f"{what} {label} finite")
            check(err <= 1e-4, f"{what} {label}: {err} <= 1e-4")
            name = what.split()[0]
            errs[name] = max(errs.get(name, 0.0), err)
            line.append(f"{what} {err:.3g}")
        print(f"phase 3 guided vs plain {label}: {', '.join(line)} [{card}]")


def he_numpy(frame: np.ndarray) -> np.ndarray:
    """The HE formula in NumPy (tpuimg's hist_equalize_ref): table[v] =
    rint(min(255, cdf[v] * float32(256 / N))), indexed by the frame."""
    cdf = np.cumsum(np.bincount(frame.ravel(), minlength=256))
    factor = np.float32(256.0 / frame.size)
    table = np.rint(np.minimum(np.float32(255.0),
                               cdf.astype(np.float32) * factor))
    return table.astype(np.uint8)[frame]


def integral_numpy(frames: np.ndarray) -> np.ndarray:
    """The integral in NumPy: int64 cumsums on both axes, wrapped to
    int32."""
    wide = np.cumsum(np.cumsum(frames.astype(np.int64), axis=-1), axis=-2)
    return wide.astype(np.int32)


def he_plain(img):
    """hist_equalize(img) composed from the kernels' plain versions."""
    h, w = img.shape[-2:]
    if img.ndim == 2:
        hist = hist256_groups_plain(img.reshape(1, -1))[0]
        return lut_gather_plain(_he_tables(hist, h * w), img)
    tables = _he_tables(hist256_groups_plain(img), h * w)
    return lut_gather_frames_plain(tables, img)


def batch_frames(shape, seed: int) -> np.ndarray:
    b, h, w = shape
    return np.stack([make_frame(h, w, seed + i) for i in range(b)])


def exact(what: str, got, ref, errs: dict, name: str) -> None:
    """got equals ref bit for bit (float tensors compared as int32 bits, so
    NaN payloads and -0.0 count); records the measured max_abs_err."""
    if got.is_floating_point():
        got, ref = got.view(torch.int32), ref.view(torch.int32)
    check(got.shape == ref.shape and got.dtype == ref.dtype
          and torch.equal(got, ref), f"{what} bit-exact")
    errs[name] = max(errs.get(name, 0.0), max_err(got, ref))


def check_he_kernels(dev, card: str, errs: dict, batch: np.ndarray) -> None:
    """Phase 3, the histogram and table-lookup kernels, and hist_equalize
    against the NumPy formula at 8K and on a flat frame."""
    frames = [(f"{h}x{w}", make_frame(h, w, SEED), False) for h, w in SHAPES]
    frames += [(f"{UHD8K[0]}x{UHD8K[1]}", make_frame(*UHD8K, SEED), True),
               (f"flat {SHAPES[0][0]}x{SHAPES[0][1]}",
                np.full(SHAPES[0], 77, np.uint8), True)]
    for label, frame, whole_op in frames:
        img = torch.from_numpy(frame).to(dev)
        hist = hist256(img)
        exact(f"hist256 {label}", hist,
              hist256_groups_plain(img.reshape(1, -1))[0], errs, "hist256")
        check(int(hist.sum()) == img.numel(),
              f"hist256 {label} counts every pixel")
        line = f"phase 3 hist256 vs plain {label}: exact"
        if whole_op:
            out = hist_equalize(img)
            check(np.array_equal(out.cpu().numpy(), he_numpy(frame)),
                  f"hist_equalize {label} vs the NumPy formula")
            line += "; hist_equalize equals the NumPy formula"
        print(f"{line} [{card}]")

    rng = np.random.default_rng(SEED)
    bits = rng.integers(-2 ** 31, 2 ** 31, 256).astype(np.int32)
    f32 = bits.view(np.float32).copy()
    f32[:2] = (-0.0, np.nan)
    for h, w in SHAPES:
        img = torch.from_numpy(make_frame(h, w, SEED)).to(dev)
        u8 = _he_tables(hist256_groups_plain(img.reshape(1, -1))[0], h * w)
        for kind, table in (("u8", u8), ("int32", torch.from_numpy(bits)),
                            ("float32", torch.from_numpy(f32))):
            table = table.to(dev)
            exact(f"lut_gather {kind} table {h}x{w}", lut_gather(table, img),
                  lut_gather_plain(table, img), errs, "lut_gather")
        print(f"phase 3 lut_gather vs plain {h}x{w}: u8, int32 and float32 "
              f"tables exact [{card}]")

    stack = torch.from_numpy(batch).to(dev)
    odd = torch.from_numpy(batch_frames((3, 1081, 1917), SEED + 20)).to(dev)
    for fr in (stack, odd):
        label = "x".join(map(str, fr.shape))
        exact(f"hist256_frames {label}", hist256_frames(fr),
              hist256_groups_plain(fr), errs, "hist256")
        print(f"phase 3 hist256_frames vs plain {label}: exact [{card}]")
    groups = torch.from_numpy(
        rng.integers(0, 256, (64, 8161), dtype=np.uint8)).to(dev)
    exact("hist256_groups 64x8161", hist256_groups(groups),
          hist256_groups_plain(groups), errs, "hist256")
    tables = _he_tables(hist256_groups_plain(stack), stack[0].numel())
    exact("lut_gather_frames", lut_gather_frames(tables, stack),
          lut_gather_frames_plain(tables, stack), errs, "lut_gather")
    print(f"phase 3 hist256_groups 64x8161 and lut_gather_frames "
          f"{'x'.join(map(str, BATCH))} vs plain: exact [{card}]")


def check_integral_kernel(dev, card: str, errs: dict,
                          batch: np.ndarray) -> None:
    """Phase 3, the scan kernel, against its plain version and NumPy."""
    cases = [(f"{h}x{w}", make_frame(h, w, SEED)) for h, w in SHAPES[:2]]
    cases.append(("x".join(map(str, batch[:3].shape)), batch[:3]))
    cases.append((f"all-255 {UHD8K[0]}x{UHD8K[1]}",
                  np.full(UHD8K, 255, np.uint8)))
    for label, frame in cases:
        img = torch.from_numpy(frame).to(dev)
        got = integral_kernel(img)
        exact(f"integral {label}", got, integral_plain(img), errs,
              "integral")
        want = integral_numpy(frame)
        check(np.array_equal(got.cpu().numpy(), want),
              f"integral {label} vs the wrapped int64 cumsum")
        print(f"phase 3 integral vs plain and NumPy {label}: exact, last sum "
              f"{int(want.reshape(-1)[-1])} [{card}]")
    check(int(want[-1, -1]) < 0, "the all-255 8K sums wrap past 2^31")


def counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr, _, _ in KERNELS}


def drive(label: str, expected, fn, *args):
    """One run of a main path: counters reset before, read after, every
    expected kernel launched. Returns the output and the counts."""
    for _, wrapper, attr, _, _ in KERNELS:
        setattr(wrapper, attr, 0)
    out = fn(*args)
    torch.cuda.synchronize()
    got = counts()
    for name in expected:
        check(got[name] > 0, f"{name} launched during {label} ({got[name]})")
    return out, got


def check_enhance_out(label, out, img, frame, impl, card) -> None:
    h, w = frame.shape
    check(out.shape == (h, w) and out.dtype == torch.uint8,
          f"{label} output {tuple(out.shape)} {out.dtype}")
    step = int((out.int() - enhance_plain(img, impl).int()).abs().max())
    check(step <= 1, f"{label} vs plain composition: {step} <= 1 step")
    crop = frame[:270, :480].copy()
    cpu = enhance(torch.from_numpy(crop), impl=impl).int()
    card_out = enhance(torch.from_numpy(crop).to(img.device), impl=impl)
    crop_step = int((card_out.cpu().int() - cpu).abs().max())
    check(crop_step <= 1, f"{label} {crop.shape} crop card vs CPU: "
          f"{crop_step} <= 1")
    print(f"phase 4 {label}: vs plain composition {step} step, "
          f"{crop.shape[0]}x{crop.shape[1]} crop vs CPU {crop_step} step, "
          f"mean {float(out.float().mean()):.2f} [{card}]")


def run_main_paths(dev, card: str, batch: np.ndarray) -> dict:
    """Phase 4; returns each kernel's launches summed over the runs."""
    total = dict.fromkeys(counts(), 0)
    clahe_kernels = ("tile_hist", "clahe_map")
    h, w = SHAPES[0]
    for label, shape, impl, tail in (
            (f"enhance {h}x{w} fused", (h, w), "fused", ("enhance_tail",)),
            (f"enhance {h}x{w} staged", (h, w), "staged",
             ("gaussian", "guided")),
            (f"enhance {SMALL[0]}x{SMALL[1]} fused", SMALL, "fused",
             ("gaussian", "guided"))):
        frame = make_frame(*shape, SEED + 1)
        img = torch.from_numpy(frame).to(dev)
        out, got = drive(label, clahe_kernels + tail, enhance, img, CLIP,
                         TILES, RG, SIGMA, GF_R, GF_EPS, impl)
        print(f"phase 4 {label}: launches {got} [{card}]")
        check_enhance_out(label, out, img, frame, impl, card)
        total = {k: total[k] + got[k] for k in total}

    # the stand-alone filters at the JAX package's bench rows (bench.py:54,
    # :72-81) and guided's twopass rung (tpuimg/cli.py:523-531)
    f1080, _ = guide_pair((1080, 1920), SEED + 2, dev)
    I, p = guide_pair((h, w), SEED + 3, dev)

    def filters():
        return (gaussian(f1080, 2, 1.5),
                guided_filter(I, I, 8, GF_EPS, border="reflect101"),
                guided_filter(I, p, 8, GF_EPS, border="reflect101"),
                guided_filter_kernel(I, p, 8, GF_EPS, variant="twopass"))

    outs, got = drive("the stand-alone filters",
                      ("gaussian", "guided", "guided_twopass"), filters)
    refs = (gaussian_plain(f1080, 2, 1.5),
            guided_filter_plain(I, I, 8, GF_EPS, True),
            guided_filter_plain(I, p, 8, GF_EPS),
            guided_filter_plain(I, p, 8, GF_EPS))
    errs = [max_err(o, r) for o, r in zip(outs, refs)]
    check(errs[0] <= 1e-5, f"gaussian 1080p r2: {errs[0]} <= 1e-5")
    check(max(errs[1:]) <= 1e-4, f"guided 4K r8: {errs[1:]} <= 1e-4")
    print(f"phase 4 stand-alone filters: launches {got}; gaussian 1080p r2 "
          f"{errs[0]:.3g}, guided 4K r8 self {errs[1]:.3g} general "
          f"{errs[2]:.3g} twopass {errs[3]:.3g} [{card}]")
    total = {k: total[k] + got[k] for k in total}
    he = run_he_integral_paths(dev, card, batch)
    return {k: total[k] + he[k] for k in total}


def run_he_integral_paths(dev, card: str, batch: np.ndarray) -> dict:
    """Phase 4 for hist_equalize at its two bench rows (bench.py:58-66) and
    integral at integral_4k (bench.py:56); returns the launches summed."""
    total = dict.fromkeys(counts(), 0)
    h, w = SHAPES[0]
    frame = make_frame(h, w, SEED + 4)
    he = ("hist256", "lut_gather")
    for label, expected, fn, arr in (
            (f"hist_equalize {h}x{w}", he, hist_equalize, frame),
            (f"hist_equalize {'x'.join(map(str, BATCH))}", he, hist_equalize,
             batch),
            (f"integral {h}x{w}", ("integral",), integral, frame)):
        x = torch.from_numpy(arr).to(dev)
        out, got = drive(label, expected, fn, x)
        check(all(got[k] == 1 for k in expected),
              f"{label}: one launch of each kernel ({got})")
        if fn is integral:
            plain, want = integral_plain(x), integral_numpy(arr)
        else:
            plain = he_plain(x)
            want = np.stack([he_numpy(f) for f in arr.reshape(
                (-1,) + arr.shape[-2:])]).reshape(arr.shape)
        check(out.shape == x.shape and out.dtype == plain.dtype
              and torch.equal(out, plain), f"{label} vs plain composition")
        check(np.array_equal(out.cpu().numpy(), want),
              f"{label} vs the NumPy formula")
        crop = np.ascontiguousarray(arr[..., :270, :480])
        card_out = fn(torch.from_numpy(crop).to(dev)).cpu()
        check(torch.equal(card_out, fn(torch.from_numpy(crop))),
              f"{label} {crop.shape} crop card vs CPU")
        mine = {k: got[k] for k in expected}
        print(f"phase 4 {label}: launches {mine}; equals the plain "
              f"composition and the NumPy formula, and the CPU run on a "
              f"{'x'.join(map(str, crop.shape))} crop [{card}]")
        total = {k: total[k] + got[k] for k in total}
    return total


def time_pair(label: str, fn, plain, args, card: str):
    k = time_cuda(fn, *args, iters=ITERS, card=card)
    p = time_cuda(plain, *args, iters=ITERS, card=card)
    print(f"phase 5 time {label}: kernel {k.ms:.4f} ms (min {k.ms_min:.4f}), "
          f"plain {p.ms:.4f} ms (min {p.ms_min:.4f}), median of {ITERS} "
          f"[{card}]")
    return k.ms, p.ms


def time_all(dev, card: str) -> dict:
    """Phase 5; returns {kernel: (ms, plain_ms)} at 4K."""
    plain = {"tile_hist": tile_hist_plain, "clahe_map": clahe_map_plain,
             "enhance_tail": enhance_tail_plain, "gaussian": gaussian_plain,
             "guided": guided_filter_plain,
             "guided_twopass": lambda I, p, r, eps, _: guided_filter_plain(
                 I, p, r, eps)}
    wrappers = {name: fn for name, fn, _, _, _ in KERNELS}
    at_4k = {}
    for h, w in TIMED:
        img = torch.from_numpy(make_frame(h, w, SEED)).to(dev)
        args = kernel_args(img)
        for name in plain:
            ms = time_pair(f"{name} {h}x{w}", wrappers[name], plain[name],
                           args[name], card)
            if (h, w) == SHAPES[0]:
                at_4k[name] = ms
        f = args["gaussian"][0]
        time_pair(f"guided self-guided {h}x{w}",
                  lambda x: guided_filter_kernel(x, x, GF_R, GF_EPS,
                                                 self_guided=True),
                  lambda x: guided_filter_plain(x, x, GF_R, GF_EPS, True),
                  (f,), card)
        for impl in ("fused", "staged"):
            e = time_cuda(enhance, img, CLIP, TILES, RG, SIGMA, GF_R, GF_EPS,
                          impl, iters=ITERS, card=card)
            ep = time_cuda(enhance_plain, img, impl, iters=ITERS, card=card)
            print(f"phase 5 time enhance {impl} {h}x{w}: kernels "
                  f"{e.ms:.4f} ms (min {e.ms_min:.4f}), plain composition "
                  f"{ep.ms:.4f} ms (min {ep.ms_min:.4f}), median of {ITERS} "
                  f"[{card}]")
    return at_4k


def time_he_integral(dev, card: str, batch: np.ndarray) -> dict:
    """Phase 5 for hist_equalize and integral; returns {kernel: (ms,
    plain_ms)} at 4K."""
    at_4k = {}
    for h, w in TIMED:
        img = torch.from_numpy(make_frame(h, w, SEED)).to(dev)
        table = _he_tables(hist256_groups_plain(img.reshape(1, -1))[0], h * w)
        pairs = {
            "hist256": (hist256, lambda x: hist256_groups_plain(
                x.reshape(1, -1))[0], (img,)),
            "lut_gather": (lut_gather, lut_gather_plain, (table, img)),
            "integral": (integral_kernel, integral_plain, (img,)),
        }
        for name, (fn, plain, args) in pairs.items():
            ms = time_pair(f"{name} {h}x{w}", fn, plain, args, card)
            if (h, w) == SHAPES[0]:
                at_4k[name] = ms
        time_pair(f"hist_equalize {h}x{w} end to end", hist_equalize,
                  he_plain, (img,), card)
        time_pair(f"integral {h}x{w} end to end", integral, integral_plain,
                  (img,), card)
    flat = torch.full(SHAPES[0], 77, dtype=torch.uint8, device=dev)
    time_pair(f"hist256 flat {SHAPES[0][0]}x{SHAPES[0][1]}", hist256,
              lambda x: hist256_groups_plain(x.reshape(1, -1))[0], (flat,),
              card)
    groups = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (64, 8161), dtype=np.uint8)).to(dev)
    time_pair("hist256_groups 64x8161", hist256_groups, hist256_groups_plain,
              (groups,), card)
    stack = torch.from_numpy(batch).to(dev)
    tables = _he_tables(hist256_groups_plain(stack), stack[0].numel())
    label = "x".join(map(str, BATCH))
    time_pair(f"hist256_frames {label}", hist256_frames, hist256_groups_plain,
              (stack,), card)
    time_pair(f"lut_gather_frames {label}", lut_gather_frames,
              lut_gather_frames_plain, (tables, stack), card)
    time_pair(f"hist_equalize {label} end to end", hist_equalize, he_plain,
              (stack,), card)
    return at_4k


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_label()
    print(card)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(kernels.BUILD_DIR.parent.parent)}")
    log = lib.with_suffix(".log")
    for line in log.read_text().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"phase 2 ptxas: {line.strip()}")

    errs = {}
    t0 = time.perf_counter()
    batch = batch_frames(BATCH, SEED + 5)
    check_enhance_kernels(dev, card, errs)
    check_filter_kernels(dev, card, errs)
    check_he_kernels(dev, card, errs, batch)
    check_integral_kernel(dev, card, errs, batch)
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = run_main_paths(dev, card, batch)
    print(f"phase 4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    times = time_all(dev, card)
    times.update(time_he_integral(dev, card, batch))
    print(f"phase 5 took {time.perf_counter() - t0:.1f} s")

    rows = [{"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": launches[name], "max_abs_err": errs[name],
             "ms": times[name][0], "plain_ms": times[name][1]}
            for name, _, _, src, tpu in KERNELS]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
