#!/usr/bin/env python3
"""Drive tpuimg_torch's enhance pipeline and filters once on one CUDA card
and check them.

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
   (r 1, 8, 16, plus a 6x40 frame at r 8) <= 1e-4 and finite;
4. the main paths, each run once with every launch counter reset just
   before and read just after, and each of its kernels launched:
   enhance at 4K (impl="fused": tile_hist, clahe_map, enhance_tail),
   enhance at 4K with impl="staged" and enhance on a 32x48 frame (under the
   tail kernel's gate; both: tile_hist, clahe_map, gaussian, guided), and
   the stand-alone filters (gaussian r2 at 1080p, guided r8 at 4K
   self-guided, general, and twopass). Each enhance output is u8 of the
   frame's shape, within 1 step of the plain composition on the card and
   within 1 step of the CPU run on a crop; each filter output is within its
   contract of the plain version;
5. CUDA-event timing (median of 30 after 3 warm-up runs) of every kernel and
   its plain version, and of enhance on both impls, at 4K and 1080p.

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

from tpuimg_torch import gaussian, guided_filter, kernels
from tpuimg_torch.core.timing import card_label, time_cuda
from tpuimg_torch.kernels.boxsum import (
    enhance_tail, enhance_tail_plain, guided_filter_kernel,
    guided_filter_plain)
from tpuimg_torch.kernels.hist import tile_hist, tile_hist_plain
from tpuimg_torch.kernels.lut import clahe_map, clahe_map_plain
from tpuimg_torch.kernels.sep_stencil import gaussian_kernel, gaussian_plain
from tpuimg_torch.ops.histogram import _clahe_geometry, _clahe_tables
from tpuimg_torch.pipeline import _to_u8, enhance

SEED = 0
SHAPES = [(2160, 3840), (2161, 3839), (1080, 1920)]
TIMED = [(2160, 3840), (1080, 1920)]
# enhance's defaults (tpuimg/pipeline.py, the enhance_pipeline_4k bench row)
CLIP, TILES, RG, SIGMA, GF_R, GF_EPS = 2.0, 8, 2, 1.5, 8, 1e-3
GAUSS = [(1, 0.8), (2, 1.5), (7, 3.0)]  # radius, sigma
GUIDED_R = [1, 8, 16]
SMALL = (32, 48)  # under the tail kernel's gate: 32 <= 2*(2*8 + 2)
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


def run_main_paths(dev, card: str) -> dict:
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
    return {k: total[k] + got[k] for k in total}


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
    check_enhance_kernels(dev, card, errs)
    check_filter_kernels(dev, card, errs)
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = run_main_paths(dev, card)
    print(f"phase 4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    times = time_all(dev, card)
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
