#!/usr/bin/env python3
"""Drive tpuimg_torch's enhance pipeline once on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (nvidia-smi name and power limit); no card -> exit 1;
2. build the CUDA kernels from tpuimg_torch/csrc (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the same card tensors,
   at 2160x3840, 2161x3839 (unaligned tiles and padding) and 1080x1920:
   tile histograms bit-exact, CLAHE f32 blend <= 1e-3 and u8 <= 1 step,
   enhance tail <= 1e-4 (the fused guided-filter contract);
4. enhance at 4K with the default parameters: launch counters reset, one
   run, every kernel launched; output u8 of the frame's shape, within 1 step
   of the plain composition on the card, and a crop within 1 step of the
   CPU run of the same crop;
5. CUDA-event timing (median of 30 after 3 warm-up runs) of every kernel and
   its plain version, and of enhance on both paths, at 4K and 1080p.

Then one JSON line with the kernels, and last the device line. Any failed
check raises, so the script exits non-zero without printing the device line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tpuimg_torch import kernels
from tpuimg_torch.core.timing import card_label, time_cuda
from tpuimg_torch.kernels.boxsum import enhance_tail, enhance_tail_plain
from tpuimg_torch.kernels.hist import tile_hist, tile_hist_plain
from tpuimg_torch.kernels.lut import clahe_map, clahe_map_plain
from tpuimg_torch.ops.histogram import _clahe_geometry, _clahe_tables
from tpuimg_torch.pipeline import _to_u8, enhance

SEED = 0
SHAPES = [(2160, 3840), (2161, 3839), (1080, 1920)]
TIMED = [(2160, 3840), (1080, 1920)]
# enhance's defaults (tpuimg/pipeline.py, the enhance_pipeline_4k bench row)
CLIP, TILES, RG, SIGMA, GF_R, GF_EPS = 2.0, 8, 2, 1.5, 8, 1e-3
ITERS = 30

KERNELS = [
    ("tile_hist", tile_hist, "tpuimg_torch/csrc/tile_hist.cu",
     "tpuimg/kernels/hist.py:213"),
    ("clahe_map", clahe_map, "tpuimg_torch/csrc/clahe_map.cu",
     "tpuimg/kernels/lut.py:341"),
    ("enhance_tail", enhance_tail, "tpuimg_torch/csrc/enhance_tail.cu",
     "tpuimg/kernels/boxsum.py:396"),
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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


def front(img):
    """CLAHE geometry and tables of a frame (plain versions)."""
    h, w = img.shape
    th, tw, pt, pl = _clahe_geometry(h, w, TILES, TILES)
    hists = tile_hist_plain(img, TILES, TILES, th, tw, pt, pl)
    return (th, tw, pt, pl), _clahe_tables(hists, CLIP, th, tw)


def enhance_plain(img):
    """enhance(img) composed from the three kernels' plain versions."""
    geo, tables = front(img)
    blend = clahe_map_plain(img, tables, TILES, TILES, *geo, out_f32=True)
    return _to_u8(enhance_tail_plain(blend * (1.0 / 255.0), RG, SIGMA, GF_R,
                                     GF_EPS))


def kernel_args(img):
    """The arguments each kernel gets on the enhance path for this frame."""
    geo, tables = front(img)
    blend = clahe_map_plain(img, tables, TILES, TILES, *geo, out_f32=True)
    f = blend * (1.0 / 255.0)
    return {
        "tile_hist": (img, TILES, TILES, *geo),
        "clahe_map": (img, tables, TILES, TILES, *geo, True),
        "enhance_tail": (f, RG, SIGMA, GF_R, GF_EPS),
    }


def check_kernels(dev, card: str) -> dict:
    """Phase 3; returns the max errors at the first (4K) shape."""
    errs_4k = {}
    for h, w in SHAPES:
        img = torch.from_numpy(make_frame(h, w, SEED)).to(dev)
        args = kernel_args(img)
        got = tile_hist(*args["tile_hist"])
        ref = tile_hist_plain(*args["tile_hist"])
        hist_err = float((got - ref).abs().max())
        check(torch.equal(got, ref), f"tile_hist {h}x{w} bit-exact")
        check(int(got.sum()) == TILES * TILES * args["tile_hist"][3]
              * args["tile_hist"][4], f"tile_hist {h}x{w} counts every pixel")
        got = clahe_map(*args["clahe_map"])
        ref = clahe_map_plain(*args["clahe_map"])
        map_err = float((got - ref).abs().max())
        check(map_err <= 1e-3, f"clahe_map f32 {h}x{w}: {map_err} <= 1e-3")
        u8_args = args["clahe_map"][:-1] + (False,)
        step = int((clahe_map(*u8_args).int()
                    - clahe_map_plain(*u8_args).int()).abs().max())
        check(step <= 1, f"clahe_map u8 {h}x{w}: {step} <= 1 step")
        got = enhance_tail(*args["enhance_tail"])
        ref = enhance_tail_plain(*args["enhance_tail"])
        tail_err = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all()), f"enhance_tail {h}x{w} finite")
        check(tail_err <= 1e-4, f"enhance_tail {h}x{w}: {tail_err} <= 1e-4")
        torch.cuda.synchronize()
        print(f"phase 3 kernels vs plain {h}x{w}: tile_hist exact, "
              f"clahe_map f32 {map_err:.3g} u8 {step} step, "
              f"enhance_tail {tail_err:.3g} [{card}]")
        if not errs_4k:
            errs_4k = {"tile_hist": hist_err, "clahe_map": map_err,
                       "enhance_tail": tail_err}
    return errs_4k


def run_main_path(dev, card: str) -> dict:
    """Phase 4: enhance at 4K through the kernels; returns launch counts."""
    h, w = SHAPES[0]
    frame = make_frame(h, w, SEED + 1)
    img = torch.from_numpy(frame).to(dev)
    for _, fn, _, _ in KERNELS:
        fn.launches = 0
    out = enhance(img, CLIP, TILES, RG, SIGMA, GF_R, GF_EPS)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn, _, _ in KERNELS}
    for name, n in launches.items():
        check(n > 0, f"{name} launched during enhance ({n} times)")
    check(out.shape == (h, w) and out.dtype == torch.uint8,
          f"enhance output {tuple(out.shape)} {out.dtype}")
    step = int((out.int() - enhance_plain(img).int()).abs().max())
    check(step <= 1, f"enhance 4K vs plain composition: {step} <= 1 step")
    crop = frame[:270, :480].copy()
    cpu = enhance(torch.from_numpy(crop)).int()
    card_out = enhance(torch.from_numpy(crop).to(dev)).cpu().int()
    crop_step = int((card_out - cpu).abs().max())
    check(crop_step <= 1, f"enhance 270x480 card vs CPU: {crop_step} <= 1")
    print(f"phase 4 enhance {h}x{w}: launches {launches}, vs plain "
          f"composition {step} step, 270x480 crop vs CPU {crop_step} step, "
          f"mean {float(out.float().mean()):.2f} [{card}]")
    return launches


def time_all(dev, card: str) -> dict:
    """Phase 5; returns {kernel: (ms, plain_ms)} at 4K."""
    plain = {"tile_hist": tile_hist_plain, "clahe_map": clahe_map_plain,
             "enhance_tail": enhance_tail_plain}
    at_4k = {}
    for h, w in TIMED:
        img = torch.from_numpy(make_frame(h, w, SEED)).to(dev)
        args = kernel_args(img)
        for name, fn, _, _ in KERNELS:
            k = time_cuda(fn, *args[name], iters=ITERS, card=card)
            p = time_cuda(plain[name], *args[name], iters=ITERS, card=card)
            print(f"phase 5 time {name} {h}x{w}: kernel {k.ms:.4f} ms "
                  f"(min {k.ms_min:.4f}), plain {p.ms:.4f} ms "
                  f"(min {p.ms_min:.4f}), median of {ITERS} [{card}]")
            if (h, w) == SHAPES[0]:
                at_4k[name] = (k.ms, p.ms)
        e = time_cuda(enhance, img, iters=ITERS, card=card)
        ep = time_cuda(enhance_plain, img, iters=ITERS, card=card)
        print(f"phase 5 time enhance {h}x{w}: kernels {e.ms:.4f} ms "
              f"(min {e.ms_min:.4f}), plain composition {ep.ms:.4f} ms "
              f"(min {ep.ms_min:.4f}), median of {ITERS} [{card}]")
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
    if log.exists():
        for line in log.read_text().splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"phase 2 ptxas: {line.strip()}")

    errs = check_kernels(dev, card)
    launches = run_main_path(dev, card)
    times = time_all(dev, card)

    rows = [{"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": launches[name], "max_abs_err": errs[name],
             "ms": times[name][0], "plain_ms": times[name][1]}
            for name, _, src, tpu in KERNELS]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
