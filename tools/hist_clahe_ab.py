"""The CLAHE mapping, 256-bin histogram and guided-filter kernels of this
checkout against another checkout's, in one process on one card.

Each checkout's kernels are built from its own ``tpuimg_torch/csrc`` into a
library of their own (``tools/stencil_ab.py``'s build); every call goes
through this checkout's wrappers with one library or the other swapped in,
so the two differ only in their CUDA code. The one exception is the
histogram of a checkout whose ``tpuimg_hist256`` still adds into a zeroed
output (no workspace argument): that entry is called as its own wrapper
called it, the same checks, then a ``torch.zeros`` and the launch.

Checks first, each output's SHA-256 printed for both checkouts:
- ``clahe_map`` (f32 and u8) and ``clahe_band_map`` give the same bits in
  both checkouts (4K, 2161x3840 and 1080p at 8 tiles, 4K at 2, 16 and 64
  tiles, the band of a 4K shard at y0 540);
- the histograms give the same counts in both checkouts and equal their
  plain version (one frame, frames, groups, packed words, a flat frame);
- the guided kernels (onepass frame and row-padded entries, twopass, both
  enhance tails) stay within 1e-4 of their plain version in both
  checkouts; whether their bits agree is printed, and for the tails it is
  required.
Then each call is timed with CUDA events in turns (other, this, this,
other), the histogram calls also by the host clock (back to back, what a
host-bound caller such as hist_equalize waits for), and the profiler splits
the histogram calls into their kernels in each checkout.

Run from the repository root on a CUDA card, with the other checkout
unpacked into a directory that .gitignore lists, e.g. the parent commit:

    mkdir -p _tree_check/parent
    git archive HEAD~1 | tar -x -C _tree_check/parent
    python3 tools/hist_clahe_ab.py _tree_check/parent
"""

from __future__ import annotations

import ctypes
import hashlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import make_frame  # noqa: E402
from scan_guided_ab import split  # noqa: E402
from stencil_ab import build  # noqa: E402
from tpuimg_torch import kernels  # noqa: E402
from tpuimg_torch.kernels import require_cuda_tensor  # noqa: E402
from tpuimg_torch.core.timing import card_label, time_cuda  # noqa: E402
from tpuimg_torch.kernels.boxsum import (  # noqa: E402
    enhance_tail, enhance_tail_clahe, guided_filter_kernel,
    guided_filter_plain, guided_ypadded_kernel, guided_ypadded_plain)
from tpuimg_torch.kernels.hist import (  # noqa: E402
    hist256_groups, hist256_groups_packed, hist256_groups_packed_plain,
    hist256_groups_plain, tile_hist_plain)
from tpuimg_torch.kernels.lut import clahe_band_map, clahe_map  # noqa: E402
from tpuimg_torch.ops.histogram import (  # noqa: E402
    _clahe_geometry, _clahe_tables)

ITERS = 30
R, EPS, RG, SIGMA = 8, 1e-3, 2, 1.5  # enhance's defaults
LIBS: dict = {}


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def host_ms(fn, calls: int = 200) -> float:
    """Host-clock ms a call over back-to-back calls ending in a
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def use(name: str) -> None:
    kernels._lib = LIBS[name]


def hist(entry: str, name: str, x, units: int):
    """A histogram call through library ``name``: this checkout's wrapper,
    or an entry without a workspace argument called as its own wrapper
    called it (into a zeroed output)."""
    use(name)
    packed = entry == "tpuimg_hist256_packed"
    if name == "this" or not LIBS["other_legacy_hist"]:
        return (hist256_groups_packed if packed else hist256_groups)(x)
    require_cuda_tensor(x, "x", torch.int32 if packed else torch.uint8)
    out = torch.zeros((x.shape[0], 256), dtype=torch.int32, device=x.device)
    kernels.launch(entry, x.device, x.data_ptr(), x.shape[0], units,
                   out.data_ptr())
    return out


def cases(dev):
    """(label, call(name) -> output, kind): kind "same" (equal bits in both
    checkouts), "plain" (a function of the input -> the plain version,
    exact), or "near" (the plain version, within 1e-4)."""
    frames = {s: torch.from_numpy(make_frame(*s, 0)).to(dev)
              for s in ((2160, 3840), (2161, 3840), (1080, 1920))}
    out = []
    for (h, w), tiles, f32 in (((2160, 3840), 8, True),
                               ((2160, 3840), 8, False),
                               ((2161, 3840), 8, True),
                               ((2161, 3840), 8, False),
                               ((1080, 1920), 8, True),
                               ((1080, 1920), 8, False),
                               ((2160, 3840), 2, True),
                               ((2160, 3840), 16, False),
                               ((2160, 3840), 64, True)):
        img = frames[(h, w)]
        th, tw, pt, pl = _clahe_geometry(h, w, tiles, tiles)
        tables = _clahe_tables(tile_hist_plain(img, tiles, tiles, th, tw, pt,
                                               pl), 2.0, th, tw)
        args = (img, tables, tiles, tiles, th, tw, pt, pl, f32)

        def run(name, args=args):
            use(name)
            return clahe_map(*args)

        out.append((f"clahe_map {'f32' if f32 else 'u8'} {h}x{w} tiles "
                    f"{tiles}", run, "same"))
        if (h, w, tiles) == (2160, 3840, 8):
            band = img[540:1080]

            def run_band(name, band=band, tables=tables, f32=f32,
                         geo=(th, tw, pt, pl)):
                use(name)
                return clahe_band_map(band, tables, 8, 8, *geo, 540,
                                      out_f32=f32)

            out.append((f"clahe_band_map {'f32' if f32 else 'u8'} 540x3840 "
                        f"at y0 540", run_band, "same"))
    rng = np.random.default_rng(0)
    stack = torch.from_numpy(np.stack([make_frame(1080, 1920, 5 + i)
                                       for i in range(16)])).to(dev)
    groups = torch.from_numpy(rng.integers(0, 256, (64, 8161),
                                           dtype=np.uint8)).to(dev)
    flat = torch.full((2160, 3840), 77, dtype=torch.uint8, device=dev)
    for label, x in (("hist256 2160x3840", frames[(2160, 3840)]),
                     ("hist256 1080x1920", frames[(1080, 1920)]),
                     ("hist256 flat 2160x3840", flat),
                     ("hist256_frames 16x1080x1920", stack),
                     ("hist256_groups 64x8161", groups)):
        x2 = x.reshape(x.shape[0] if x.ndim == 3 or x is groups else 1, -1)
        out.append((label, lambda name, x2=x2: hist(
            "tpuimg_hist256", name, x2, x2.shape[1]),
            lambda x2=x2: hist256_groups_plain(x2)))
    words = frames[(2160, 3840)].view(torch.int32).reshape(1, -1)
    out.append(("hist256_packed 2160x3840 as words", lambda name: hist(
        "tpuimg_hist256_packed", name, words, words.shape[1]),
        lambda: hist256_groups_packed_plain(words)))

    g = np.random.default_rng(0)
    I4k = torch.from_numpy(g.random((2160, 3840), dtype=np.float32)).to(dev)
    p4k = torch.clamp(I4k + 0.1 * torch.from_numpy(g.standard_normal(
        (2160, 3840)).astype(np.float32)).to(dev), 0, 1)
    blk, pblk = (x[:572].contiguous() for x in (I4k, p4k))
    img = frames[(2160, 3840)]
    th, tw, pt, pl = _clahe_geometry(2160, 3840, 8, 8)
    tables = _clahe_tables(tile_hist_plain(img, 8, 8, th, tw, pt, pl), 2.0,
                           th, tw)

    def guided(label, fn, ref, kind="near"):
        def run(name):
            use(name)
            return fn()
        out.append((label, run, kind if ref is None else ref))

    gen4k = guided_filter_plain(I4k, p4k, R, EPS)
    guided("onepass general r8 2160x3840",
           lambda: guided_filter_kernel(I4k, p4k, R, EPS), lambda: gen4k)
    guided("onepass self r8 2160x3840",
           lambda: guided_filter_kernel(I4k, I4k, R, EPS, self_guided=True),
           lambda: guided_filter_plain(I4k, I4k, R, EPS, True))
    guided("twopass r8 2160x3840",
           lambda: guided_filter_kernel(I4k, p4k, R, EPS, variant="twopass"),
           lambda: gen4k)
    guided("guided_ypadded general r8 572x3840 -> 540",
           lambda: guided_ypadded_kernel(blk, pblk, R, EPS),
           lambda: guided_ypadded_plain(blk, pblk, R, EPS))
    guided("enhance_tail 2160x3840",
           lambda: enhance_tail(I4k, RG, SIGMA, R, EPS), None, "same")
    guided("enhance_tail_clahe 2160x3840",
           lambda: enhance_tail_clahe(img, tables, 8, 8, th, tw, pt, pl, RG,
                                      SIGMA, R, EPS), None, "same")
    return out


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve() / "tpuimg_torch" / "csrc"
    card = card_label()
    print(card)
    LIBS["this"] = kernels.bind(build(kernels.CSRC, "this"))
    LIBS["other"] = kernels.bind(build(other, "other"), missing_ok=True)
    # an entry without the workspace argument adds into a zeroed output
    legacy = "ws_ints" not in (other / "hist256.cu").read_text()
    LIBS["other_legacy_hist"] = legacy
    if legacy:  # x, groups, p, out, stream: out zeroed by the caller
        for entry in ("tpuimg_hist256", "tpuimg_hist256_packed"):
            fn = getattr(LIBS["other"], entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    runs = cases(torch.device("cuda"))
    for label, call, kind in runs:
        outs = {name: call(name) for name in ("this", "other")}
        torch.cuda.synchronize()
        same = torch.equal(outs["this"], outs["other"])
        line = f"CHECK {label}: this and other {'equal' if same else 'differ'}"
        if kind == "same" and not same:
            raise SystemExit(f"hist_clahe_ab: {label} differs between the "
                             f"checkouts")
        if callable(kind):
            ref = kind()
            for name, got in outs.items():
                if got.dtype == torch.int32:
                    ok, err = torch.equal(got, ref), 0.0
                else:
                    err = float((got - ref).abs().max())
                    ok = err <= 1e-4 and bool(torch.isfinite(got).all())
                if not ok:
                    raise SystemExit(f"hist_clahe_ab: {label} ({name}) is "
                                     f"{err} from its plain version")
                line += f"; {name} vs plain {err:.3g}"
        print(f"{line}; sha256 this {digest(outs['this'])}, other "
              f"{digest(outs['other'])}", flush=True)
    for label, call, _ in runs:
        t = {"this": [], "other": []}
        for name in ("other", "this", "this", "other"):
            t[name].append(time_cuda(call, name, iters=ITERS, card=card).ms)
        print(f"AB {label}: this {t['this'][0]:.4f} / {t['this'][1]:.4f} "
              f"ms, other {t['other'][0]:.4f} / {t['other'][1]:.4f} ms, "
              f"median of {ITERS} [{card}]", flush=True)
    for label, call, _ in runs:
        if label.startswith("hist256"):
            t = {name: host_ms(lambda n=name, c=call: c(n))
                 for name in ("other", "this")}
            print(f"HOST {label}: this {t['this']:.4f} ms a call, other "
                  f"{t['other']:.4f}, 200 calls back to back [{card}]",
                  flush=True)
            for name in ("this", "other"):
                print(f"SPLIT {label} ({name}), device ms a call: "
                      f"{split(lambda n=name, c=call: c(n))} [{card}]",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
