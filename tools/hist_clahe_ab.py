"""The CLAHE mapping, 256-bin histogram, tile-histogram, gather and
guided-filter kernels of this checkout against another checkout's, in one
process on one card.

Each checkout's kernels are built from its own ``tpuimg_torch/csrc`` into a
library of their own (``tools/stencil_ab.py``'s build); every call goes
through this checkout's wrappers with one library or the other swapped in,
so the two differ only in their CUDA code. The exceptions are entries whose
C signature this checkout changed, which are called as the other
checkout's wrappers called them: a ``tpuimg_hist256`` without a workspace
argument and a ``tpuimg_tile_hist`` without a grid plan add into an output
that a ``torch.zeros`` made first; a ``tpuimg_lut_gather`` without a grid
plan takes the same arguments less the plan; entries without the scale
of ``tpuimg_clahe_map`` or the u8 store of the tails
(``stencil_ab.OlderEntries``) take enhance's scaling and rounding in
PyTorch. The ops that reach them (clahe, enhance, hist_equalize, apply_lut)
then run those calls too.

Checks first, each output's SHA-256 printed for both checkouts:
- ``clahe_map`` (f32 and u8) and ``clahe_band_map`` give the same bits in
  both checkouts (4K, 2161x3840 and 1080p at 8 tiles, 4K at 2, 16 and 64
  tiles, the band of a 4K shard at y0 540);
- the histograms give the same counts in both checkouts and equal their
  plain version (one frame, frames, groups, packed words, a flat frame);
- the tile histograms (4K at 2, 8, 16 and 64 tiles, 1080p, 2161x3840, a
  flat 4K frame) and the gather (u8 and float32 tables at 4K and 1080p, a
  4K input at offset 1, 16 frames of 1080p) equal their plain version in
  both checkouts;
- clahe, enhance (fused, staged, fused1), hist_equalize (4K and 16
  frames of 1080p) and apply_lut at 4K give the same bits in both;
- the guided kernels (onepass frame and row-padded entries, twopass, both
  enhance tails) stay within 1e-4 of their plain version in both
  checkouts; whether their bits agree is printed, and for the tails it is
  required.
Then each call is timed with CUDA events in turns (other, this, this,
other), the histogram calls also by the host clock (back to back, what a
host-bound caller such as hist_equalize waits for), and the profiler splits
the histogram, tile-histogram and gather calls into their kernels in each
checkout.

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
from stencil_ab import bind_other, build, entry_params  # noqa: E402
from tpuimg_torch import pipeline  # noqa: E402
from tpuimg_torch import (  # noqa: E402
    clahe, hist_equalize, kernels)
from tpuimg_torch.kernels import lut as klut  # noqa: E402
from tpuimg_torch.ops import histogram as ops_histogram  # noqa: E402
from tpuimg_torch.kernels import require_cuda_tensor  # noqa: E402
from tpuimg_torch.core.timing import card_label, time_cuda  # noqa: E402
from tpuimg_torch.kernels.boxsum import (  # noqa: E402
    enhance_tail, enhance_tail_clahe, guided_filter_kernel,
    guided_filter_plain, guided_ypadded_kernel, guided_ypadded_plain,
    q_to_u8)
from tpuimg_torch.kernels.hist import (  # noqa: E402
    hist256_groups, hist256_groups_packed, hist256_groups_packed_plain,
    hist256_groups_plain, tile_hist, tile_hist_plain)
from tpuimg_torch.kernels.lut import (  # noqa: E402
    clahe_band_map, clahe_map, lut_gather, lut_gather_frames,
    lut_gather_frames_plain, lut_gather_plain)
from tpuimg_torch.ops.histogram import (  # noqa: E402
    _clahe_geometry, _clahe_tables, _he_tables, apply_lut)
from tpuimg_torch.pipeline import enhance  # noqa: E402

ITERS = 30
R, EPS, RG, SIGMA = 8, 1e-3, 2, 1.5  # enhance's defaults
LIBS: dict = {}


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def bits(t):
    """A tensor's bits as integers of its width (NaN payloads, -0.0)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


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


def legacy_tile_hist(img, ytiles, xtiles, th, tw, pad_top, pad_left):
    """A tile-histogram call as a wrapper without a grid plan made it: a
    zeroed output, then the launch that adds into it."""
    h, w = img.shape
    out = torch.zeros((ytiles * xtiles, 256), dtype=torch.int32,
                      device=img.device)
    kernels.launch("tpuimg_tile_hist", img.device, img.data_ptr(), h, w,
                   ytiles, xtiles, th, tw, pad_top, pad_left, out.data_ptr())
    return out


def legacy_gather(img, tables, tstride):
    """A gather call as a wrapper without a grid plan made it."""
    words = tables.view(torch.uint8 if tables.element_size() == 1
                        else torch.int32)
    out = torch.empty(img.shape, dtype=words.dtype, device=img.device)
    frames = img.shape[0] if tstride else 1
    kernels.launch("tpuimg_lut_gather", img.device, img.data_ptr(),
                   img.numel() // frames, frames, words.data_ptr(), tstride,
                   words.element_size(), out.data_ptr())
    return out.view(tables.dtype)


def older_map(*args, out_f32=False, scale=1.0):
    """enhance's clahe_map as a checkout without the scaled store ran it: the
    raw blend, times scale in PyTorch."""
    return clahe_map(*args, out_f32=out_f32) * scale


def older_tail(tail):
    """enhance's tail as a checkout without the u8 store ran it: f32 q,
    rounded in PyTorch."""
    def call(*args, out_u8=False):
        q = tail(*args)
        return q_to_u8(q) if out_u8 else q
    return call


WRAPPERS = {"tile_hist": tile_hist, "gather": klut._gather}
FUSED = {"clahe_map": (clahe_map, older_map),
         "enhance_tail": (enhance_tail, older_tail(enhance_tail)),
         "enhance_tail_clahe": (enhance_tail_clahe,
                                older_tail(enhance_tail_clahe))}


def use(name: str) -> None:
    """Swap library ``name`` in, with the other checkout's calling
    conventions for the entries whose signature changed."""
    kernels._lib = LIBS[name]
    other = name == "other"
    for fn, (this_form, older_form) in FUSED.items():
        setattr(pipeline, fn, older_form if other and LIBS["other"].lacks(
            "out_u8") else this_form)
    ops_histogram.tile_hist = (legacy_tile_hist if other and
                               LIBS["other_legacy_tile"]
                               else WRAPPERS["tile_hist"])
    klut._gather = (legacy_gather if other and LIBS["other_legacy_lut"]
                    else WRAPPERS["gather"])


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

    def called(fn, *args):
        def run(name):
            use(name)
            return fn(*args)
        return run

    def tiles_of(img, tiles):
        h, w = img.shape
        return (img, tiles, tiles, *_clahe_geometry(h, w, tiles, tiles))

    def tile_call(*args):
        # through the op module's name, which use() points at either call
        return ops_histogram.tile_hist(*args)

    tile_cases = [((2160, 3840), t) for t in (2, 8, 16, 64)]
    tile_cases += [((1080, 1920), 8), ((2161, 3840), 8)]
    for shape, tiles in tile_cases:
        args = tiles_of(frames[shape], tiles)
        out.append((f"tile_hist {shape[0]}x{shape[1]} tiles {tiles}",
                    called(tile_call, *args),
                    lambda args=args: tile_hist_plain(*args)))
    args = tiles_of(flat, 8)
    out.append(("tile_hist flat 2160x3840 tiles 8", called(tile_call, *args),
                lambda args=args: tile_hist_plain(*args)))
    f32 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 256).astype(
        np.int32).view(np.float32)).to(dev)
    f32[:2] = torch.tensor([-0.0, float("nan")], device=dev)
    for shape in ((2160, 3840), (1080, 1920)):
        img = frames[shape]
        u8 = _he_tables(hist256_groups_plain(img.reshape(1, -1))[0],
                        img.numel())
        for kind, table in (("u8", u8), ("f32", f32)):
            out.append((f"lut_gather {kind} {shape[0]}x{shape[1]}",
                        called(lut_gather, table, img),
                        lambda t=table, x=img: lut_gather_plain(t, x)))
    buf = torch.from_numpy(make_frame(2160, 3841, 7).reshape(-1)).to(dev)
    off = buf[1:1 + 2160 * 3840].view(2160, 3840)
    u8 = _he_tables(hist256_groups_plain(off.reshape(1, -1))[0], off.numel())
    out.append(("lut_gather u8 2160x3840 at offset 1",
                called(lut_gather, u8, off),
                lambda: lut_gather_plain(u8, off)))
    tabs = _he_tables(hist256_groups_plain(stack), stack[0].numel())
    out.append(("lut_gather_frames 16x1080x1920",
                called(lut_gather_frames, tabs, stack),
                lambda: lut_gather_frames_plain(tabs, stack)))
    img4k = frames[(2160, 3840)]
    for label, fn, args in (
            ("clahe u8 2160x3840", clahe, (img4k, 2.0, 8, 8)),
            ("enhance fused 2160x3840", enhance, (img4k,)),
            ("enhance staged 2160x3840", enhance,
             (img4k, 2.0, 8, RG, SIGMA, R, EPS, "staged")),
            ("enhance fused1 2160x3840", enhance,
             (img4k, 2.0, 8, RG, SIGMA, R, EPS, "fused1")),
            ("hist_equalize 2160x3840", hist_equalize, (img4k,)),
            ("hist_equalize 16x1080x1920", hist_equalize, (stack,)),
            ("apply_lut u8 2160x3840", apply_lut, (u8, img4k))):
        out.append((label, called(fn, *args), "same"))

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
    LIBS["other"] = bind_other(other)
    # an entry without the workspace argument adds into a zeroed output
    legacy = "ws_ints" not in entry_params(other, "tpuimg_hist256")
    LIBS["other_legacy_hist"] = legacy
    # entries without the grid plan arguments
    tile_legacy = "cluster" not in entry_params(other, "tpuimg_tile_hist")
    lut_legacy = "per_block" not in entry_params(other,
                                                 "tpuimg_lut_gather")
    LIBS["other_legacy_tile"] = tile_legacy
    LIBS["other_legacy_lut"] = lut_legacy
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry, args, old_form in (
            ("tpuimg_tile_hist", [P] + [I] * 8 + [P, P], tile_legacy),
            ("tpuimg_lut_gather", [P, L, I, P, I, I, P, P], lut_legacy)):
        if old_form:
            fn = getattr(LIBS["other"], entry)
            fn.argtypes = args
            fn.restype = ctypes.c_int
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
        same = torch.equal(bits(outs["this"]), bits(outs["other"]))
        line = f"CHECK {label}: this and other {'equal' if same else 'differ'}"
        if kind == "same" and not same:
            raise SystemExit(f"hist_clahe_ab: {label} differs between the "
                             f"checkouts")
        if callable(kind):
            ref = kind()
            for name, got in outs.items():
                if got.dtype != torch.float32 or label.startswith(
                        "lut_gather"):  # counts, or bits copied
                    ok, err = torch.equal(bits(got), bits(ref)), 0.0
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
        if label.startswith(("tile_hist", "lut_gather")):
            for name in ("this", "other"):
                print(f"SPLIT {label} ({name}), device ms a call: "
                      f"{split(lambda n=name, c=call: c(n))} [{card}]",
                      flush=True)
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
