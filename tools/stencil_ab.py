"""The gaussian and erode/dilate kernels of this checkout against another
checkout's, in one process on one card.

Each checkout's kernels are built from its own ``tpuimg_torch/csrc`` into a
library of their own; every call goes through this checkout's wrappers with
one library or the other swapped in, so the two differ only in their CUDA
code. Each output is first checked against its plain version (bit for bit),
then timed with CUDA events in turns (other, this, this, other): the kernels
at the shapes of ``chip_smoke.py``'s main paths, staged ``enhance`` at 4K,
``enhance_sharded`` over (1, 4) at 4K and 8K (also by the host clock: it is
host-bound at 4K) and ``stencil_sharded`` over (2, 4).

Then erode at 4K by direct calls of the C entry, from copies of this
checkout's ``morphology.cu`` with one decision changed (the copies compute
the same values; only their times are read):
- by radius, r15 to r226: this checkout, its two-pass route, its tile route
  without the cap on narrow tiles, its tiles chosen by the two-block
  footprint alone, and the other checkout: where each choice pays;
- by part, at r15 (u8 and f32 frames, a u8 shard block): the time each of
  the tile kernel's steps adds (the full kernel's time less the time of a
  copy that skips it; those copies compute garbage).

Run from the repository root on a CUDA card, with the other checkout
unpacked into a directory that .gitignore lists, e.g. the parent commit:

    mkdir -p _tree_check/parent
    git archive HEAD~1 | tar -x -C _tree_check/parent
    python3 tools/stencil_ab.py _tree_check/parent
"""

from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpuimg_torch import kernels  # noqa: E402
from tpuimg_torch.core.timing import card_label, time_cuda  # noqa: E402
from tpuimg_torch.kernels.sep_stencil import (  # noqa: E402
    MORPH_DTYPES, gaussian_kernel, gaussian_plain, gaussian_ypadded_kernel,
    gaussian_ypadded_plain, morph_ypadded_kernel, morph_ypadded_plain,
    morphology_kernel, morphology_plain, open_close_kernel, open_close_plain)
from tpuimg_torch.ops.gaussian import gaussian_ypadded  # noqa: E402
from tpuimg_torch.ops.morphology import morph_ypadded  # noqa: E402
from tpuimg_torch.parallel import (  # noqa: E402
    enhance_sharded, make_mesh, stencil_sharded)
from tpuimg_torch.pipeline import enhance  # noqa: E402

OUT = kernels.BUILD_DIR / "stencil_ab"
ITERS = 30
# copies of this checkout's morphology.cu: name -> (statement, replacement)
ROUTES = {
    "two-pass": ("  int tile = morph_tile(r, sizeof(T));", "  int tile = 0;"),
    "uncapped": ("  return t < kWideTile && r > kNarrowMaxRadius ? 0 : t;",
                 "  return t;"),
    "two-block": ("    if (2 * eb * eb * pair * pair < ep * ep * big * big) "
                  "t = big;", "    if (false) t = big;"),
}
PARTS = {
    "staging": ("    stage_extent<T, kMin>(src + z * in_plane,",
                "    if (false) stage_extent<T, kMin>(src + z * in_plane,"),
    "row pass": ("    window_pass<kMin, T>(A, pa, 1, B, pb, 1, g.e, tile, k);",
                 "    if (false) window_pass<kMin, T>(A, pa, 1, B, pb, 1, "
                 "g.e, tile, k);"),
    "column pass": ("    window_pass<kMin, U>(reinterpret_cast<const U*>(B),",
                    "    if (false) window_pass<kMin, U>("
                    "reinterpret_cast<const U*>(B),"),
    "tile out": ("      write_out(A + i * pb, cols,",
                 "      if (false) write_out(A + i * pb, cols,"),
}
SWEEP = {torch.uint8: [15, 32, 48, 64, 80, 96, 112, 128, 144, 160, 176, 191,
                       192, 200, 226],
         torch.float32: [15, 32, 48, 64, 80, 96, 97, 108]}


def build(csrc: Path, name: str, edit=None, only=None) -> Path:
    """The sources of ``csrc`` (``only`` those, with errors.cu; ``edit``
    made in morphology.cu), one nvcc a source, side by side, linked into
    OUT/lib_<name>.so."""
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    if edit is not None:
        path = src / "morphology.cu"
        text = path.read_text()
        if edit[0] not in text:
            raise SystemExit(f"stencil_ab: morphology.cu changed: {edit[0]!r}")
        path.write_text(text.replace(*edit))
    cus = sorted(p for p in src.glob("*.cu")
                 if only is None or p.name in (only, "errors.cu"))
    objs = [str(src / f"{p.stem}.o") for p in cus]
    kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-c", "-o", o,
                       str(p)] for p, o in zip(cus, objs)])
    lib = OUT / f"lib_{name.replace(' ', '_')}.so"
    kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                       str(lib), *objs]])
    return lib


# C arguments that this checkout's wrappers pass and an older checkout's
# entries lack: entry -> (argument, its index in the argument list, the value
# the older entry had fixed)
ADDED_ARGS = {"tpuimg_clahe_map": ("scale", 12, 1.0),
              "tpuimg_enhance_tail": ("out_u8", 8, 0),
              "tpuimg_enhance_tail_clahe": ("out_u8", 16, 0)}


def entry_params(csrc: Path, entry: str) -> str:
    """The parameter list of C entry ``entry`` in the sources of ``csrc``."""
    for src in csrc.glob("*.cu"):
        text = src.read_text()
        if f"int {entry}(" in text:
            start = text.index(f"int {entry}(") + len(entry) + 5
            return text[start:text.index(")", start)]
    return ""


class OlderEntries:
    """Another checkout's library, called through this checkout's wrappers:
    where one of its entries lacks an argument of ADDED_ARGS, a call drops
    that argument if it holds the value the entry had fixed, and refuses any
    other."""

    def __init__(self, lib, csrc: Path):
        self._lib = lib
        self._drop = {}
        for entry, (arg, pos, fixed) in ADDED_ARGS.items():
            if arg not in entry_params(csrc, entry):
                args = list(kernels._SIGNATURES[entry])
                getattr(lib, entry).argtypes = args[:pos] + args[pos + 1:]
                self._drop[entry] = (arg, pos, fixed)

    def lacks(self, arg: str) -> bool:
        return any(a == arg for a, _, _ in self._drop.values())

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._drop:
            return fn
        arg, pos, fixed = self._drop[name]

        def call(*args):
            if args[pos] != fixed:
                raise ValueError(f"the other checkout's {name} has no {arg}: "
                                 f"it takes {fixed} only")
            return fn(*args[:pos], *args[pos + 1:])

        return call


def bind_other(csrc: Path) -> OlderEntries:
    """Build and load another checkout's kernels (``csrc``)."""
    return OlderEntries(kernels.bind(build(csrc, "other"), missing_ok=True),
                        csrc)


def host_ms(fn, *args, calls: int = 20) -> float:
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def same(got, ref) -> bool:
    """Equal values, NaNs in the same places."""
    if got.is_floating_point():
        nan = torch.isnan(ref)
        if not torch.equal(torch.isnan(got), nan):
            return False
        got, ref = got[~nan], ref[~nan]
    return torch.equal(got, ref)


def cases(dev):
    """(label, call, plain version or None) at the main paths' shapes."""
    g = np.random.default_rng(0)
    f4k = torch.from_numpy(g.random((2160, 3840), dtype=np.float32)).to(dev)
    f1080 = f4k[:1080, :1920].contiguous()
    blk = torch.from_numpy(g.random((576, 3840), dtype=np.float32)).to(dev)
    u4k = torch.from_numpy(g.integers(0, 256, (2160, 3840),
                                      dtype=np.uint8)).to(dev)
    u1080 = u4k[:1080, :1920].contiguous()
    ublk = u4k[:570].contiguous()
    u2 = torch.from_numpy(g.integers(0, 256, (2, 2160, 3840),
                                     dtype=np.uint8)).to(dev)
    u8k = torch.from_numpy(g.integers(0, 256, (4320, 7680),
                                      dtype=np.uint8)).to(dev)
    f2 = u2.float() * (1.0 / 255.0)
    m14 = make_mesh(1, 4, devices=[dev] * 4)
    m24 = make_mesh(2, 4, devices=[dev] * 8)
    sharded = enhance_sharded(m14)
    out = [
        ("gaussian r2 2160x3840", lambda: gaussian_kernel(f4k, 2, 1.5),
         lambda: gaussian_plain(f4k, 2, 1.5)),
        ("gaussian r2 1080x1920", lambda: gaussian_kernel(f1080, 2, 1.5),
         lambda: gaussian_plain(f1080, 2, 1.5)),
        ("gaussian_ypadded r2 576x3840 -> 572",
         lambda: gaussian_ypadded_kernel(blk, 2, 1.5),
         lambda: gaussian_ypadded_plain(blk, 2, 1.5)),
        ("erode u8 r15 2160x3840", lambda: morphology_kernel(u4k, 15, 0),
         lambda: morphology_plain(u4k, 15, 0)),
        ("erode u8 r1 2160x3840", lambda: morphology_kernel(u4k, 1, 0),
         lambda: morphology_plain(u4k, 1, 0)),
        ("erode u8 r15 1080x1920", lambda: morphology_kernel(u1080, 15, 0),
         lambda: morphology_plain(u1080, 15, 0))]
    f4ku = u4k.float()
    fblk = ublk.float()
    out += [
        ("dilate f32 r15 2160x3840", lambda: morphology_kernel(f4ku, 15, 1),
         lambda: morphology_plain(f4ku, 15, 1)),
        ("morph_ypadded erode u8 r15 570x3840 -> 540",
         lambda: morph_ypadded_kernel(ublk, 15, 0),
         lambda: morph_ypadded_plain(ublk, 15, 0)),
        ("morph_ypadded dilate f32 r15 570x3840 -> 540",
         lambda: morph_ypadded_kernel(fblk, 15, 1),
         lambda: morph_ypadded_plain(fblk, 15, 1)),
        ("open_close open u8 r15 2x2160x3840",
         lambda: open_close_kernel(u2, 15, 0),
         lambda: open_close_plain(u2, 15, 0)),
        ("enhance staged 2160x3840", lambda: enhance(u4k, impl="staged"),
         None),
        ("enhance_sharded (1, 4) 2160x3840", lambda: sharded(u4k), None),
        ("enhance_sharded (1, 4) 4320x7680", lambda: sharded(u8k), None),
        ("stencil_sharded gaussian r2 2x2160x3840 (2, 4)",
         lambda: stencil_sharded(lambda p: gaussian_ypadded(p, 2, 1.5), 2,
                                 "reflect101", m24)(f2), None),
        ("stencil_sharded erode u8 r15 2x2160x3840 (2, 4)",
         lambda: stencil_sharded(lambda p: morph_ypadded(p, 15, 0), 15,
                                 "replicate", m24)(u2), None)]
    return out, u4k


def erode_direct(lib, x, r, ypadded=False):
    """One call of a C entry, scratch given, so the library's own route
    choice decides; ``ypadded``: x is a block of its h + 2r rows."""
    h, w = x.shape
    h -= 2 * r if ypadded else 0
    out = torch.empty((h, w), dtype=x.dtype, device=x.device)
    scratch = torch.empty_like(x)
    entry = (lib.tpuimg_morphology_ypadded if ypadded
             else lib.tpuimg_morphology)
    err = entry(x.data_ptr(), 1, h, w, MORPH_DTYPES[x.dtype], r, 0,
                scratch.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tpuimg_morphology: CUDA error {err}")
    return out


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve() / "tpuimg_torch" / "csrc"
    card = card_label()
    print(card)
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {"this": kernels.bind(build(kernels.CSRC, "this")),
            "other": bind_other(other)}
    copies = {name: kernels.bind(build(kernels.CSRC, name, edit,
                                       "morphology.cu"), missing_ok=True)
              for name, edit in {**ROUTES, **PARTS}.items()}
    dev = torch.device("cuda")
    runs, u4k = cases(dev)
    for name in ("this", "other"):
        kernels._lib = libs[name]
        for label, call, plain in runs:
            if plain is not None and not same(call(), plain()):
                raise SystemExit(f"stencil_ab: {label} ({name}) differs "
                                 f"from its plain version")
    torch.cuda.synchronize()
    print("each kernel of both checkouts equals its plain version")
    for label, call, _ in runs:
        t = {"this": [], "other": []}
        for name in ("other", "this", "this", "other"):
            kernels._lib = libs[name]
            t[name].append(time_cuda(call, iters=ITERS, card=card).ms)
        line = (f"this {t['this'][0]:.4f} / {t['this'][1]:.4f} ms, other "
                f"{t['other'][0]:.4f} / {t['other'][1]:.4f} ms")
        if label.startswith("enhance_sharded"):
            host = {}
            for name in ("other", "this"):
                kernels._lib = libs[name]
                host[name] = host_ms(call)
            line += (f"; host clock this {host['this']:.4f}, other "
                     f"{host['other']:.4f} ms a call")
        print(f"AB {label}: {line}, median of {ITERS} [{card}]", flush=True)

    routes = {"this": libs["this"], **{k: copies[k] for k in ROUTES},
              "other": libs["other"]}
    for dtype, radii in SWEEP.items():
        x = u4k.to(dtype)
        for r in radii:
            outs = {k: erode_direct(lib, x, r) for k, lib in routes.items()}
            if not all(same(v, outs["this"]) for v in outs.values()):
                raise SystemExit(f"stencil_ab: erode {dtype} r{r} differs "
                                 f"between the routes")
            t = {k: time_cuda(erode_direct, lib, x, r, iters=10,
                              card=card).ms for k, lib in routes.items()}
            print(f"SWEEP erode {dtype} r{r} 2160x3840, ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                  + f", median of 10 [{card}]", flush=True)

    for label, x, ypadded in (("u8 2160x3840", u4k, False),
                              ("f32 2160x3840", u4k.float(), False),
                              ("u8 570x3840 -> 540", u4k[:570].contiguous(),
                               True)):
        full = time_cuda(erode_direct, libs["this"], x, 15, ypadded,
                         iters=ITERS, card=card).ms
        adds = {part: full - time_cuda(erode_direct, copies[part], x, 15,
                                       ypadded, iters=ITERS, card=card).ms
                for part in PARTS}
        print(f"PARTS erode r15 {label}: kernel {full:.4f} ms; each part "
              "adds " + ", ".join(f"{k} {v:.4f}" for k, v in adds.items())
              + f"; the rest {full - sum(adds.values()):.4f}, median of "
              f"{ITERS} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
