"""Variants of the tile-histogram and gather kernels against the committed
ones, in one process on one card.

Each variant is a copy of ``tpuimg_torch/csrc`` with one or two constants
of ``tile_hist.cu`` or ``lut_gather.cu`` changed (and, where the grid plan
must follow, the matching constant of ``kernels/hist.py`` or
``kernels/lut.py``), built into a library of its own under
``tpuimg_torch/_build/variants``; every call goes through this checkout's
wrappers with one library or the other swapped in. Each output is checked
bit for bit against the plain version, then each call is timed with CUDA
events in turns (committed, variant, variant, committed) and split into
device time by the profiler. An edited statement that is no longer in the
source stops the tool with "changed".

Run from the repository root on a CUDA card (an argument keeps only the
variants and calls whose names start with it, e.g. ``tile_hist``):

    python3 tools/tile_lut_variants.py [tile_hist|lut_gather]
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import gather_tables, make_frame  # noqa: E402
from scan_guided_ab import split  # noqa: E402
from tpuimg_torch import kernels  # noqa: E402
from tpuimg_torch.core.timing import card_label, time_cuda  # noqa: E402
from tpuimg_torch.kernels import hist as khist  # noqa: E402
from tpuimg_torch.kernels import lut as klut  # noqa: E402
from tpuimg_torch.ops.histogram import _clahe_geometry, _he_tables  # noqa: E402

ITERS = 30
OUT = kernels.BUILD_DIR / "variants"

# block b takes steps b, b + blocks, ... of kChunks chunks, not one range
INTERLEAVED = [
    ("""  const long long c0 = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = min(total, min(chunks, c0 + per_block) * kChunk);""",
     """  const long long step = static_cast<long long>(gridDim.x) * kChunks *
                         kChunk;"""),
    ("""  for (long long p0 = c0 * kChunk; p0 < end; p0 += kChunks * kChunk) {""",
     """  for (long long p0 = static_cast<long long>(blockIdx.x) * kChunks *
                      kChunk; p0 < total; p0 += step) {
    const long long end = min(total, p0 + kChunks * kChunk);"""),
]
# the table staged before a step's loads are issued, not after
STAGE = """    if (staging) {
      const long long f = tstride == 0 ? 0 : p0 / n;
      if (f != staged) {
        stage(tables + f * tstride, raw, tab);
        staged = f;
        if (tstride != 0) lo = f * n, hi = lo + n;
      }
    }
"""
STAGED_FIRST = [
    ("    // the step's loads are in flight while the table is staged\n" + STAGE,
     ""),
    ("    uint4 in[kUnits];\n", STAGE + "    uint4 in[kUnits];\n"),
]
# name -> (source, [(statement, replacement)], {(module, name): value})
VARIANTS = {
    "tile_hist 1 load ahead": (
        "tile_hist.cu", [("constexpr int kAhead = 2;",
                          "constexpr int kAhead = 1;")], {}),
    "tile_hist 4 loads ahead": (
        "tile_hist.cu", [("constexpr int kAhead = 2;",
                          "constexpr int kAhead = 4;")], {}),
    "tile_hist 8 loads ahead": (
        "tile_hist.cu", [("constexpr int kAhead = 2;",
                          "constexpr int kAhead = 8;")], {}),
    "tile_hist zeroed by the block before a barrier": (
        "tile_hist.cu", [(
            """  int* hist = sub + (tid >> 5) * 256;  // this warp's own: no block barrier
  for (int i = tid & 31; i < 256; i += 32) hist[i] = 0;
  __syncwarp();
""", """  int* hist = sub + (tid >> 5) * 256;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) sub[k * 256 + tid] = 0;
  __syncthreads();
""")], {}),
    # a timing probe: one atomic a 16-byte load in place of sixteen
    "tile_hist probe with one atomic a load": (
        "tile_hist.cu", [("""        count_word(v[u].x, hist);
        count_word(v[u].y, hist);
        count_word(v[u].z, hist);
        count_word(v[u].w, hist);""", """        atomicAdd(&hist[(v[u].x ^ v[u].y ^ v[u].z ^ v[u].w) & 0xFFu], 1);""")],
        {}),
    # a timing probe: every block writes its own sums, no cluster exchange
    "tile_hist probe without the cluster exchange": (
        "tile_hist.cu", [("  if (cs == 1) {\n    dst[tid] = v;",
                          "  if (true) {\n    dst[tid] = v;"),
                         ("""  if (cs > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
""", "")], {}),
    "tile_hist two barriers, bins summed by slice": (
        "tile_hist.cu", [("""  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  cluster.map_shared_rank(slots, 0)[rank * 256 + tid] = v;
  cluster.sync();  // every block's sums are in rank 0's slots
  if (rank == 0) {  // the others leave: no block reads a peer's memory now
    int s = 0;
    for (int q = 0; q < cs; ++q) s += slots[q * 256 + tid];
    dst[tid] = s;
  }""", """  sub[tid] = v;
  cluster.sync();
  const int lo = rank * 256 / cs, hi = (rank + 1) * 256 / cs;
  if (tid < hi - lo) {
    int s = 0;
    for (int q = 0; q < cs; ++q) s += cluster.map_shared_rank(sub, q)[lo + tid];
    dst[lo + tid] = s;
  }
  cluster.sync();"""), ("""  if (cs > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
""", "")], {}),
    "lut_gather u8 256 chunks a step": (
        "lut_gather.cu", [("constexpr int kChunks = 512;",
                           "constexpr int kChunks = 256;")],
        {(klut, "LUT_ITER_CHUNKS"): 256}),
    "lut_gather steps interleaved over blocks": (
        "lut_gather.cu", INTERLEAVED, {}),
    "lut_gather table staged before the step's loads": (
        "lut_gather.cu", STAGED_FIRST, {}),
    # a timing probe, not a design: the gather with its lookups left out
    # (it stores its input), whose bits differ from the plain version's
    "lut_gather u8 probe without lookups": (
        "lut_gather.cu", [("""        r = make_uint4(look4(t, in[u].x), look4(t, in[u].y),
                       look4(t, in[u].z), look4(t, in[u].w));""",
                           """        r = in[u];""")], {}),
    "lut_gather 8 blocks an SM": (
        "lut_gather.cu", [("kBlocksPerSm = 4;", "kBlocksPerSm = 8;")],
        {(klut, "LUT_BLOCKS_PER_SM"): 8}),
}


def build(name: str, source: str, edits) -> ctypes.CDLL:
    """A copy of csrc with ``edits`` made in ``source``, that source (and
    errors.cu) compiled into a library of its own; its ptxas lines that
    report spills are printed."""
    d = OUT / name.replace(" ", "_")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(kernels.CSRC, d)
    text = (d / source).read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"tile_lut_variants: {source} changed: {old!r}")
        text = text.replace(old, new)
    (d / source).write_text(text)
    cus = [d / source, d / "errors.cu"]
    objs = [str(c.with_suffix(".o")) for c in cus]
    log = kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-c", "-o",
                             o, str(c)] for c, o in zip(cus, objs)])
    lib = d / "lib.so"
    kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                       str(lib), *objs]])
    spills = {line.strip() for line in log.splitlines()
              if "spill" in line and " 0 bytes spill stores" not in line}
    for line in sorted(spills):
        print(f"  {name}: {line}")
    return kernels.bind(lib, missing_ok=True)


def device(fn) -> str:
    """The profiler's device ms a call by kernel; a trace that caught no
    kernel (it happens now and then) is taken again."""
    for _ in range(3):
        try:
            return split(fn)
        except IndexError:
            pass
    return "no kernel traced"


def bits(t):
    return t.view({1: torch.uint8, 4: torch.int32}[t.element_size()])


def calls(dev) -> list:
    """(label, call, plain output) at the shapes PERF.md reports."""
    frames = {s: torch.from_numpy(make_frame(*s, 0)).to(dev)
              for s in ((2160, 3840), (1080, 1920))}
    out = []
    for (h, w), tiles in (((2160, 3840), 8), ((2160, 3840), 64),
                          ((2160, 3840), 2), ((1080, 1920), 8)):
        args = (frames[(h, w)], tiles, tiles,
                *_clahe_geometry(h, w, tiles, tiles))
        out.append((f"tile_hist {h}x{w} tiles {tiles}",
                    functools.partial(khist.tile_hist, *args),
                    khist.tile_hist_plain(*args)))
    f32 = gather_tables(97)[2].to(dev)
    for (h, w), img in frames.items():
        u8 = _he_tables(khist.hist256_groups_plain(img.reshape(1, -1))[0],
                        h * w)
        for kind, table in (("u8", u8), ("f32", f32)):
            out.append((f"lut_gather {kind} {h}x{w}",
                        functools.partial(klut.lut_gather, table, img),
                        klut.lut_gather_plain(table, img)))
    stack = torch.from_numpy(np.stack([make_frame(1080, 1920, 5 + i)
                                       for i in range(16)])).to(dev)
    tables = _he_tables(khist.hist256_groups_plain(stack), 1080 * 1920)
    out.append(("lut_gather_frames 16x1080x1920",
                functools.partial(klut.lut_gather_frames, tables, stack),
                klut.lut_gather_frames_plain(tables, stack)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    card = card_label()
    print(card)
    base = kernels.load()
    only = sys.argv[1] if len(sys.argv) > 1 else ""
    libs = {name: build(name, src, edits)
            for name, (src, edits, _) in VARIANTS.items()
            if name.startswith(only)}

    def run(name, fn):
        kernels._lib = base if name == "committed" else libs[name]
        saved = {}
        for (mod, attr), value in (VARIANTS[name][2] if name in libs
                                   else {}).items():
            saved[(mod, attr)] = getattr(mod, attr)
            setattr(mod, attr, value)
        try:
            return fn()
        finally:
            for (mod, attr), value in saved.items():
                setattr(mod, attr, value)
            kernels._lib = base

    for label, fn, ref in calls(torch.device("cuda")):
        if not label.startswith(only):
            continue
        if label.startswith("lut_gather"):  # the same bytes, one copy_
            src = fn.args[-1]
            dst = torch.empty_like(ref)
            cp = (lambda d=dst, s=src: d.view(torch.uint8).view(
                s.shape + (-1,)).copy_(s[..., None].expand(
                    s.shape + (dst.element_size(),))))
            print(f"COPY {label}: the input read and the output written by "
                  f"one copy_ {time_cuda(cp, iters=ITERS, card=card).ms:.4f}"
                  f" ms (device {device(cp)}), median of {ITERS} [{card}]",
                  flush=True)
        kernel = label.split()[0].replace("_frames", "")
        # the gather's variants are of its u8 kernel
        fits = [n for n in libs if n.startswith(kernel)
                and "f32" not in label]
        for name in ["committed"] + fits:
            got = run(name, fn)
            torch.cuda.synchronize()
            same = torch.equal(bits(got), bits(ref))
            if not same and "probe" not in name:
                raise SystemExit(f"tile_lut_variants: {label} ({name}) "
                                 f"differs from its plain version")
            if name == "committed":
                continue
            t = {"committed": [], name: []}
            for who in ("committed", name, name, "committed"):
                t[who].append(time_cuda(run, who, fn, iters=ITERS,
                                        card=card).ms)
            dev = {who: device(lambda who=who: run(who, fn))
                   for who in ("committed", name)}
            print(f"VARIANT {label}, {name}: {t[name][0]:.4f} / "
                  f"{t[name][1]:.4f} ms (device {dev[name]}), committed "
                  f"{t['committed'][0]:.4f} / {t['committed'][1]:.4f} ms "
                  f"(device {dev['committed']}), median of {ITERS}, bits "
                  f"{'equal to' if same else 'differ from'} plain [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
