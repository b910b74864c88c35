"""Where the enhance tail's time goes, walk by walk and part by part, on
the card.

Builds copies of ``tpuimg_torch/csrc/enhance_tail.cu`` and the headers it
includes in which one walk, or one part of a walk, is skipped (the stages
of the two walks in ``enhance_tail.cuh``), times each copy at 4K (r8, rg2,
the enhance defaults, q stored as u8 as enhance stores it) with CUDA events,
and prints the two walks apart (the call with the other walk skipped), the
time each part adds (the full call's time less the time without it), and
the call on walk 1's scratch route, where the leaving rows' I and p live in
a ring of device memory instead of shared memory. The skipped copies compute
garbage; only their times are read. A walk's stages run one after another
between barriers, but the copies share their phases with other work, so the
parts need not add up to the whole.

Run from the repository root on a CUDA card: ``python3 tools/tail_stages.py``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpuimg_torch import kernels  # noqa: E402
from tpuimg_torch.core.timing import card_label, time_cuda  # noqa: E402
from tpuimg_torch.kernels import Taps  # noqa: E402
from tpuimg_torch.kernels.sep_stencil import taps  # noqa: E402

TAIL = "enhance_tail.cuh"
# each walk alone, the call with the other skipped: (the statement that
# opens it, what replaces it)
WALKS = {
    "walk 1 (a and b)": [(
        "  if (err != 0) return err;\n  return p.walk2.route",
        "  return err;\n  return p.walk2.route")],
    "walk 2 (q)": [(
        "  int err;\n  switch (p.walk1.route) {",
        "  int err = 0;\n  if (false) switch (p.walk1.route) {")],
}
# part -> the edits that skip it
PARTS = {
    "walk 1: f row copies (top of the step)": [(
        "        fill(nrow, nslot);", "        (void)nslot;")],
    "walk 1: gaussian column pass (stage 3)": [(
        "    if (s + 1 < steps) column_pass(nb);",
        "    if (false) column_pass(nb);")],
    "walk 1: gaussian row pass (stage 1)": [(
        "      gauss_rows<kRg>(\n          W, rg, [&](int i, int d) "
        "{ return T[i * tf + c + rg + d]; }, pe);",
        "      for (int i = 0; i < kK; ++i) pe[i] = T[i * tf + c + rg];")],
    "walk 1: stage 1 (column sums)": [(
        "    if (tid < ti) {\n      const int c = tid;",
        "    if (false) {\n      const int c = tid;")],
    "walk 1: stage 2 (row sums)": [(
        "    {\n      constexpr int pairs = 4 * kK",
        "    if (false) {\n      constexpr int pairs = 4 * kK")],
    "walk 1: stage 3 (a and b)": [(
        "    for (int e = 0; e < kK * kTpStrip / kTpThreads; ++e) {",
        "    for (int e = 0; e < 0; ++e) {")],
    "walk 2: a and b row copies": [(
        "    if (s + 1 < steps) stage_in(s + 1, next);",
        "    if (false) stage_in(s + 1, next);")],
    "walk 2: stage 1 (column sums)": [(
        "    if (tid < ti) {\n      const float* in = smem + tid + ra - r;",
        "    if (false) {\n      const float* in = smem + tid + ra - r;")],
    "walk 2: stage 2 (row sums)": [(
        "    {\n      constexpr int pairs = 2 * kK",
        "    if (false) {\n      constexpr int pairs = 2 * kK")],
    "walk 2: stage 3 (I and q)": [(
        "      walker::store_q(qz[", "      if (false) walker::store_q(qz[")],
}
# walk 1 on its scratch route at these radii
SCRATCH = {"walk 1's scratch route": [(
    "  return bytes + 4LL * kMaxTaps <= kMaxSmemBytes",
    "  return false && bytes + 4LL * kMaxTaps <= kMaxSmemBytes")]}
SHAPE, RG, SIGMA, R, EPS = (2160, 3840), 2, 1.5, 8, 1e-3


def build(out: Path) -> dict:
    """A library for the full kernel and one for each part skipped."""
    procs = {}
    edits = {**WALKS, **PARTS, **SCRATCH}
    for i, name in enumerate(["full call", *edits]):
        d = out / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in kernels.CSRC.iterdir():
            if src.suffix in (".cu", ".cuh"):
                (d / src.name).write_text(src.read_text())
        for old, new in edits.get(name, []):
            text = (d / TAIL).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{TAIL} changed: no single {old.strip()!r}")
            (d / TAIL).write_text(text.replace(old, new))
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
               str(d / "tail.so"), str(d / "enhance_tail.cu")]
        procs[name] = (d / "tail.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.tpuimg_enhance_tail.argtypes = [P, I, I, Taps, I, I, F, P, I, P,
                                            P]
        lib.tpuimg_enhance_tail.restype = I
        lib.tpuimg_enhance_tail_scratch_floats.argtypes = [I] * 4
        lib.tpuimg_enhance_tail_scratch_floats.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_stages: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_label()
    print(card)
    libs = build(kernels.BUILD_DIR / "tail_stages")
    h, w = SHAPE
    f = torch.from_numpy(np.random.default_rng(0).random(
        SHAPE, dtype=np.float32)).cuda()
    q = torch.empty(SHAPE, dtype=torch.uint8, device="cuda")  # enhance's
    tp = Taps()
    wts = taps(RG, SIGMA)
    tp.w[:len(wts)] = wts

    scratch = {name: torch.empty(
        lib.tpuimg_enhance_tail_scratch_floats(h, w, RG, R),
        dtype=torch.float32, device="cuda") for name, lib in libs.items()}

    def call(name):
        err = libs[name].tpuimg_enhance_tail(
            f.data_ptr(), h, w, tp, RG, R, EPS, scratch[name].data_ptr(), 1,
            q.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    ms = {name: time_cuda(call, name, iters=30, card=card).ms
          for name in libs}
    full = ms["full call"]
    print(f"enhance_tail {h}x{w} r{R} rg{RG} u8, median of 30 [{card}]")
    print(f"  full call {full:.4f} ms; alone: " + ", ".join(
        f"{name} {ms[name]:.4f}" for name in WALKS))
    print("  each part adds: " + ", ".join(
        f"{name} {full - ms[name]:.4f}" for name in PARTS))
    print("  " + ", ".join(f"{name} {ms[name]:.4f} ms" for name in SCRATCH))
    return 0


if __name__ == "__main__":
    sys.exit(main())
