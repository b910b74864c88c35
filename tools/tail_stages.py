"""Where the enhance tail kernel's time goes, part by part, on the card.

Builds copies of ``tpuimg_torch/csrc/enhance_tail.cu`` and the headers it
includes in which one part of the kernel is skipped (the walker's stages in
``walker.cuh``, the producer's in ``enhance_tail.cuh``), times each copy at
4K (r8, rg2, the enhance defaults, q stored as u8 as enhance stores it) with
CUDA events, and prints the time each
part adds: the full kernel's time less the time without it. The skipped
copies compute garbage; only their times are read. The walker's stages run
one after another between barriers, but the producer's parts share their
phases with other threads' work, so the parts need not add up to the whole.

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

TAIL, WALK = "enhance_tail.cuh", "walker.cuh"
# part -> the edits that skip it: (the file, the statement that opens it,
# what replaces it)
PARTS = {
    "gaussian column pass (beside and after stage 4)": [(
        TAIL, "    if (f0 < 0) f0 += g.lf;\n",
        "    return;\n    if (f0 < 0) f0 += g.lf;\n")],
    "gaussian row pass (in stage 1)": [(
        TAIL, "      gauss_rows([&](int j, int d) { return t[j * g.tf + d]; }, pc);",
        "      for (int j = 0; j < kRows; ++j) pc[j] = t[j * g.tf];")],
    "f row copies (after stage 4)": [(
        TAIL, "          for (int c = lane; c < g.tf; c += 32) {\n"
        "            walker::cp_async4",
        "          for (int c = lane; c < 0; c += 32) {\n"
        "            walker::cp_async4")],
    "p ring stores and copies": [
        (TAIL, "    gp[ps * g.ti + c] = pe;",
         "    if (ps < 0) gp[ps * g.ti + c] = pe;"),
        (TAIL, "        for (int c = 4 * lane; c < g.ti; c += 128) {",
         "        for (int c = 4 * lane; c < 0; c += 128) {")],
    "stage 1 (vertical sums)": [(
        WALK, "    for (int c = tid; c < ti; c += kWalkThreads) {",
        "    if (false) for (int c = tid; c < ti; c += kWalkThreads) {")],
    "stage 2 (row sums)": [(
        WALK, "    {\n      const int m = tid % pairs_v",
        "    if (false) {\n      const int m = tid % pairs_v")],
    "stage 2 (a and b)": [(
        WALK, "    {\n      const int u = s * kRows + warp;",
        "    if (false) {\n      const int u = s * kRows + warp;")],
    "stage 3 (row sums of a, b)": [(
        WALK, "    {\n      const int m = tid % pairs_ab",
        "    if (false) {\n      const int m = tid % pairs_ab")],
    "stage 4 (column sums, q)": [(
        WALK, "    if (tid < kStrip) {\n      const int x = x0 + tid;",
        "    if (false) {\n      const int x = x0 + tid;")],
}
SHAPE, RG, SIGMA, R, EPS = (2160, 3840), 2, 1.5, 8, 1e-3


def build(out: Path) -> dict:
    """A library for the full kernel and one for each part skipped."""
    procs = {}
    for i, name in enumerate(["full kernel", *PARTS]):
        d = out / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in kernels.CSRC.iterdir():
            if src.suffix in (".cu", ".cuh"):
                (d / src.name).write_text(src.read_text())
        for file, old, new in PARTS.get(name, []):
            text = (d / file).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{file} changed: no single {old.strip()!r}")
            (d / file).write_text(text.replace(old, new))
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

    floats = libs["full kernel"].tpuimg_enhance_tail_scratch_floats(
        h, w, RG, R)
    scratch = torch.empty(floats, dtype=torch.float32, device="cuda")

    def call(lib):
        err = lib.tpuimg_enhance_tail(
            f.data_ptr(), h, w, tp, RG, R, EPS, scratch.data_ptr(), 1,
            q.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    ms = {name: time_cuda(call, lib, iters=30, card=card).ms
          for name, lib in libs.items()}
    full = ms["full kernel"]
    parts = [f"{name} {full - ms[name]:.4f}" for name in PARTS]
    print(f"enhance_tail {h}x{w} r{R} rg{RG}: full kernel {full:.4f} ms; each "
          f"part adds " + ", ".join(parts) + f", median of 30 [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
