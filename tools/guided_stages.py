"""Where the onepass guided kernel's time goes, stage by stage, on the card.

Builds copies of ``tpuimg_torch/csrc/guided.cu`` and the walker body it
includes (``walker.cuh``) in which chosen stages of the strip walker are
skipped (a compile-time mask, inserted into the copies),
times each copy's onepass entries with CUDA events at the shapes
``chip_smoke.py`` times (4K r8 and a 4K shard's 572x3840 row-padded block,
general and self-guided), and prints the time each stage adds: the full
kernel's time less the time without that stage. The skipped copies compute
garbage; only their times are read. The stages run one after another between
barriers, so the parts add up to about the whole.

Run from the repository root on a CUDA card: ``python3 tools/guided_stages.py``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpuimg_torch import kernels  # noqa: E402
from tpuimg_torch.core.timing import card_label, time_cuda  # noqa: E402

# stage -> (mask bit, the file, the statement that opens it, its guard): the
# walker's stages live in walker.cuh, its staging in guided.cu's producer
STAGES = {
    "stage 1 (vertical sums)": (
        1, "walker.cuh", "    for (int c = tid; c < ti; c += kWalkThreads) {",
        "    if constexpr ((SKIP & 1) == 0)\n"
        "    for (int c = tid; c < ti; c += kWalkThreads) {"),
    "stage 2 (row sums)": (2, "walker.cuh",
                           "    {\n      const int m = tid % pairs_v",
                           "    if constexpr ((SKIP & 2) == 0) {\n"
                           "      const int m = tid % pairs_v"),
    "stage 2 (a and b)": (4, "walker.cuh",
                          "    {\n      const int u = s * kRows + warp;",
                          "    if constexpr ((SKIP & 4) == 0) {\n"
                          "      const int u = s * kRows + warp;"),
    "stage 3 (row sums of a, b)": (8, "walker.cuh",
                                   "    {\n      const int m = tid % pairs_ab",
                                   "    if constexpr ((SKIP & 8) == 0) {\n"
                                   "      const int m = tid % pairs_ab"),
    "stage 4 (column sums, q)": (16, "walker.cuh", "    if (tid < kStrip) {",
                                 "    if ((SKIP & 16) == 0 && tid < kStrip) {"),
    "leaving rows' loads": (32, "walker.cuh",
                            "        if (u >= 0) prod.leaving",
                            "        if ((SKIP & 32) == 0 && u >= 0) "
                            "prod.leaving"),
    "staging (cp.async)": (64, "guided.cu",
                           "      if (s + 1 < steps) stage(s + 1);",
                           "      if ((SKIP & 64) == 0 && s + 1 < steps) "
                           "stage(s + 1);"),
}
MASKS = {"full kernel": 0, **{name: bit for name, (bit, _, _, _) in
                              STAGES.items()},
         "staging and barriers only": 63, "barriers only": 127}
CASES = [  # label, input shape, radius, self-guided, row-padded entry
    ("4K r8 general", (2160, 3840), 8, False, False),
    ("4K r8 self", (2160, 3840), 8, True, False),
    ("572x3840 -> 540 r8 general", (572, 3840), 8, False, True),
    ("572x3840 -> 540 r8 self", (572, 3840), 8, True, True),
]


def skipping(srcs: dict, mask: int) -> dict:
    """Copies of guided.cu and walker.cuh with the stages in ``mask``
    skipped; the guided.cu copy includes the walker.cuh copy."""
    srcs = dict(srcs)
    for _, name, old, new in STAGES.values():
        if srcs[name].count(old) != 1:
            raise SystemExit(f"{name} changed: no single {old.strip()!r}")
        srcs[name] = srcs[name].replace(old, new)
    walker = f"walker_skip{mask}.cuh"
    srcs["guided.cu"] = f"#define SKIP {mask}\n" + srcs["guided.cu"].replace(
        '#include "walker.cuh"', f'#include "{walker}"')
    return {f"guided_skip{mask}.cu": srcs["guided.cu"],
            walker: f"#define SKIP {mask}\n" + srcs["walker.cuh"]}


def build(out: Path) -> dict:
    srcs = {name: (kernels.CSRC / name).read_text()
            for name in ("guided.cu", "walker.cuh")}
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, mask in MASKS.items():
        for name, text in skipping(srcs, mask).items():
            (out / name).write_text(text)
        cu = out / f"guided_skip{mask}.cu"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}",
               "-shared", "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[label] = (cu, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for label, (cu, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {cu.name}:\n{log}")
        lib = ctypes.CDLL(str(cu.with_suffix(".so")))
        for fn in ("tpuimg_guided_onepass", "tpuimg_guided_onepass_ypadded"):
            getattr(lib, fn).argtypes = [P, I, P, I, I, I, I, F, I, P, P]
            getattr(lib, fn).restype = I
        libs[label] = lib
    return libs


def call(lib, I, p, r, self_g, ypad):
    hin, w = I.shape
    h = hin - 4 * r if ypad else hin
    q = torch.empty((h, w), device=I.device)
    fn = (lib.tpuimg_guided_onepass_ypadded if ypad
          else lib.tpuimg_guided_onepass)
    err = fn(I.data_ptr(), 1, p.data_ptr(), 1, h, w, r, 1e-3, int(self_g),
             q.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")
    return q


def main() -> int:
    if not torch.cuda.is_available():
        print("guided_stages: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_label()
    print(card)
    libs = build(kernels.BUILD_DIR / "guided_stages")
    g = np.random.default_rng(0)
    for label, shape, r, self_g, ypad in CASES:
        I = torch.from_numpy(g.random(shape, dtype=np.float32)).cuda()
        p = I if self_g else torch.from_numpy(
            g.random(shape, dtype=np.float32)).cuda()
        ms = {name: time_cuda(call, lib, I, p, r, self_g, ypad, iters=30,
                              card=card).ms for name, lib in libs.items()}
        full = ms["full kernel"]
        parts = [f"{name} {full - ms[name]:.4f}" for name in STAGES]
        line = (f"{label}: full kernel {full:.4f} ms; each stage adds "
                + ", ".join(parts) + f"; staging and barriers only "
                f"{ms['staging and barriers only']:.4f}, barriers only "
                f"{ms['barriers only']:.4f}, median of 30 [{card}]")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
