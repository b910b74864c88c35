"""The integral scan and the guided-filter kernels of this checkout against
another checkout's, in one process on one card.

Each checkout's kernels are built from its own ``tpuimg_torch/csrc`` into a
library of their own (``tools/stencil_ab.py``'s build); every call goes
through this checkout's wrappers with one library or the other swapped in,
so the two differ only in their CUDA code. Checks first: the integral equals
its plain version bit for bit and twopass stays within 1e-4 of its plain
version, in both checkouts; the kernels that share the guided walker (the
onepass frame and row-padded entries, self-guided and general, and both
enhance tails) give the same bits in both checkouts, and the SHA-256 of
each output is printed. Then each call is timed with CUDA events in turns
(other, this, this, other): the integral at 4K, 1080p and on 16 frames of
1080p, twopass r8 at 4K and 1080p, the onepass entries and the tails at the
shapes of ``chip_smoke.py``'s main paths; and the profiler splits the
integral and twopass into their launches, in each checkout.

Run from the repository root on a CUDA card, with the other checkout
unpacked into a directory that .gitignore lists, e.g. the parent commit:

    mkdir -p _tree_check/parent
    git archive HEAD~1 | tar -x -C _tree_check/parent
    python3 tools/scan_guided_ab.py _tree_check/parent
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from stencil_ab import bind_other, build  # noqa: E402
from tpuimg_torch import kernels  # noqa: E402
from tpuimg_torch.core.timing import card_label, time_cuda  # noqa: E402
from tpuimg_torch.kernels.boxsum import (  # noqa: E402
    enhance_tail, enhance_tail_clahe, guided_filter_kernel,
    guided_filter_plain, guided_ypadded_kernel)
from tpuimg_torch.kernels.hist import tile_hist_plain  # noqa: E402
from tpuimg_torch.kernels.scan2d import (  # noqa: E402
    integral_kernel, integral_plain)
from tpuimg_torch.ops.histogram import (  # noqa: E402
    _clahe_geometry, _clahe_tables)

ITERS = 30
R, EPS, RG, SIGMA = 8, 1e-3, 2, 1.5  # enhance's defaults


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def split(fn, calls: int = 10) -> str:
    """Device ms a call by kernel name over ``calls`` traced calls; a kernel
    that starts before the one ahead of it ends (a dependent launch waiting
    on it) counts from that end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    by_name, done = {}, kern[0].time_range.start
    for e in kern:
        name = e.name.removeprefix("void ")
        name = name.removeprefix("(anonymous namespace)::").split("(")[0]
        own = max(0, e.time_range.end - max(e.time_range.start, done))
        done = max(done, e.time_range.end)
        by_name[name] = by_name.get(name, 0) + own
    return "; ".join(f"{k} {v / calls / 1e3:.4f}" for k, v in
                     sorted(by_name.items(), key=lambda kv: -kv[1]))


def cases(dev):
    """(label, call, check) at the main paths' shapes; check(out) -> the
    error against the plain version (None: compared across checkouts)."""
    g = np.random.default_rng(0)
    u4k = torch.from_numpy(g.integers(0, 256, (2160, 3840),
                                      dtype=np.uint8)).to(dev)
    u1080 = u4k[:1080, :1920].contiguous()
    u16 = torch.from_numpy(g.integers(0, 256, (16, 1080, 1920),
                                      dtype=np.uint8)).to(dev)
    I4k = torch.from_numpy(g.random((2160, 3840), dtype=np.float32)).to(dev)
    p4k = torch.clamp(I4k + 0.1 * torch.from_numpy(g.standard_normal(
        (2160, 3840)).astype(np.float32)).to(dev), 0, 1)
    I1080, p1080 = (x[:1080, :1920].contiguous() for x in (I4k, p4k))
    blk, pblk = (x[:572].contiguous() for x in (I4k, p4k))
    th, tw, pt, pl = _clahe_geometry(2160, 3840, 8, 8)
    tables = _clahe_tables(tile_hist_plain(u4k, 8, 8, th, tw, pt, pl), 2.0,
                           th, tw)

    def exact(x):
        return lambda out: 0.0 if torch.equal(out, integral_plain(x)) else 1.0

    def near(I, p):
        ref = guided_filter_plain(I, p, R, EPS)
        return lambda out: float((out - ref).abs().max())

    return [
        ("integral 2160x3840", lambda: integral_kernel(u4k), exact(u4k)),
        ("integral 1080x1920", lambda: integral_kernel(u1080), exact(u1080)),
        ("integral 16x1080x1920", lambda: integral_kernel(u16), exact(u16)),
        ("twopass r8 2160x3840",
         lambda: guided_filter_kernel(I4k, p4k, R, EPS, variant="twopass"),
         near(I4k, p4k)),
        ("twopass r8 1080x1920",
         lambda: guided_filter_kernel(I1080, p1080, R, EPS,
                                      variant="twopass"),
         near(I1080, p1080)),
        ("onepass general r8 2160x3840",
         lambda: guided_filter_kernel(I4k, p4k, R, EPS), None),
        ("onepass self r8 2160x3840",
         lambda: guided_filter_kernel(I4k, I4k, R, EPS, self_guided=True),
         None),
        ("guided_ypadded general r8 572x3840 -> 540",
         lambda: guided_ypadded_kernel(blk, pblk, R, EPS), None),
        ("guided_ypadded self r8 572x3840 -> 540",
         lambda: guided_ypadded_kernel(blk, blk, R, EPS, self_guided=True),
         None),
        ("enhance_tail 2160x3840",
         lambda: enhance_tail(I4k, RG, SIGMA, R, EPS), None),
        ("enhance_tail_clahe 2160x3840",
         lambda: enhance_tail_clahe(u4k, tables, 8, 8, th, tw, pt, pl, RG,
                                    SIGMA, R, EPS), None),
    ]


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve() / "tpuimg_torch" / "csrc"
    card = card_label()
    print(card)
    libs = {"this": kernels.bind(build(kernels.CSRC, "this")),
            "other": bind_other(other)}
    runs = cases(torch.device("cuda"))
    for label, call, check in runs:
        outs = {}
        for name in ("this", "other"):
            kernels._lib = libs[name]
            outs[name] = call()
            if check is not None and check(outs[name]) > 1e-4:
                raise SystemExit(f"scan_guided_ab: {label} ({name}) is "
                                 f"{check(outs[name])} from its plain version")
        torch.cuda.synchronize()
        same = torch.equal(outs["this"], outs["other"])
        if check is None and not same:
            raise SystemExit(f"scan_guided_ab: {label} differs between the "
                             f"checkouts")
        print(f"CHECK {label}: this and other "
              f"{'equal' if same else 'differ'}; sha256 this "
              f"{digest(outs['this'])}, other {digest(outs['other'])}",
              flush=True)
    for label, call, _ in runs:
        t = {"this": [], "other": []}
        for name in ("other", "this", "this", "other"):
            kernels._lib = libs[name]
            t[name].append(time_cuda(call, iters=ITERS, card=card).ms)
        print(f"AB {label}: this {t['this'][0]:.4f} / {t['this'][1]:.4f} "
              f"ms, other {t['other'][0]:.4f} / {t['other'][1]:.4f} ms, "
              f"median of {ITERS} [{card}]", flush=True)
    for label, call, _ in runs[:5]:
        for name in ("this", "other"):
            kernels._lib = libs[name]
            print(f"SPLIT {label} ({name}), device ms a call: {split(call)} "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
