"""Frames/s of ``enhance`` on 4K frames that live on the host, four ways,
each driven by the benchmark's closed loop (``bench_torch.harness.drive``)
over a ring of 32 scenes, on the card:

- ``host``: ``enhance_host`` of pinned host frames, 4 in flight, as the
  cell ``enhance-4k-h2d.stream`` runs it;
- ``host-pageable``: the same with pageable frames, staged on the host;
- ``device``: ``enhance`` of frames already on the card, 4 in flight: what
  the copies would cost if they were free;
- ``cli``: the CLI's ``stream`` before ``enhance_host``: a pageable
  ``.to(device)``, ``enhance`` and a blocking ``.cpu()``, a frame at a time.

Each way is warmed up, then timed for ``--seconds``; the ways run in turn,
``--rounds`` times. Run from the repository root on a CUDA card:

    python3 tools/host_frames_ab.py [--seconds 10] [--rounds 2] [--seed 7]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_torch import frames, harness  # noqa: E402
from tpuimg_torch import enhance, enhance_host  # noqa: E402
from tpuimg_torch.core.timing import card_label  # noqa: E402

H, W, RING, IN_FLIGHT = 2160, 3840, 32, 4


def ways(seed: int, device: torch.device) -> dict:
    """Each way's (function, argument tuples, frames in flight)."""
    ring = frames.scene_ring(RING, H, W, seed, device)
    pageable = ring.cpu()
    pinned = pageable.pin_memory()
    return {
        "host": (enhance_host, [(f,) for f in pinned], IN_FLIGHT),
        "host-pageable": (enhance_host, [(f,) for f in pageable], IN_FLIGHT),
        "device": (enhance, [(f,) for f in ring], IN_FLIGHT),
        "cli": (lambda f: enhance(f.to(device)).cpu(),
                [(f,) for f in pageable], 1),
    }


def timed(fn, args, in_flight: int, seconds: float,
          device: torch.device) -> harness.Run:
    marks = harness.Marks(device, in_flight + 1)
    nxt = harness.drive(fn, args, in_flight, marks, harness.Sample(0, 0),
                        count=harness.WARM_FRAMES)
    run = harness.Run({})
    harness.drive(fn, args, in_flight, marks, harness.Sample(0, 0), run,
                  deadline=time.perf_counter() + seconds, first=nxt)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    print(f"{card_label()}; 4K u8, ring {RING}, {a.seconds} s a way")
    cases = ways(a.seed, device)
    for r in range(a.rounds):
        for name, (fn, args, in_flight) in cases.items():
            run = timed(fn, args, in_flight, a.seconds, device)
            print(f"round {r} {name:14s} in flight {in_flight}: "
                  f"{run.frames / run.window_s:9.2f} frames/s, host "
                  f"{run.host_s / run.frames * 1e3:.4f} ms a call",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
