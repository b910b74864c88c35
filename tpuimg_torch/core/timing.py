"""Timing on the card with CUDA events (port of ``tpuimg.core.timing``).

Warm-up calls, then one event pair around each of ``iters`` calls on the
current stream; the result is the median. The calls are queued behind a
device-side spin, so the host's launch overhead between calls does not show
in the events: each pair brackets the device time of one call. The TPU
streaming protocol and its v5e bandwidth constant have no counterpart here.
Every result carries the card's name and power limit, because a card set
below its maximum power runs slower under load.
"""

from __future__ import annotations

import statistics
import subprocess
from dataclasses import dataclass

import torch

# about 0.1 s of spinning at the H100's clock: longer than the host takes to
# queue the timed calls of any op here
_QUEUE_CYCLES = 200_000_000


def card_label() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@dataclass
class Timing:
    ms: float  # median over iters
    ms_min: float
    iters: int
    card: str


def time_cuda(fn, *args, warmup: int = 3, iters: int = 20,
              card: str | None = None) -> Timing:
    """Median device time of ``fn(*args)`` in ms. Fails without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device; no CPU fallback")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(_QUEUE_CYCLES)
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in pairs]
    return Timing(ms=statistics.median(ms), ms_min=min(ms), iters=iters,
                  card=card if card is not None else card_label())
