"""Timing: CUDA events on the card, the host clock on the CPU (port of
``tpuimg.core.timing``).

``time_cuda``: warm-up calls, then one event pair around each of ``iters``
calls on the current stream; the result is the median. The calls are
queued behind a device-side spin, so the host's launch overhead between
calls does not show in the events: each pair brackets the device time of
one call. The TPU streaming protocol and its v5e bandwidth constant have no
counterpart here. Every card result carries the card's name and power
limit, because a card set below its maximum power runs slower under load.

``time_host`` times calls on CPU tensors by the host clock, so the CLI runs
without a card; its results say
``clock="host"`` and ``device="cpu"``, so no CPU figure passes for a card
figure. ``time_fn`` picks by the input's device: a CUDA tensor is always
timed by ``time_cuda``.
"""

from __future__ import annotations

import statistics
import subprocess
import time
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
    card: str  # nvidia-smi's name and power limit, or "cpu"
    clock: str = "cuda events"  # or "host"
    device: str = "cuda"
    pixels: int | None = None

    @property
    def gpix_s(self) -> float | None:
        if self.pixels is None:
            return None
        return self.pixels / (self.ms * 1e-3) / 1e9


def time_cuda(fn, *args, warmup: int = 3, iters: int = 20,
              card: str | None = None, pixels: int | None = None) -> Timing:
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
                  card=card if card is not None else card_label(),
                  device=f"cuda:{torch.cuda.current_device()}",
                  pixels=pixels)


def time_host(fn, *args, warmup: int = 3, iters: int = 20,
              pixels: int | None = None) -> Timing:
    """Median host-clock ms of ``fn(*args)`` on CPU tensors; refuses CUDA
    tensors, whose calls return before the card is done."""
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        raise ValueError("time_host times CPU tensors; time a CUDA tensor "
                         "with time_cuda")
    for _ in range(warmup):
        fn(*args)
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        ms.append((time.perf_counter() - t0) * 1e3)
    return Timing(ms=statistics.median(ms), ms_min=min(ms), iters=iters,
                  card="cpu", clock="host", device="cpu", pixels=pixels)


def time_fn(fn, x: torch.Tensor, *, warmup: int = 3, iters: int = 20,
            pixels: int | None = None, card: str | None = None) -> Timing:
    """``time_cuda`` for a CUDA tensor ``x``, ``time_host`` for a CPU one."""
    if x.is_cuda:
        return time_cuda(fn, x, warmup=warmup, iters=iters, card=card,
                         pixels=pixels)
    return time_host(fn, x, warmup=warmup, iters=iters, pixels=pixels)
