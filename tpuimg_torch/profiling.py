"""Profiling and tracing helpers (port of ``tpuimg.profiling``).

The reference's observability is cudaEvent timers plus "GPU time by
nsight/nvprof" (Histogram/main.cpp:151; SURVEY.md §5). Here:

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  records CPU activity, and CUDA activity when a card is present, and
  writes a Chrome trace (``*.pt.trace.json``) into ``logdir`` on exit; open
  it in Perfetto or ``chrome://tracing``, or TensorBoard's profiler plugin.
- ``stage_times``: per-stage latency by timing each stage on its own real
  input, then the whole chain (the reference gets per-kernel times by
  running ladder variants separately, SURVEY.md §3.1).
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from tpuimg_torch.core.timing import time_fn


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block; yields ``logdir``, where the trace lands on exit.
    The default is ``tpuimg_torch_trace`` under the temporary directory."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "tpuimg_torch_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield logdir
        finally:
            if cuda:  # the block's kernels end inside the trace
                torch.cuda.synchronize()


def stage_times(stages, x, iters: int = 20):
    """Time a list of (name, fn) stages one by one and chained.

    Each fn maps a tensor to the next stage's input. A stage is timed on
    the output of the stages before it, its real input. Returns
    {name: Timing} with a "chained" entry for the whole chain; each Timing
    names its clock and device (CUDA events for a CUDA tensor, the host
    clock for a CPU tensor)."""
    results = {}
    v = x
    for name, fn in stages:
        results[name] = time_fn(fn, v, iters=iters)
        v = fn(v)

    def chained(u):
        for _, fn in stages:
            u = fn(u)
        return u

    results["chained"] = time_fn(chained, x, iters=iters)
    return results
