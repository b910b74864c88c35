"""Profiling and tracing of the port (the counterpart of
``tpuimg.profiling``).

The reference's observability is cudaEvent timers plus "GPU time by
nsight/nvprof" (Histogram/main.cpp:151; SURVEY.md §5). Here:

- ``span(name, layer)``: a context manager around a step of the program.
  ``enhance``, ``guided_filter`` and ``hist_equalize`` open one around each
  call and one around each step inside it (a kernel wrapper, the PyTorch
  glue between kernels); ``kernels.launch`` opens one around each launch,
  and ``kernels.load`` around building and loading the library. While nothing
  records, it returns one shared object that does nothing: it reads no
  clock and allocates nothing.
- ``recording()``: records every span opened in its block, in memory, as
  ``Span``s on ``time.perf_counter_ns()``; the recorder it yields also
  holds a wall-clock pair read when it started, so that its spans can be
  put on the profiler's clock. Off is the default; nothing else turns it
  on.
- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  records CPU activity, and CUDA activity when a card is present, records
  the program's spans, and on exit writes one Chrome trace
  (``*.pt.trace.json``) into ``logdir`` with the spans as complete events
  on a track of their own; open it in Perfetto or ``chrome://tracing``.

A span's ``layer`` is one of ``LAYERS``: ``entry`` (a public entry or a
kernel wrapper: checks, allocations, taps, the wrapper's Python), ``glue``
(PyTorch ops between the kernels), ``launch`` (``kernels.launch``: the
stream lookup and the C call), ``load`` (building and loading the kernel
library) and ``transfer`` (``enhance_host``'s copies between the host and
the device: staging into pinned memory, the copy up, the copy down). A span
opened while no other is open in its thread is a root: a call into the
program (``host.enhance``, ``pipeline.enhance``, ``ops.guided_filter``,
``ops.hist_equalize``; the steps of other entries show as roots of their
own). The spans inside it share its id as ``root``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import tempfile
import threading
import time
from typing import NamedTuple

import torch

LAYERS = ("entry", "glue", "launch", "load", "transfer")
# the span track of a written trace: a thread id no process gets
_TRACK_TID = 2**31 - 1


class Span(NamedTuple):
    """One finished span; times on ``time.perf_counter_ns()``. ``detail``
    names what the span acted on (a launch's C entry); ``first`` marks the
    process's first launch of that entry, which pays its one-time set-up."""

    id: int
    parent: int | None
    root: int
    name: str
    layer: str
    start_ns: int
    end_ns: int
    detail: str | None = None
    first: bool = False


class Recorder:
    """The spans of one recording, kept in memory until read, and the
    clock pair (``time.time_ns()``, ``time.perf_counter_ns()``) read when
    it started."""

    def __init__(self):
        self.wall_ns = time.time_ns()
        self.perf_ns = time.perf_counter_ns()
        self._done: list[tuple] = []  # Span fields, as spans end
        self._ids = itertools.count(1)
        self._local = threading.local()  # each thread's open spans

    @property
    def spans(self) -> list[Span]:
        """The finished spans, by start."""
        return sorted(map(Span._make, self._done),
                      key=lambda s: (s.start_ns, s.id))

    def epoch_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading as ns since the Unix epoch, the
        clock of the profiler's events."""
        return self.wall_ns + (perf_ns - self.perf_ns)


class _Null:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_recorder: Recorder | None = None  # where spans go while recording is on


class _Live:
    __slots__ = ("rec", "name", "layer", "detail", "first", "id", "parent",
                 "root", "start", "stack")

    def __init__(self, rec, name, layer, detail, first):
        if layer not in LAYERS:
            raise ValueError(f"span layer must be one of {LAYERS}, got "
                             f"{layer!r}")
        self.rec, self.name, self.layer = rec, name, layer
        self.detail, self.first = detail, first

    def __enter__(self):
        local = self.rec._local
        try:
            stack = local.stack
        except AttributeError:
            stack = local.stack = []
        self.stack, self.id = stack, next(self.rec._ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        self.rec._done.append((self.id, self.parent, self.root, self.name,
                               self.layer, self.start, end, self.detail,
                               self.first))
        return False


def span(name: str, layer: str, detail: str | None = None,
         first: bool = False):
    """A context manager around one step of the program, recorded while
    ``recording()`` is on; ``layer`` is one of ``LAYERS``."""
    rec = _recorder
    if rec is None:
        return _NULL
    return _Live(rec, name, layer, detail, first)


@contextlib.contextmanager
def recording():
    """Record the spans opened in the block; yields the ``Recorder``. A
    recording inside another takes the spans until it ends."""
    global _recorder
    outer, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer


def _chrome_events(rec: Recorder, base_ns: int = 0) -> list[dict]:
    """The recorder's spans as Chrome-trace complete events on a track of
    their own, ``ts`` in us after ``base_ns`` (ns since the epoch), nested
    as they ran."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid,
               "tid": _TRACK_TID, "args": {"name": "tpuimg_torch spans"}}]
    for s in rec.spans:
        args = {"layer": s.layer, "id": s.id, "parent": s.parent,
                "root": s.root}
        if s.detail is not None:
            args["detail"] = s.detail
        if s.first:
            args["first"] = True
        events.append({
            "ph": "X", "cat": "tpuimg_span", "name": s.name, "pid": pid,
            "tid": _TRACK_TID,
            "ts": (rec.epoch_ns(s.start_ns) - base_ns) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return events


def _write_trace(prof, rec: Recorder, logdir: str) -> None:
    """The profiler's Chrome trace with the spans added, written into
    ``logdir`` under the name TensorBoard's handler gives."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # the events' ts are us after baseTimeNanoseconds where the trace
    # names one, else after the epoch
    doc["traceEvents"] += _chrome_events(rec,
                                         doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block and record its spans; yields ``logdir``, where the
    trace lands on exit. The default is ``tpuimg_torch_trace`` under the
    temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "tpuimg_torch_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with recording() as rec, profile(
            activities=activities,
            on_trace_ready=lambda prof: _write_trace(prof, rec, logdir)):
        try:
            yield logdir
        finally:
            if cuda:  # the block's kernels end inside the trace
                torch.cuda.synchronize()
