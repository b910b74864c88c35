"""Profiling and tracing of the port (the counterpart of
``tpuimg.profiling``).

The reference's observability is cudaEvent timers plus "GPU time by
nsight/nvprof" (Histogram/main.cpp:151; SURVEY.md §5). Here:

- ``span(name, layer)``: a context manager around a step of the program.
  ``enhance``, ``guided_filter``, ``hist_equalize``, ``erode``, ``dilate``,
  ``morph_open`` and ``morph_close`` open one around each call and one
  around each step inside it (a kernel wrapper, the PyTorch glue between
  kernels); ``kernels.launch`` opens one around each launch, and
  ``kernels.load`` around building and loading the library. While nothing
  records, it returns one shared object that does nothing: it reads no
  clock and allocates nothing.
- ``recording()``: records every span opened in its block, in memory, as
  ``Span``s on ``time.perf_counter_ns()``; the recorder it yields also
  holds a wall-clock pair read when it started, so that its spans can be
  put on the profiler's clock. Off is the default; nothing else turns it
  on.
- ``recording(device=True)``: the same, and each span given a ``device``
  (``kernels.launch``, ``host.upload``, ``host.download``) records two
  timing-enabled CUDA events on that card's current stream: one where the
  span calls ``queue()``, just before its C call or copy is queued, and one
  as it exits. Once the caller has synchronized, ``Recorder.intervals()``
  puts the card's work on the spans' clock, with no profiler: an interval a
  device span, from its first event's completion to its second's. The
  events come from a pool kept per card and reused from one recording to
  the next. A plain ``recording()`` records no event, and ``queue()`` does
  nothing there.
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
``ops.hist_equalize``, ``ops.erode``, ``ops.dilate``, ``ops.morph_open``,
``ops.morph_close``; the steps of other entries show as roots of their
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


class Interval(NamedTuple):
    """The card's work for one device span, on the spans' clock: from
    ``start_ns`` to ``end_ns`` on stream ``stream`` (its raw handle) of card
    ``card``."""

    span: int
    card: int
    stream: int
    start_ns: int
    end_ns: int


class Recorder:
    """The spans of one recording, kept in memory until read, and the
    clock pair (``time.time_ns()``, ``time.perf_counter_ns()``) read when
    it started. With ``device``, also each device span's two events."""

    def __init__(self, device: bool = False):
        self.wall_ns = time.time_ns()
        self.perf_ns = time.perf_counter_ns()
        self.device = device
        # half the widest window in which a card's anchor event completed,
        # ns; set by ``intervals()``
        self.clock_error_ns: int | None = None
        self._done: list[tuple] = []  # Span fields, as spans end
        # (span id, card, stream, start event, end event)
        self._marks: list[tuple] = []
        self._intervals: list[Interval] | None = None
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

    def intervals(self) -> list[Interval]:
        """An ``Interval`` for each device span, in the order their events
        were recorded; read once the recording has ended and the caller has
        synchronized its cards. Raises ``RuntimeError`` if an event has not
        completed. The first read returns the events to their pools."""
        if self._intervals is not None:
            return self._intervals
        marks = self._marks
        if not all(end.query() for *_, end in marks):
            raise RuntimeError("a device span's event has not completed: "
                               "synchronize the card before intervals()")
        anchors = {card: _POOLS[card].anchor()
                   for card in dict.fromkeys(m[1] for m in marks)}

        def host_ns(card, ev):
            anchor, at_ns, _ = anchors[card]
            return at_ns - round(ev.elapsed_time(anchor) * 1e6)

        self._intervals = [
            Interval(sid, card, stream, host_ns(card, start),
                     host_ns(card, end))
            for sid, card, stream, start, end in marks]
        for _, card, _, start, end in marks:
            _POOLS[card].free += (start, end)
        for card, (anchor, _, _) in anchors.items():
            _POOLS[card].free.append(anchor)
        self._marks = []
        self.clock_error_ns = max((a[2] for a in anchors.values()),
                                  default=None)
        return self._intervals


# events a card's pool makes when a device recording first needs it
_AHEAD = 256
_ANCHOR_TRIES = 5


class _Events:
    """A card's timing events, handed out to device spans and given back by
    ``Recorder.intervals()``; new ones are made only when a recording holds
    more device spans than the pool has free."""

    def __init__(self, card: int):
        self.card = card
        self.made = 0
        self.streams: dict[int, torch.cuda.Stream] = {}  # by raw handle
        stream = self.stream(torch._C._cuda_getCurrentRawStream(card))
        self.free = [self._make(stream) for _ in range(_AHEAD)]

    def _make(self, stream) -> torch.cuda.Event:
        """A new event, recorded on ``stream``: a CUDA event is made at its
        first record."""
        self.made += 1
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def stream(self, handle: int) -> torch.cuda.Stream:
        """The card's current stream, whose raw handle is ``handle``."""
        s = self.streams.get(handle)
        if s is None:
            s = self.streams[handle] = torch.cuda.current_stream(self.card)
        return s

    def record(self, handle: int) -> torch.cuda.Event:
        """A free event, recorded on the card's current stream, whose raw
        handle is ``handle``."""
        s = self.stream(handle)
        if not self.free:
            return self._make(s)
        ev = self.free.pop()
        ev.record(s)
        return ev

    def anchor(self) -> tuple[torch.cuda.Event, int, int]:
        """An event recorded on the idle card, the host time it completed
        at (the middle of the narrowest of a few windows read around its
        record and synchronize) and that window's half-width, ns."""
        stream = self.stream(torch._C._cuda_getCurrentRawStream(self.card))
        best = None
        for _ in range(_ANCHOR_TRIES):
            ev = self.free.pop() if self.free else self._make(stream)
            t0 = time.perf_counter_ns()
            ev.record(stream)
            ev.synchronize()
            t1 = time.perf_counter_ns()
            if best is None or t1 - t0 < best[2] - best[1]:
                if best is not None:
                    self.free.append(best[0])
                best = (ev, t0, t1)
            else:
                self.free.append(ev)
        ev, t0, t1 = best
        return ev, (t0 + t1) // 2, (t1 - t0 + 1) // 2


_POOLS: dict[int, _Events] = {}  # card index -> its events


def _pool(card: int) -> _Events:
    pool = _POOLS.get(card)
    if pool is None:
        pool = _POOLS[card] = _Events(card)
    return pool


class _Null:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def queue(self):
        pass


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

    def queue(self):
        """Mark where the span queues its work on the card: a device span
        records its interval's first event here."""


class _DeviceLive(_Live):
    """A live span that records an event on its card's current stream when
    it calls ``queue()``, and another behind the work it queued as it exits.
    One that never calls ``queue()`` records both at its exit."""

    __slots__ = ("device", "card", "stream", "begun")

    def __init__(self, rec, name, layer, detail, first, device):
        super().__init__(rec, name, layer, detail, first)
        self.device, self.begun = device, None

    def queue(self):
        d = self.device
        card = d if isinstance(d, int) else d.index
        if card is None:
            card = torch._C._cuda_getDevice()
        self.card = card
        self.stream = torch._C._cuda_getCurrentRawStream(card)
        self.begun = _pool(card).record(self.stream)

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.begun is None:
            self.queue()
        self.rec._marks.append((self.id, self.card, self.stream, self.begun,
                                _pool(self.card).record(self.stream)))
        return False


def span(name: str, layer: str, detail: str | None = None,
         first: bool = False, device: torch.device | int | None = None):
    """A context manager around one step of the program, recorded while
    ``recording()`` is on; ``layer`` is one of ``LAYERS``. ``device`` names
    the card on whose current stream the step queues its work: inside
    ``recording(device=True)`` the span then records an event there when
    the step calls the span's ``queue()``, just before it queues the work,
    and another as it exits."""
    rec = _recorder
    if rec is None:
        return _NULL
    if device is None or not rec.device:
        return _Live(rec, name, layer, detail, first)
    return _DeviceLive(rec, name, layer, detail, first, device)


@contextlib.contextmanager
def recording(device: bool = False):
    """Record the spans opened in the block; yields the ``Recorder``. A
    recording inside another takes the spans until it ends. With
    ``device``, spans given a card record its work too (the module's
    docstring); the current card's events are made on entry."""
    global _recorder
    outer, rec = _recorder, Recorder(device)
    if device and torch.cuda.is_available():
        _pool(torch.cuda.current_device())
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
