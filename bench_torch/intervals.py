"""The card's busy and idle time from the program's own device spans, with
no profiler in the process: the idle share of recorded stretches, and what
the host was doing in each gap.

Inside ``tpuimg_torch.profiling.recording(device=True)`` each launch and
copy of the program records a CUDA event just before it is queued and
another as its span exits, and ``Recorder.intervals()`` puts the card's
work on the spans' clock: an interval a device span, from its first
event's completion to its second's. On an idle stream the first event
completes as soon as the card reaches it, before the host has submitted
the work (about 10 us a launch on the H100), so the readings trim each
interval to the time its C entry or copy takes on the card when queued
behind other work, timed in the same process (``calibrate``).

A metric that reads them calls ``measure(run)``. Its first call in a run of
``run.py --trace 1`` on a card runs a fresh process (``python3
bench_torch/intervals.py --workload W --seed S``), in which no profiler has
run: it warms the cell and drives ``PAIRS`` pairs of ``FRAMES``-frame
stretches, recording off then on and synchronizing after each, and prints
what it read as one JSON line. Where the program has no
``recording(device=...)``, or the run is not ``run.py --trace 1``'s on a
card, every reading is None and nothing runs.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import inspect
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

if __package__ in (None, ""):  # run as a script: the repository's root
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness, spans  # noqa: E402

PAIRS = 8
FRAMES = 2 * harness.TRACE_FRAMES  # frames a stretch of a pair
COST_SPANS = 1000  # empty device spans timed for a device span's cost
QUEUED_CALLS = 24  # calls queued behind a wait to time their work alone
# ~10 ms of spinning at the H100's clock: longer than the host takes to
# queue them
_WAIT_CYCLES = 20_000_000
# an interval that starts this close behind the end ahead of it on its
# stream had its work queued before the card could start it
QUEUED_SLACK_NS = 5_000
_FRESH_TIMEOUT_S = 300
_measured: dict[int, tuple] = {}  # id(run) -> (run, Readings or None)


def recorder():
    """The program's ``profiling`` module if it records device spans, else
    None."""
    prof = spans.recorder()
    if prof is None:
        return None
    try:
        params = inspect.signature(prof.recording).parameters
    except (TypeError, ValueError):
        return None
    return prof if "device" in params else None


def busy(intervals) -> list[tuple[int, int]]:
    """The time some interval covers, on any stream, as disjoint (start,
    end) pieces by start."""
    pieces: list[tuple[int, int]] = []
    for a, b in sorted((iv[3], iv[4]) for iv in intervals if iv[4] > iv[3]):
        if pieces and a <= pieces[-1][1]:
            pieces[-1] = (pieces[-1][0], max(pieces[-1][1], b))
        else:
            pieces.append((a, b))
    return pieces


def gaps(pieces) -> list[tuple[int, int]]:
    """The idle time between the busy pieces."""
    return [(a[1], b[0]) for a, b in zip(pieces, pieces[1:])]


def idle_pct(pieces) -> float | None:
    """Share of the pieces' window, the first start to the last end, that
    no piece covers, %."""
    if not pieces:
        return None
    window = pieces[-1][1] - pieces[0][0]
    return 100.0 * (1.0 - sum(b - a for a, b in pieces) / window)


def causal_share(intervals, starts, clock_error_ns: int) -> float:
    """Share of the intervals that end no earlier than their span's host
    start less ``clock_error_ns``: where the clocks agree, every one."""
    return sum(iv[4] >= starts[iv[0]] - clock_error_ns
               for iv in intervals) / len(intervals)


def _key(span) -> str:
    """What a device span queued: a launch's C entry, else the span."""
    return span.detail or span.name


def _behind(intervals):
    """Each interval with whether it was queued: it starts within
    ``QUEUED_SLACK_NS`` of the end ahead of it on its stream, so its first
    event completed as that work ended, with its own work queued behind."""
    last: dict[tuple[int, int], int] = {}
    for iv in intervals:  # in the order recorded: each stream's own order
        prev = last.get((iv[1], iv[2]))
        last[iv[1], iv[2]] = iv[4]
        yield iv, prev is not None and iv[3] - prev <= QUEUED_SLACK_NS


def queued_ns(intervals, sp) -> dict[str, float]:
    """Each C entry's or copy's time on the card when queued, ns: the
    median length of its queued intervals (``_behind``)."""
    by_id = {s.id: s for s in sp}
    got: dict[str, list[int]] = {}
    for iv, queued in _behind(intervals):
        if queued:
            got.setdefault(_key(by_id[iv[0]]), []).append(iv[4] - iv[3])
    return {k: statistics.median(v) for k, v in got.items()}


def trim(intervals, sp, queued: dict[str, float]) -> list[tuple]:
    """The intervals, each not queued (``_behind``) starting no earlier
    than its end less its C entry's or copy's queued time. On an idle
    stream the first event completes as soon as the card reaches it, and
    the work behind it starts only once the host has submitted it: the
    time between is the host's."""
    by_id = {s.id: s for s in sp}
    out = []
    for (sid, card, stream, start, end), behind in _behind(intervals):
        d = None if behind else queued.get(_key(by_id[sid]))
        out.append((sid, card, stream,
                    start if d is None else max(start, end - round(d)),
                    end))
    return out


def calibrate(prof, fn, args, device, calls: int = QUEUED_CALLS) -> dict:
    """``queued_ns`` of ``calls`` calls of ``fn`` on the ring ``args``,
    queued on the card behind a wait of ``_WAIT_CYCLES``."""
    torch.cuda.synchronize(device)
    with prof.recording(device=True) as rec:
        torch.cuda._sleep(_WAIT_CYCLES)
        for i in range(calls):
            fn(*args[i % len(args)])
    torch.cuda.synchronize(device)
    return queued_ns(rec.intervals(), spans.spans_of(rec))


def stretch(intervals, sp, clock_error_ns: int | None,
            queued: dict[str, float] | None = None) -> dict:
    """One recorded stretch's readings from its intervals and its spans
    (``spans.Span``, on the same clock), the intervals trimmed to
    ``queued`` (``trim``): the idle share, the idle time by the innermost
    span the host was in (ns), the share of it inside the program, the
    causality share, the interval time by C entry (a launch's ``detail``)
    or span name (ns), and the root spans."""
    causal = (causal_share(intervals, {s.id: s.start for s in sp},
                           clock_error_ns) if intervals else None)
    if queued:
        intervals = trim(intervals, sp, queued)
    pieces = busy(intervals)
    where = spans.idle_by_span(gaps(pieces), sp)
    idle = sum(where.values())
    by_id = {s.id: s for s in sp}
    entries: dict[str, int] = {}
    for iv in intervals:
        key = _key(by_id[iv[0]])
        entries[key] = entries.get(key, 0) + max(0, iv[4] - iv[3])
    return {
        "idle_pct": idle_pct(pieces),
        # a stretch with no idle time kept the card waiting on nothing
        "in_program_pct": (100.0 * (1.0 - where.get(spans.CALLER, 0) / idle)
                           if idle > 0 else 0.0),
        "where": where,
        "causal": causal,
        "entries": entries,
        "intervals": len(intervals),
        "roots": sum(s.parent is None for s in sp),
    }


def span_cost(prof, device, n: int = COST_SPANS, rounds: int = 3) -> float:
    """Host ns a device span adds to a plain one: ``n`` empty spans given
    ``device`` under ``recording(device=True)`` against ``recording()``,
    the medians of ``rounds`` in turns, after one of each to warm up."""
    times: dict[bool, list[int]] = {False: [], True: []}
    for i in range(rounds + 1):
        for on in (False, True):
            with prof.recording(device=on) as rec:
                t0 = time.perf_counter_ns()
                for _ in range(n):
                    with prof.span("kernels.launch", "launch", "span_cost",
                                   device=device) as s:
                        s.queue()
                t = time.perf_counter_ns() - t0
            torch.cuda.synchronize(device)
            rec.intervals()
            if i:
                times[on].append(t)
    return (statistics.median(times[True])
            - statistics.median(times[False])) / n


def fresh_process(cell, seed: int, device, frames: int = FRAMES,
                  pairs: int = PAIRS) -> dict:
    """What the fresh process reads: ``pairs`` pairs of stretches of
    ``frames`` frames, recording off then on (device spans), after a warm-up,
    one recorded stretch that fills the events' pool and, on a card, the
    work's queued times (``calibrate``), with the garbage collector's
    objects frozen as for the window: each stretch's (frames/s, host ms a
    call) (``off``, ``on``), each recorded stretch's ``stretch`` readings,
    trimmed to the queued times, and clock error, and on a card a device
    span's cost in host ns."""
    prof = recorder()
    fn = cell.module.entry(cell.config)
    args = cell.module.make_args(cell.config, seed, device)
    in_flight = cell.traffic["in_flight"]
    marks = harness.Marks(device, in_flight + 1)
    cuda = device.type == "cuda"
    nxt = 0

    def one(record: bool, count: int):
        nonlocal nxt
        run = harness.Run(cell.config)
        with (prof.recording(device=True) if record
              else contextlib.nullcontext()) as rec:
            nxt = harness.drive(fn, args, in_flight, marks,
                                harness.Sample(0, 0), run, count=count,
                                first=nxt)
            if cuda:
                torch.cuda.synchronize(device)
        return run.frames / run.window_s, run.host_s / run.frames * 1e3, rec

    one(False, harness.WARM_FRAMES)
    one(True, frames)[2].intervals()
    queued = calibrate(prof, fn, args, device) if cuda else {}
    gc.collect()  # as before the window (``harness.run_cell``)
    gc.freeze()
    out: dict = {"off": [], "on": [], "stretches": [], "clock_error_ns": [],
                 "queued_ns": queued}
    for _ in range(pairs):
        for record in (False, True):
            fps, host_ms, rec = one(record, frames)
            out["on" if record else "off"].append((fps, host_ms))
            if rec is not None:
                ivs = rec.intervals()
                out["clock_error_ns"].append(rec.clock_error_ns)
                out["stretches"].append(stretch(ivs, spans.spans_of(rec),
                                                rec.clock_error_ns, queued))
    out["span_cost_ns"] = span_cost(prof, device) if cuda else None
    return out


def _in_fresh_process(workload: str, seed: int) -> dict | None:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()),
         "--workload", workload, "--seed", str(seed)],
        cwd=harness.ROOT, capture_output=True, text=True,
        timeout=_FRESH_TIMEOUT_S)
    if proc.returncode != 0:
        print(f"intervals: the fresh process failed ({proc.returncode}):\n"
              f"{proc.stderr[-4000:]}", file=sys.stderr)
        return None
    return json.loads(proc.stdout.splitlines()[-1])


@dataclass
class Readings:
    """What the interval metrics read from one run."""
    idle_pct: float | None = None
    in_program_pct: float | None = None


def _list(values) -> str:
    return ", ".join("None" if v is None else f"{v:.2f}" for v in values)


def readings(fresh: dict, out=sys.stderr) -> Readings:
    """The metrics' values from ``fresh_process``, with what they rest on
    printed to ``out``. Both are None where a recorded stretch has no
    interval, or one ends before its span began (the clocks disagree)."""
    st = fresh["stretches"]
    r = Readings()
    roots = sum(s["roots"] for s in st)
    n = sum(s["intervals"] for s in st)
    where: dict[str, float] = {}
    entries: dict[str, float] = {}
    for s in st:
        for total, got in ((where, s["where"]), (entries, s["entries"])):
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
    causal = [s["causal"] for s in st]
    errors = fresh["clock_error_ns"]
    print(f"intervals: {len(st)} recorded stretches, {n} device spans over "
          f"{roots} root spans; clock_error_ns by stretch: "
          + ", ".join(map(str, errors)), file=out)
    shares = [None if c is None else 100 * c for c in causal]
    print(f"intervals: causality {_list(shares)}% by stretch: intervals "
          f"ending no earlier than their span's start less clock_error_ns",
          file=out)
    idle = sum(where.values())
    if idle > 0:
        top = sorted(where.items(), key=lambda kv: -kv[1])[:10]
        print("intervals: idle ms over the stretches by innermost span, top "
              "10: " + ", ".join(f"{k} {v * 1e-6:.4f} ({100 * v / idle:.1f}%)"
                                 for k, v in top), file=out)
    queued = fresh.get("queued_ns") or {}
    print("intervals: ms on the card when queued behind a wait, by C entry "
          "or span (intervals trimmed to it): "
          + (", ".join(f"{k} {v * 1e-6:.4f}" for k, v in queued.items())
             or "none"), file=out)
    if roots:
        print("intervals: trimmed interval ms a call by C entry or span: "
              + ", ".join(f"{k} {v * 1e-6 / roots:.4f}" for k, v in
                          sorted(entries.items(), key=lambda kv: -kv[1])),
              file=out)
    off, on = fresh["off"], fresh["on"]
    if off and on:
        cost = statistics.median(h_on - h_off for (_, h_off), (_, h_on)
                                 in zip(off, on))
        print(f"intervals: recording's cost, medians over pairs: host ms a "
              f"call {statistics.median(h for _, h in off):.4f} off, "
              f"{statistics.median(h for _, h in on):.4f} on ({cost:+.4f} a "
              f"pair); frames/s "
              f"{statistics.median(f for f, _ in off):.1f} off, "
              f"{statistics.median(f for f, _ in on):.1f} on; "
              + (f"{n / roots:.2f} device spans a call; " if roots else "")
              + (f"a device span {fresh['span_cost_ns'] * 1e-3:.3f} us "
                 f"beyond a plain span ({COST_SPANS} empty spans)"
                 if fresh.get("span_cost_ns") is not None else ""),
              file=out)
    idles = [s["idle_pct"] for s in st]
    inside = [s["in_program_pct"] for s in st]
    print(f"intervals: device_idle_events_pct by stretch {_list(idles)}; "
          f"idle_in_program_events_pct {_list(inside)}", file=out)
    if not st or None in idles or None in causal or min(causal) < 1.0:
        print("intervals: no reading (a stretch without intervals, or one "
              "ending before its span began)", file=out)
        return r
    r.idle_pct = statistics.median(idles)
    r.in_program_pct = statistics.median(inside)
    return r


def measure(run) -> Readings | None:
    """The interval readings of ``run``, taken once per run."""
    if id(run) in _measured:
        return _measured[id(run)][1]
    r = None
    cmd = spans._command_line()
    if cmd is None or recorder() is None or not torch.cuda.is_available():
        print("intervals: not read (no device spans in the program, or not "
              "a run of run.py --trace 1 on a card)", file=sys.stderr)
    else:
        t0 = time.perf_counter()
        fresh = _in_fresh_process(*cmd)
        if fresh is not None:
            r = readings(fresh)
        print(f"intervals: the fresh process took "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    _measured[id(run)] = (run, r)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a cell's device spans in "
                                 "stretches recorded on the card in this "
                                 "fresh process, no profiler; prints them "
                                 "as one JSON line")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args(argv)
    cell = harness.load_cell(a.workload)
    print(json.dumps(fresh_process(cell, a.seed, torch.device("cuda", 0))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
