"""The program's spans beside the device trace: host time a call by layer,
the card's idle time by the span the host was in, whether the two clocks
agree, and where a first call's set-up goes.

The program records spans only inside ``tpuimg_torch.profiling.recording()``,
which the measured window never turns on. A metric that reads spans calls
``measure(run)``. Its first call in a run of ``run.py --trace 1`` (after the
window, the traced stretch and the comparison) makes the cell's ring again
and drives ``TRACED`` recorded stretches under the profiler (device
activity only, as ``devtrace.capture``): the idle time by span and the
clocks' agreement. Then a fresh process (``python3 bench_torch/spans.py
--workload W --seed S``), in which no profiler has run, records its first
call from before the program's entry is made (the set-up spans), and
drives ``PAIRS`` pairs of stretches, recording off then on: the recorded
ones give the host time by layer, the pairs' host time a call recording's
cost. Where the program has no recorder, or the run is not ``run.py
--trace 1``'s on a card, every reading is None and nothing runs.

Span times are the program's ``time.perf_counter_ns()``. The recorder's
clock pair puts them on the Unix epoch, and the profiler's event times are
``trace_start_ns + time_range * 1000`` on the same epoch, so both meet in
the profiler's microseconds (``to_trace_us``).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import subprocess
import sys
import time
from collections import namedtuple
from dataclasses import dataclass, field
from pathlib import Path

import torch

if __package__ in (None, ""):  # run as a script: the repository's root
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import devtrace, harness  # noqa: E402

# the program's Span fields; ``start`` and ``end`` in the clock at hand
Span = namedtuple("Span", "id parent root name layer start end detail first")
# stretches with recording off, then on, with no profiler: short and many,
# since the host's own speed drifts over seconds
PAIRS = 8
HOST_FRAMES = 2 * harness.TRACE_FRAMES  # frames a stretch of a pair
TRACED = 2  # recorded stretches under the profiler
CAUSAL_SLACK_US = 2.0  # a kernel may start this early before its launch
CALLER = "(caller)"  # idle time with the host in no span of the program
_FRESH_TIMEOUT_S = 600
_measured: dict[int, tuple] = {}  # id(run) -> (run, Readings or None)


def recorder():
    """The program's ``profiling`` module if it records spans, else None."""
    try:
        from tpuimg_torch import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "recording") else None


def spans_of(rec) -> list[Span]:
    """A recorder's spans, on its ``perf_counter_ns`` clock."""
    return [Span(*s) for s in rec.spans]


def to_trace_us(t_ns: int, wall_ns: int, perf_ns: int,
                trace_start_ns: int) -> float:
    """A ``perf_counter_ns`` reading of a recorder whose clock pair is
    (``wall_ns``, ``perf_ns``) in the profiler's microseconds after
    ``trace_start_ns``."""
    return (wall_ns + (t_ns - perf_ns) - trace_start_ns) / 1e3


def on_trace(spans, wall_ns: int, perf_ns: int,
             trace_start_ns: int) -> list[Span]:
    return [s._replace(start=to_trace_us(s.start, wall_ns, perf_ns,
                                         trace_start_ns),
                       end=to_trace_us(s.end, wall_ns, perf_ns,
                                       trace_start_ns))
            for s in spans]


def capture(stretch, attempts: int = 3):
    """``devtrace.capture``'s device trace (no host calls), with the
    trace's start on the epoch and, for each kernel that is not PyTorch's,
    the runtime call that launched it (CUPTI's correlation id): (trace,
    trace_start_ns, [(kernel, kernel start, call start)] in the profiler's
    us, what the last ``stretch()`` returned), or None if every trace came
    back without device work. A trace in which such a kernel starts before
    the call that launched it has its device times off its host times (the
    profiler does that now and then) and is taken again too; the last is
    kept if every one is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kept = None
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = stretch()
        kernels = sorted(
            ((e.name, float(e.time_range.start), float(e.time_range.end))
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)),
            key=lambda k: k[1])
        if not kernels:
            continue
        results = prof.profiler.kineto_results
        start_ns = results.trace_start_ns()
        events = results.events()
        calls = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() == DeviceType.CPU
                 and e.name().startswith("cuda")}
        launched = [(e.name(), (e.start_ns() - start_ns) / 1e3,
                     (calls[e.correlation_id()] - start_ns) / 1e3)
                    for e in events
                    if e.device_type() == DeviceType.CUDA
                    and not devtrace.is_torch(e.name())
                    and e.correlation_id() in calls]
        kept = (devtrace.Trace(0, kernels, []), start_ns, launched, got)
        early = min((k0 - c0 for _, k0, c0 in launched), default=0.0)
        if early >= -CAUSAL_SLACK_US:
            return kept
        print(f"spans: a kernel starts {-early:.1f} us before the call that "
              f"launched it in the profiler's own trace: taken again",
              file=sys.stderr)
    return kept


def self_times(spans) -> dict[int, float]:
    """Each span's duration less what its children cover."""
    own = {s.id: s.end - s.start for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end - s.start
    return own


def self_by(spans, key: str) -> dict[str, float]:
    """Self time summed by each span's ``key``: ``"layer"`` or ``"name"``."""
    own, total = self_times(spans), {}
    for s in spans:
        k = getattr(s, key)
        total[k] = total.get(k, 0.0) + own[s.id]
    return total


def timeline(spans) -> list[tuple[float, float, Span]]:
    """The time inside spans as (start, end, innermost span) pieces, by
    start; spans nest, as one thread opens them."""
    pieces, stack, t = [], [], None

    def pop():
        nonlocal t
        top = stack.pop()
        if top.end > t:
            pieces.append((t, top.end, top))
        t = top.end

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= s.start:
            pop()
        if stack and s.start > t:
            pieces.append((t, s.start, stack[-1]))
        t = s.start
        stack.append(s)
    while stack:
        pop()
    return pieces


def idle_by_span(gaps, spans) -> dict[str, float]:
    """The idle gaps' time by the innermost span the host was in,
    ``CALLER`` where it was in none."""
    pieces = timeline(spans)
    starts = [p[0] for p in pieces]
    out: dict[str, float] = {}
    for a, b in gaps:
        inside = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            lo, hi, s = pieces[i]
            part = min(b, hi) - max(a, lo)
            if part > 0:
                out[s.name] = out.get(s.name, 0.0) + part
                inside += part
            i += 1
        out[CALLER] = out.get(CALLER, 0.0) + (b - a) - inside
    return out


def launch_delays(launched, spans) -> list[float | None]:
    """For each kernel that is not PyTorch's, with the start of the runtime
    call that launched it (``capture``): its start less the start of the
    ``kernels.launch`` span that the call lies in, or None where the call
    lies in no such span. All on one clock, spans included."""
    ls = sorted((s for s in spans if s.name == "kernels.launch"),
                key=lambda s: s.start)
    starts = [s.start for s in ls]
    out = []
    for _, k0, c0 in launched:
        i = bisect.bisect_right(starts, c0) - 1
        out.append(k0 - ls[i].start if i >= 0 and c0 <= ls[i].end else None)
    return out


def causal_share(delays) -> float:
    """The share of kernels whose launch call lies in a ``kernels.launch``
    span and that start no earlier than ``CAUSAL_SLACK_US`` before it:
    where the two clocks agree, every one."""
    return sum(d is not None and d >= -CAUSAL_SLACK_US
               for d in delays) / len(delays)


def setup_lines(spans) -> list[str]:
    """The span tree with each span's duration and self time, ms."""
    own = self_times(spans)
    depth: dict[int, int] = {}
    lines = []
    for s in sorted(spans, key=lambda s: (s.start, s.id)):
        depth[s.id] = depth.get(s.parent, -1) + 1
        what = f" {s.detail}" if s.detail else ""
        first = " (first)" if s.first else ""
        lines.append(f"{'  ' * depth[s.id]}{s.name}{what}{first} "
                     f"[{s.layer}] {(s.end - s.start) * 1e-6:.3f} ms, self "
                     f"{own[s.id] * 1e-6:.3f} ms")
    return lines


@dataclass
class Readings:
    """What the span metrics read from one run."""
    host_ms: dict = field(default_factory=dict)  # layer -> ms a root span
    idle_in_program_pct: float | None = None
    load_s: float | None = None
    first_launch_s: float | None = None


def _loop(cell, fn, args, device):
    """A function ``one(record, count)`` that drives the next ``count``
    frames of the ring ``args`` through ``fn`` as the window does,
    recording spans while ``record``, and returns (frames/s, host ms a call
    by the caller's clock, the recorder or None); warmed up."""
    prof = recorder()
    in_flight = cell.traffic["in_flight"]
    marks = harness.Marks(device, in_flight + 1)
    nxt = 0

    def one(record: bool, count: int):
        nonlocal nxt
        run = harness.Run(cell.config)
        with prof.recording() if record else contextlib.nullcontext() as rec:
            nxt = harness.drive(fn, args, in_flight, marks,
                                harness.Sample(0, 0), run, count=count,
                                first=nxt)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return run.frames / run.window_s, run.host_s / run.frames * 1e3, rec

    one(False, harness.WARM_FRAMES)
    return one


def first_call(cell, seed: int, device):
    """Recording on from before the program's entry is made to the end of
    its first call, in ``harness.run_cell``'s order. Returns the entry, the
    ring, and the spans (perf ns) with the first call's seconds by the
    caller's clock."""
    mod, cfg = cell.module, cell.config
    cuda = device.type == "cuda"
    with recorder().recording() as rec:
        fn = mod.entry(cfg)
        args = mod.make_args(cfg, seed, device)
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn(*args[0])
        if cuda:
            torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    return fn, args, {"spans": [list(s) for s in rec.spans],
                      "first_call_s": first_s}


def host_pairs(one, frames: int = HOST_FRAMES, pairs: int = PAIRS) -> dict:
    """``pairs`` pairs of stretches of ``frames`` frames, recording off then
    on: each stretch's (frames/s, host ms a call) (``off``, ``on``), and the
    recorded stretches' self time in us summed by layer and by name, their
    root spans and spans."""
    out = {"off": [], "on": [], "layers": {}, "names": {}, "roots": 0,
           "spans": 0}
    for _ in range(pairs):
        for record in (False, True):
            fps, host_ms, rec = one(record, frames)
            out["on" if record else "off"].append((fps, host_ms))
            if rec is None:
                continue
            sp = spans_of(rec)  # numbered from 1 in each recording
            out["roots"] += sum(s.parent is None for s in sp)
            out["spans"] += len(sp)
            for key, total in (("layer", out["layers"]),
                               ("name", out["names"])):
                for k, v in self_by(sp, key).items():
                    total[k] = total.get(k, 0.0) + v / 1e3
    return out


def fresh_process(cell, seed: int, device, frames: int = HOST_FRAMES,
                  pairs: int = PAIRS) -> dict:
    """What the fresh process reads: its first call's set-up spans
    (``setup``), then ``host_pairs``, before any profiler has run in it (a
    profiler that has run leaves every later CUDA call slower)."""
    fn, args, setup = first_call(cell, seed, device)
    got = host_pairs(_loop(cell, fn, args, device), frames, pairs)
    got["setup"] = setup
    return got


def traced(cell, seed: int, device, stretches: int = TRACED) -> list:
    """``stretches`` recorded stretches of ``harness.TRACE_FRAMES`` frames
    under the profiler: for each, its spans, idle gaps and launched kernels
    in the profiler's us, and its frames/s."""
    fn = cell.module.entry(cell.config)
    args = cell.module.make_args(cell.config, seed, device)
    one = _loop(cell, fn, args, device)
    out = []
    for _ in range(stretches):
        got = capture(lambda: one(True, harness.TRACE_FRAMES))
        if got is not None:
            trace, start_ns, launched, (fps, _, rec) = got
            out.append((on_trace(spans_of(rec), rec.wall_ns, rec.perf_ns,
                                 start_ns),
                        devtrace.idle_gaps(trace), launched, fps))
    return out


def setup_readings(setup: dict) -> tuple[float | None, float | None]:
    """(``kernels.load`` seconds, first launches' self seconds) of a
    ``first_call`` record."""
    sp = [Span(*s) for s in setup["spans"]]
    own = self_times(sp)
    loads = [s.end - s.start for s in sp if s.name == "kernels.load"]
    firsts = [own[s.id] for s in sp
              if s.name == "kernels.launch" and s.first]
    return (sum(loads) * 1e-9 if loads else None,
            sum(firsts) * 1e-9 if firsts else None)


def _command_line():
    """(workload, seed) of the ``run.py --trace 1`` this process runs, or
    None."""
    if Path(sys.argv[0]).name != "run.py":
        return None
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--trace", type=int)
    a, _ = ap.parse_known_args(sys.argv[1:])
    if a.workload is None or a.seed is None or a.trace != 1:
        return None
    return a.workload, a.seed


def _in_fresh_process(workload: str, seed: int) -> dict | None:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()),
         "--workload", workload, "--seed", str(seed)],
        cwd=harness.ROOT, capture_output=True, text=True,
        timeout=_FRESH_TIMEOUT_S)
    if proc.returncode != 0:
        print(f"spans: the fresh process failed ({proc.returncode}):\n"
              f"{proc.stderr[-4000:]}", file=sys.stderr)
        return None
    return json.loads(proc.stdout.splitlines()[-1])


def _ms(items) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in items)


def readings(fresh: dict | None, stretches: list, host_call_ms=None,
             out=sys.stderr) -> Readings:
    """The metrics' values from ``fresh_process`` and ``traced``, with
    what they rest on printed to ``out``."""
    r = Readings()
    n = fresh["roots"] if fresh else 0
    if n:
        r.host_ms = {k: v * 1e-3 / n for k, v in fresh["layers"].items()}
        off = statistics.median(h for _, h in fresh["off"])
        on = statistics.median(h for _, h in fresh["on"])
        print(f"spans: {n} root spans in a fresh process, no profiler; host "
              f"ms a call by layer: {_ms(sorted(r.host_ms.items()))}; sum "
              f"{sum(r.host_ms.values()):.4f} against "
              f"{statistics.fmean(h for _, h in fresh['on']):.4f} by the "
              f"caller's clock in the same stretches"
              + (f" and host_call_ms {host_call_ms:.4f} over the window"
                 if host_call_ms else ""), file=out)
        print("spans: self ms a call by span: " + _ms(sorted(
            ((k, v * 1e-3 / n) for k, v in fresh["names"].items()),
            key=lambda kv: -kv[1])), file=out)
        cost = statistics.median(
            h_on / h_off - 1 for (_, h_off), (_, h_on)
            in zip(fresh["off"], fresh["on"]))
        print(f"spans: recording's cost: {100 * cost:+.2f}% of the host "
              f"time a call, the median over pairs of on against off "
              f"({on:.4f} on, {off:.4f} off, medians; "
              f"{fresh['spans'] / n:.1f} spans a call); frames/s off "
              + ", ".join(f"{f:.1f}" for f, _ in fresh["off"]) + "; on "
              + ", ".join(f"{f:.1f}" for f, _ in fresh["on"]), file=out)
    where: dict[str, float] = {}
    delays, after_call = [], []
    for sp, gaps, launched, _ in stretches:
        for k, v in idle_by_span(gaps, sp).items():
            where[k] = where.get(k, 0.0) + v
        delays += launch_delays(launched, sp)
        after_call += [k0 - c0 for _, k0, c0 in launched]
    idle = sum(where.values())
    if idle > 0:
        r.idle_in_program_pct = 100.0 * (1.0 - where.get(CALLER, 0.0) / idle)
        top = sorted(where.items(), key=lambda kv: -kv[1])[:10]
        print(f"spans: traced and recorded, frames/s "
              + ", ".join(f"{t[3]:.1f}" for t in stretches)
              + f"; idle {idle * 1e-3:.3f} ms, "
              f"{r.idle_in_program_pct:.2f}% with the host in the program; "
              f"top 10 by innermost span (ms): "
              + _ms((k, v * 1e-3) for k, v in top), file=out)
    if delays:
        paired = [d for d in delays if d is not None]
        print(f"spans: causality {100 * causal_share(delays):.2f}% of "
              f"{len(delays)} kernels not PyTorch's: launched from inside a "
              f"kernels.launch span and starting no earlier than "
              f"{CAUSAL_SLACK_US} us before it ({len(delays) - len(paired)} "
              f"launched outside any); median launch-to-kernel delay "
              + (f"{statistics.median(paired):.2f} us" if paired else "none")
              + f"; by the profiler's clocks alone, kernel start less launch "
              f"call start: min {min(after_call):.2f}, median "
              f"{statistics.median(after_call):.2f} us", file=out)
        print("spans: causality by stretch: " + ", ".join(
            f"{100 * causal_share(launch_delays(t[2], t[0])):.2f}%"
            for t in stretches if t[2]), file=out)
    if fresh is not None:
        setup = fresh["setup"]
        r.load_s, r.first_launch_s = setup_readings(setup)
        print(f"spans: set-up, first call {setup['first_call_s']:.4f} s by "
              f"the caller's clock; load_s {r.load_s}, first_launch_s "
              f"{r.first_launch_s}:\n  "
              + "\n  ".join(setup_lines([Span(*s)
                                          for s in setup["spans"]])),
              file=out)
    return r


def measure(run) -> Readings | None:
    """The span readings of ``run``, taken once per run."""
    if id(run) in _measured:
        return _measured[id(run)][1]
    r = None
    cmd = _command_line()
    if cmd is None or recorder() is None or not torch.cuda.is_available():
        print("spans: not read (no recorder in the program, or not a run of "
              "run.py --trace 1 on a card)", file=sys.stderr)
    else:
        workload, seed = cmd
        got = traced(harness.load_cell(workload), seed,
                     torch.device("cuda", 0))
        torch.cuda.empty_cache()
        host_call_ms = run.host_s / run.frames * 1e3 if run.frames else None
        r = readings(_in_fresh_process(workload, seed), got, host_call_ms)
    _measured[id(run)] = (run, r)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a cell's first call and its "
                                 "host time by layer, on the card in this "
                                 "fresh process, with the program's spans "
                                 "recorded; prints them as one JSON line")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args(argv)
    cell = harness.load_cell(a.workload)
    print(json.dumps(fresh_process(cell, a.seed, torch.device("cuda", 0))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
