"""One run of one cell: set-up, the measured window, the traced stretch, and
the comparison with the plain reference.

A cell is found by its name in BENCHMARK.json: its configuration (a JSON
file of sizes and parameters, and beside it a module of the same name with
the ring of inputs, the program's entry and the plain reference), its
traffic mix (``traffic/<mix>.json``) and its metrics (``metrics/<name>.py``,
each with ``read(run)``). Adding a configuration, a mix or a metric adds
files and entries and edits none.

The loop is closed: the caller keeps ``in_flight`` frames submitted, and
before it submits another it waits for the oldest (with one in flight, for
the frame it just submitted). Each frame's output is held until the caller
has seen it complete. A call that raises ends the run without a result.
"""

from __future__ import annotations

import collections
import gc
import importlib.util
import json
import math
import random
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from bench_torch import devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRAFFIC_KEYS = {"loop", "in_flight", "why"}
# packages the run may not hold: the JAX package the port was made from,
# and JAX itself, compared by whole top-level names (``tpuimg_torch`` is
# the port)
FOREIGN = ("jax", "jaxlib", "flax", "tpuimg")
WARM_FRAMES = 32  # through the loop, after every output size is allocated
TRACE_FRAMES = 100  # the traced stretch of a --trace 1 run
REFERENCE_DTYPE = torch.float64


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    module: object
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclass
class Run:
    """What the metrics' readers read."""
    config: dict
    setup_s: float = 0.0
    frames: int = 0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    host_s: float = 0.0
    trace: devtrace.Trace | None = None


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_torch._" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json, with its files."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    path = ROOT / conf["file"]
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown or traffic["loop"] != "closed" or traffic["in_flight"] < 1:
        raise ValueError(f"traffic {w['traffic']!r}: this generator runs "
                         f"closed loops of at least one frame in flight; "
                         f"unknown keys {sorted(unknown)}")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, w["chips"], json.loads(path.read_text()),
                load_module(path.with_suffix(".py")), traffic, e2e,
                per_layer)


class Marks:
    """Completion marks: CUDA events, recorded after each call on the
    current stream; on the CPU a call is complete when it returns."""

    def __init__(self, device: torch.device, n: int):
        self.events = ([torch.cuda.Event() for _ in range(n)]
                       if device.type == "cuda" else None)

    def mark(self, i: int):
        if self.events is None:
            return None
        ev = self.events[i % len(self.events)]
        ev.record()
        return ev

    @staticmethod
    def wait(ev) -> None:
        if ev is not None:
            ev.synchronize()


class Sample:
    """A uniform sample of ``k`` frames' outputs drawn from the seed over
    every frame seen (reservoir sampling), and the last frame."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.kept, self.seen, self.last = [], 0, None

    def offer(self, i: int, out) -> None:
        self.seen += 1
        self.last = (i, out)
        if len(self.kept) < self.k:
            self.kept.append((i, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = (i, out)

    def frames(self) -> list:
        picked = dict(self.kept)
        if self.last is not None:
            picked.setdefault(*self.last)
        return sorted(picked.items(), key=lambda kv: kv[0])


def drive(fn, args: list, in_flight: int, marks: Marks, sample: Sample,
          run: Run | None = None, deadline: float | None = None,
          count: int = 0, first: int = 0) -> int:
    """Submit frames of the ring ``args`` through ``fn`` until ``deadline``
    (perf_counter) or for ``count`` frames, keeping ``in_flight`` in
    flight, then wait for the rest. Adds frames, window, latencies and host
    time to ``run``. Returns the index after the last frame."""
    clock = time.perf_counter
    pending = collections.deque()
    lat, host, ring, i = [], 0.0, len(args), first

    def retire():
        k, out, ev, t_in = pending.popleft()
        marks.wait(ev)
        lat.append(clock() - t_in)
        sample.offer(k, out)

    t0 = clock()
    while clock() < deadline if deadline is not None else i < first + count:
        if len(pending) == in_flight:
            retire()
        t_in = clock()
        out = fn(*args[i % ring])
        host += clock() - t_in
        pending.append((i, out, marks.mark(i), t_in))
        i += 1
    while pending:
        retire()
    if run is not None:
        run.window_s += clock() - t0
        run.frames += i - first
        run.latencies_s += lat
        run.host_s += host
    return i


def compare(cell: Cell, sample: Sample, seed: int, device) -> dict:
    """The widest reading of each number over the sampled frames, against
    the reference run on inputs made again from the seed."""
    mod, cfg = cell.module, cell.config
    args = mod.make_args(cfg, seed, device)
    worst: dict = {}
    for i, out in sample.frames():
        expected = mod.reference(cfg, *args[i % len(args)],
                                 dtype=REFERENCE_DTYPE)
        for name, value in mod.compare(out, expected).items():
            worst[name] = max(worst.get(name, -math.inf), value)
        del expected
    return worst


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, entry=None) -> dict:
    """One run; returns the result line as a dict. ``entry`` stands in for
    the program's entry point (the control, the tests' faults)."""
    cfg, mod = cell.config, cell.module
    in_flight = cell.traffic["in_flight"]
    cuda = device.type == "cuda"
    steps = [("imports", time.perf_counter())]

    def step(name):
        if cuda:
            torch.cuda.synchronize(device)
        steps.append((name, time.perf_counter()))

    fn = entry if entry is not None else mod.entry(cfg)
    step("program import")
    args = mod.make_args(cfg, seed, device)
    step("ring")
    marks = Marks(device, in_flight + 1)
    fn(*args[0])
    step("first call")
    # every output the window holds at once (the sample, the frames in
    # flight) allocated once before it, then the loop itself
    held = [fn(*args[i % len(args)])
            for i in range(cfg["sample"] + in_flight + 2)]
    del held
    nxt = drive(fn, args, in_flight, marks, Sample(0, 0), count=WARM_FRAMES)
    step("warm-up")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.freeze()
    run = Run(cfg)
    sample = Sample(cfg["sample"], seed ^ 0x5EED)
    run.setup_s = time.perf_counter() - t_start
    print("set-up: " + ", ".join(
        f"{name} {t - before:.3f} s" for (_, before), (name, t)
        in zip([("start", t_start)] + steps, steps)), file=sys.stderr)
    nxt = drive(fn, args, in_flight, marks, sample, run,
                deadline=time.perf_counter() + seconds, first=nxt)
    attempted = run.frames
    if trace and cuda:
        stretch = Run(cfg)

        def traced():
            drive(fn, args, in_flight, marks, sample, stretch,
                  count=TRACE_FRAMES, first=nxt)
            torch.cuda.synchronize(device)

        run.trace = devtrace.capture(traced, TRACE_FRAMES)
        attempted += stretch.frames
        print(f"traced stretch: {stretch.frames} frames, "
              f"{stretch.frames / stretch.window_s:.1f} frames/s under the "
              f"profiler", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del args, fn
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = compare(cell, sample, seed, device)
    t_ref = time.perf_counter() - t_ref
    limits = cfg["limits"]
    checks = {name: {"value": readings.get(name), "limit": limit}
              for name, limit in limits.items()}
    correct = bool(sample.seen) and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values())
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = devtrace.busy(run.trace.kernels) * 1e-6
        dev["window_s"] = devtrace.span(run.trace) * 1e-6
        result["breakdown"] = devtrace.breakdown(run.trace)
    result["checks"] = checks
    lat = sorted(run.latencies_s)
    print(f"{cell.name} seed {seed}: {run.frames} frames in "
          f"{run.window_s:.3f} s, set-up {run.setup_s:.3f} s, "
          f"{len(sample.frames())} frames compared in {t_ref:.3f} s; "
          f"latency ms median "
          f"{lat[len(lat) // 2] * 1e3:.4f}, p99 "
          f"{lat[int(0.99 * len(lat))] * 1e3:.4f}, max {lat[-1] * 1e3:.4f}",
          file=sys.stderr)
    return result


def foreign_modules() -> list[str]:
    """The top-level names of ``FOREIGN`` that this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def report(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(plain(result), allow_nan=False), flush=True)


def plain(x):
    """``x`` with every infinite or NaN float written as a string, which
    JSON can hold."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x
