"""The span readings' arithmetic on synthetic spans and traces, the span
metrics reading nothing where there are no spans, and a traced run on the
CPU with and without the program's recorder."""

import io
import json
import time

import pytest
import torch

from bench_torch import harness, spans

TINY = {"height": 72, "width": 96, "ring": 4}
SEED = 2**31 + 77
METRICS = ["host_glue_ms", "host_launch_ms", "host_wrapper_ms",
           "idle_in_program_pct", "load_s", "first_launch_s"]


def _span(i, parent, name, layer, start, end, detail=None, first=False):
    return spans.Span(i, parent, 1, name, layer, start, end, detail, first)


# one call on the profiler's clock (us): the root, the table glue with a
# launch inside it, and a launch of its own
CALL = [_span(1, None, "pipeline.enhance", "entry", 10.0, 100.0),
        _span(2, 1, "clahe.tables", "glue", 20.0, 60.0),
        _span(3, 2, "kernels.launch", "launch", 30.0, 40.0, "tpuimg_a"),
        _span(4, 1, "kernels.launch", "launch", 70.0, 80.0, "tpuimg_b")]


def test_timeline_gives_the_innermost_span():
    assert [(a, b, s.name) for a, b, s in spans.timeline(CALL)] == [
        (10.0, 20.0, "pipeline.enhance"), (20.0, 30.0, "clahe.tables"),
        (30.0, 40.0, "kernels.launch"), (40.0, 60.0, "clahe.tables"),
        (60.0, 70.0, "pipeline.enhance"), (70.0, 80.0, "kernels.launch"),
        (80.0, 100.0, "pipeline.enhance")]


def test_idle_time_goes_to_the_innermost_span_or_the_caller():
    # gaps: before the call, across the table glue and its launch, across
    # the end of the call
    gaps = [(0.0, 5.0), (25.0, 45.0), (90.0, 110.0)]
    where = spans.idle_by_span(gaps, CALL)
    assert where == pytest.approx({
        spans.CALLER: 5.0 + 10.0, "clahe.tables": 5.0 + 5.0,
        "kernels.launch": 10.0, "pipeline.enhance": 10.0})
    assert sum(where.values()) == pytest.approx(5.0 + 20.0 + 20.0)


def test_causality_pairs_each_kernel_with_the_span_of_its_launch_call():
    # (kernel, its start, the start of the call that launched it)
    launched = [("a", 45.0, 33.0), ("b", 79.0, 72.0), ("c", 95.0, 85.0),
                ("d", 65.0, 75.0)]
    delays = spans.launch_delays(launched, CALL)
    # a starts 15 us after its span; b 9 us; c was launched outside any
    # launch span; d starts 5 us before the span its call lies in
    assert delays == [15.0, 9.0, None, -5.0]
    assert spans.causal_share(delays) == 0.5
    assert spans.causal_share([15.0, -1.5]) == 1.0


def test_self_time_and_the_setup_readings():
    assert spans.self_by(CALL, "layer") == {"entry": 90.0 - 40.0 - 10.0,
                                            "glue": 30.0, "launch": 20.0}
    ns = 1_000_000
    setup = {"first_call_s": 0.2, "spans": [
        list(s) for s in [
            _span(1, None, "ops.guided_filter", "entry", 0, 200 * ns),
            _span(2, 1, "guided.prepare", "entry", 0, 150 * ns),
            _span(3, 1, "kernels.launch", "launch", 160 * ns, 190 * ns,
                  "tpuimg_g", True),
            _span(4, 3, "kernels.load", "load", 161 * ns, 181 * ns),
            _span(5, 4, "kernels.build", "load", 162 * ns, 170 * ns)]]}
    load_s, first_s = spans.setup_readings(setup)
    assert load_s == pytest.approx(0.020)
    assert first_s == pytest.approx(0.010)  # the load inside left out
    lines = spans.setup_lines([spans.Span(*s) for s in setup["spans"]])
    assert lines[2].startswith("  kernels.launch tpuimg_g (first) [launch]")
    assert lines[4].startswith("      kernels.build [load] 8.000 ms")


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", METRICS)
def test_span_metrics_read_nothing_without_spans(name):
    # a run that is not run.py's --trace 1 on a card has no spans to read
    assert _metric(name).read(harness.Run({})) is None


@pytest.mark.parametrize("name", ["enhance-4k.live", "guided-4k.stream"])
def test_fresh_process_readings_on_the_cpu(name):
    cell = harness.load_cell(name)
    cell.config.update(TINY)
    got = spans.fresh_process(cell, SEED, torch.device("cpu"), frames=4,
                              pairs=2)
    assert len(got["off"]) == len(got["on"]) == 2 and got["roots"] == 8
    # the JSON line the fresh process prints reads back the same
    got = json.loads(json.dumps(got))
    r = spans.readings(got, [], out=io.StringIO())
    assert set(r.host_ms) == ({"entry", "glue"}
                              if name.startswith("enhance") else {"entry"})
    # the spans lie inside the calls the caller timed
    calls_ms = sum(h for _, h in got["on"]) / len(got["on"])
    assert 0 < sum(r.host_ms.values()) <= calls_ms
    assert r.idle_in_program_pct is None  # no profiler trace without a card
    assert (r.load_s, r.first_launch_s) == (None, None)  # nothing launched
    first = spans.setup_lines([spans.Span(*s) for s in got["setup"]["spans"]])
    assert first[0].startswith(("pipeline.enhance [entry]",
                                "ops.guided_filter [entry]"))


@pytest.mark.parametrize("with_recorder", [True, False])
def test_traced_run_on_the_cpu_completes(monkeypatch, with_recorder):
    from tpuimg_torch import profiling

    if not with_recorder:  # a program from before the recorder
        monkeypatch.delattr(profiling, "recording")
    assert (spans.recorder() is not None) == with_recorder
    cell = harness.load_cell("enhance-4k.live")
    cell.config.update(TINY)
    res = harness.run_cell(cell, SEED, 0.2, True, torch.device("cpu"),
                           time.perf_counter())
    assert res["correct"] is True
    assert not set(METRICS) & set(res["metrics"])
