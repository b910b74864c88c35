"""The interval readings' arithmetic on synthetic intervals and spans, the
interval metrics reading nothing where there are no device spans, and the
fresh process's stretches on the CPU."""

import io
import json

import pytest
import torch

from bench_torch import harness, intervals, spans
from tpuimg_torch import profiling

METRICS = ["device_idle_events_pct", "idle_in_program_events_pct"]
TINY = {"height": 72, "width": 96, "ring": 4}
SEED = 2**31 + 91


def _span(i, parent, root, name, layer, start, end, detail=None):
    return spans.Span(i, parent, root, name, layer, start, end, detail,
                      False)


# two calls on the spans' clock (ns): each a root with a launch inside it;
# the second call's launch on a second stream as well as a copy
CALLS = [_span(1, None, 1, "pipeline.enhance", "entry", 100, 200),
         _span(2, 1, 1, "kernels.launch", "launch", 150, 180, "tpuimg_a"),
         _span(3, None, 3, "host.enhance", "entry", 400, 600),
         _span(4, 3, 3, "host.upload", "transfer", 420, 440),
         _span(5, 3, 3, "kernels.launch", "launch", 450, 470, "tpuimg_a")]


def _iv(span, stream, start, end):
    return profiling.Interval(span, 0, stream, start, end)


# the launch of call 1 runs 150-300; call 2's copy 420-500 on stream 8 and
# its launch 450-700 on stream 7: the card idles 300-420
INTERVALS = [_iv(2, 7, 150, 300), _iv(4, 8, 420, 500), _iv(5, 7, 450, 700)]


def test_busy_is_the_union_over_streams_and_idle_the_rest():
    pieces = intervals.busy(INTERVALS + [_iv(5, 9, 460, 460)])
    assert pieces == [(150, 300), (420, 700)]
    assert intervals.gaps(pieces) == [(300, 420)]
    # 120 ns idle in a window of 550
    assert intervals.idle_pct(pieces) == pytest.approx(100 * 120 / 550)
    assert intervals.idle_pct([]) is None


def test_idle_goes_to_the_innermost_span_or_the_caller():
    got = intervals.stretch(INTERVALS, CALLS, 5)
    # 300-400 the host was in no span, 400-420 in host.enhance
    assert got["where"] == {spans.CALLER: 100, "host.enhance": 20}
    assert got["in_program_pct"] == pytest.approx(100 * 20 / 120)
    assert got["entries"] == {"tpuimg_a": 150 + 250, "host.upload": 80}
    assert (got["intervals"], got["roots"], got["causal"]) == (3, 2, 1.0)


def test_a_stretch_with_no_idle_time_reads_none_in_the_program():
    got = intervals.stretch([_iv(2, 7, 150, 300), _iv(5, 7, 300, 700)],
                            CALLS, 5)
    assert got["idle_pct"] == 0.0 and got["in_program_pct"] == 0.0


# one call's launches of two C entries, a and b, on stream 7 and a copy on
# stream 8 (ns): the card idles before spans 2 and 5, queued work otherwise
QUEUED_SPANS = [_span(1, None, 1, "ops.x", "entry", 0, 500_000)] + [
    _span(i, 1, 1, "kernels.launch", "launch", 1_000 * i, 1_000 * i + 500,
          "tpuimg_b" if i % 2 else "tpuimg_a") for i in range(2, 8)] + [
    _span(8, 1, 1, "host.upload", "transfer", 9_000, 9_500)]
QUEUED = [_iv(2, 7, 100_000, 150_000), _iv(3, 7, 151_000, 181_000),
          _iv(4, 7, 182_000, 222_000), _iv(5, 7, 300_000, 340_000),
          _iv(6, 7, 340_500, 382_500), _iv(7, 7, 383_000, 415_000),
          _iv(8, 8, 100_000, 200_000)]


def test_queued_times_come_from_intervals_behind_other_work():
    # a stream's first interval, and one after the card went idle, do not
    # count; the copy has none
    assert intervals.queued_ns(QUEUED, QUEUED_SPANS) == {
        "tpuimg_b": 31_000, "tpuimg_a": 41_000}


def test_trim_starts_an_interval_its_queued_time_before_its_end():
    queued = {"tpuimg_b": 31_000, "tpuimg_a": 41_000}
    got = intervals.trim(QUEUED, QUEUED_SPANS, queued)
    # queued intervals keep their start
    assert [iv[3] for iv in got] == [
        109_000, 151_000, 182_000, 309_000, 340_500, 383_000, 100_000]
    assert [iv[:3] + iv[4:] for iv in got] == [
        iv[:3] + iv[4:] for iv in QUEUED]
    # the trimmed stretch: the idle 222,000-309,000 and the 500 ns before
    # each of spans 6 and 7 are in ops.x, and the causality is the raw
    # intervals'
    raw = intervals.stretch(QUEUED, QUEUED_SPANS, 5)
    cut = intervals.stretch(QUEUED, QUEUED_SPANS, 5, queued)
    assert intervals.busy(got) == [(100_000, 222_000), (309_000, 340_000),
                                   (340_500, 382_500), (383_000, 415_000)]
    assert cut["where"]["ops.x"] == 88_000 and cut["in_program_pct"] == 100
    assert raw["where"]["ops.x"] == 79_000
    assert cut["entries"]["tpuimg_b"] == 30_000 + 31_000 + 32_000
    assert cut["causal"] == raw["causal"] == 1.0


def test_span_cost_is_the_median_extra_host_time_a_device_span(
        monkeypatch):
    """``span_cost`` against a recorder whose device spans each take 50 us
    more host time than a plain span."""
    import contextlib
    import time as clock

    class Span:
        def __init__(self, extra_ns):
            self.extra_ns = extra_ns

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def queue(self):
            t0 = clock.perf_counter_ns()
            while clock.perf_counter_ns() - t0 < self.extra_ns:
                pass

    class Rec:
        def intervals(self):
            return []

    class Prof:
        on = False

        @contextlib.contextmanager
        def recording(self, device=False):
            self.on = device
            yield Rec()

        def span(self, name, layer, detail=None, first=False, device=None):
            return Span(50_000 if self.on and device is not None else 0)

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    cost = intervals.span_cost(Prof(), torch.device("cuda", 0), n=40)
    assert 40_000 <= cost < 5_000_000
    assert synced == [torch.device("cuda", 0)] * 8  # after each recording


def _fresh(stretches, errors=None):
    return {"off": [(100.0, 0.5)] * 2, "on": [(90.0, 0.6)] * 2,
            "stretches": stretches, "span_cost_ns": 1500.0,
            "clock_error_ns": errors or [5] * len(stretches)}


def test_readings_take_the_median_over_stretches():
    a = intervals.stretch(INTERVALS, CALLS, 5)
    b = intervals.stretch([_iv(2, 7, 150, 300), _iv(5, 7, 450, 700)],
                          CALLS, 5)
    out = io.StringIO()
    r = intervals.readings(json.loads(json.dumps(_fresh([a, b, a]))), out)
    assert r.idle_pct == pytest.approx(a["idle_pct"])
    assert r.in_program_pct == pytest.approx(a["in_program_pct"])
    text = out.getvalue()
    assert "clock_error_ns" in text and "causality 100.00" in text
    assert "(caller)" in text and "tpuimg_a" in text
    assert "1.500 us beyond a plain span" in text


def test_readings_are_none_where_causality_breaks():
    # call 2's launch ends at 390, before its span began at 450, by more
    # than the clock's error
    broken = intervals.stretch(
        [_iv(2, 7, 150, 300), _iv(5, 7, 450, 390)], CALLS, 5)
    assert broken["causal"] == 0.5
    good = intervals.stretch(INTERVALS, CALLS, 5)
    out = io.StringIO()
    r = intervals.readings(_fresh([good, broken]), out)
    assert (r.idle_pct, r.in_program_pct) == (None, None)
    assert "causality 100.00, 50.00%" in out.getvalue()
    # within the clock's error it holds
    assert intervals.stretch([_iv(5, 7, 450, 446)], CALLS, 5)["causal"] == 1


def test_readings_are_none_without_intervals():
    empty = intervals.stretch([], CALLS, None)
    assert empty["idle_pct"] is None and empty["causal"] is None
    r = intervals.readings(_fresh([empty]), io.StringIO())
    assert (r.idle_pct, r.in_program_pct) == (None, None)


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", METRICS)
def test_interval_metrics_read_nothing_off_a_card(name):
    assert _metric(name).read(harness.Run({})) is None


def test_a_program_without_device_spans_has_no_recorder(monkeypatch):
    import contextlib

    assert intervals.recorder() is profiling

    @contextlib.contextmanager
    def recording():  # the recorder of a program from before device spans
        yield None

    monkeypatch.setattr(profiling, "recording", recording)
    assert spans.recorder() is profiling and intervals.recorder() is None
    monkeypatch.delattr(profiling, "recording")
    assert intervals.recorder() is None


def test_fresh_process_on_the_cpu_has_no_intervals():
    cell = harness.load_cell("he-1080p-b16.stream")
    cell.config.update(TINY, batch=2)
    got = intervals.fresh_process(cell, SEED, torch.device("cpu"), frames=3,
                                  pairs=2)
    assert len(got["off"]) == len(got["on"]) == len(got["stretches"]) == 2
    assert got["span_cost_ns"] is None
    assert [s["roots"] for s in got["stretches"]] == [3, 3]
    r = intervals.readings(json.loads(json.dumps(got)), io.StringIO())
    assert (r.idle_pct, r.in_program_pct) == (None, None)
