"""tpuimg_torch.profiling and the host-clock timer, on CPU tensors; device
spans on a fake card."""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from tpuimg_torch import profiling
from tpuimg_torch.core.timing import Timing, time_fn, time_host
from tpuimg_torch.pipeline import enhance
from tpuimg_torch.profiling import trace


def test_host_timer_reports_pixels_and_refuses_cuda_tensors():
    x = torch.zeros((16, 32))
    t = time_fn(lambda v: v + 1, x, iters=4, pixels=x.numel())
    assert t.clock == "host" and t.pixels == 512 and t.gpix_s > 0
    assert Timing(ms=1.0, ms_min=1.0, iters=1, card="cpu").gpix_s is None

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    with pytest.raises(ValueError, match="time_cuda"):
        time_host(lambda v: v, x.as_subclass(FakeCuda))


def test_trace_writes_a_chrome_trace(rng, tmp_path):
    img = torch.from_numpy(rng.integers(0, 256, (64, 96), dtype=np.uint8))
    logdir = str(tmp_path / "trace")
    with trace(logdir) as where:
        out = enhance(img)
    assert where == logdir and out.shape == img.shape
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


# ---- device spans: an event at a span's exit while recording(device=True)

class _FakeStream:
    def __init__(self, handle):
        self.handle = handle


class _FakeEvent:
    """A timing event of a fake card whose streams finish the work queued
    before an event ``lag_ns`` after the host records it."""

    lag_ns = 5_000
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at_ns, self.done = None, True

    def record(self, stream):
        assert isinstance(stream, _FakeStream)
        self.at_ns = profiling.time.perf_counter_ns() + self.lag_ns

    def query(self):
        return self.done

    def synchronize(self):
        while profiling.time.perf_counter_ns() < self.at_ns:
            pass

    def elapsed_time(self, end):
        return (end.at_ns - self.at_ns) / 1e6


@pytest.fixture
def fake_card(monkeypatch):
    """One card with the current stream ``handle[0]``, its events fake."""
    handle = [7]
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(profiling, "_POOLS", {})
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda card=None: _FakeStream(handle[0]))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda card: handle[0], raising=False)
    return handle


def _launches(n, device):
    for i in range(n):
        with profiling.span("op", "entry"):
            with profiling.span("kernels.launch", "launch", f"k{i % 2}",
                                device=device) as s:
                s.queue()


@pytest.mark.parametrize("device", [torch.device("cuda", 0), 0,
                                    torch.device("cuda")])
def test_device_span_is_the_shared_null_with_no_recording(device):
    assert profiling.span("kernels.launch", "launch", "k", False,
                          device) is profiling._NULL
    assert profiling.span("host.upload", "transfer",
                          device=device) is profiling._NULL


def test_plain_recording_records_the_same_spans_and_makes_no_event(
        rng, monkeypatch):
    def no_event(*args, **kw):
        raise AssertionError("a plain recording made a CUDA event")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    img = torch.from_numpy(rng.integers(0, 256, (64, 96), dtype=np.uint8))
    with profiling.recording() as rec:
        enhance(img)
        _launches(3, torch.device("cuda", 0))
    sp = rec.spans
    assert all(type(s) is profiling.Span and len(s) == 9 for s in sp)
    assert profiling.Span._fields == (
        "id", "parent", "root", "name", "layer", "start_ns", "end_ns",
        "detail", "first")
    assert [s.name for s in sp].count("kernels.launch") == 3
    assert rec.intervals() == [] and rec.clock_error_ns is None


def test_bench_spans_read_a_device_recording(rng):
    from bench_torch import spans as bench_spans

    img = torch.from_numpy(rng.integers(0, 256, (64, 96), dtype=np.uint8))
    with profiling.recording() as plain:
        enhance(img)
    with profiling.recording(device=True) as rec:
        enhance(img)  # a CPU frame: no device span, no event
    got = bench_spans.spans_of(rec)
    assert [(s.name, s.layer) for s in got] == [
        (s.name, s.layer) for s in bench_spans.spans_of(plain)]
    assert all(s.start <= s.end for s in got)
    assert rec.intervals() == []


def test_a_device_span_starts_where_it_queues_its_work(fake_card):
    """The interval starts at the event recorded by ``queue()``, after the
    span's own host time before it; a device span that never queues
    records both events at its exit."""
    with profiling.recording(device=True) as rec:
        with profiling.span("kernels.launch", "launch", "k",
                            device=0) as s:
            t0 = time.perf_counter_ns()
            while time.perf_counter_ns() - t0 < 2_000_000:
                pass  # the launch's Python before its C call
            queued = time.perf_counter_ns()
            s.queue()
        with profiling.span("host.upload", "transfer", device=0):
            pass
    (start, end), (start_b, end_b) = [m[3:] for m in rec._marks]
    a, b = rec.intervals()
    err = rec.clock_error_ns
    sa, sb = rec.spans
    assert a.start_ns >= queued - err >= sa.start_ns + 2_000_000 - err
    assert abs(a.start_ns - start.at_ns) <= err + 1
    assert abs(a.end_ns - end.at_ns) <= err + 1
    assert a.start_ns <= a.end_ns
    assert sb.end_ns - err <= b.start_ns <= b.end_ns


def test_device_recording_puts_events_on_the_spans_clock(fake_card):
    made = []
    for _ in range(2):
        with profiling.recording(device=True) as rec:
            _launches(4, torch.device("cuda"))
            fake_card[0] = 9  # the next launches on another stream
            _launches(300, 0)
            fake_card[0] = 7
        # when each event completed by the fake card's clock, the host's
        truth = [(start.at_ns, end.at_ns) for *_, start, end in rec._marks]
        ivs = rec.intervals()
        assert rec.intervals() is ivs  # read once, kept
        spans = {s.id: s for s in rec.spans}
        launches = [s for s in rec.spans if s.name == "kernels.launch"]
        assert [iv.span for iv in ivs] == [s.id for s in launches]
        assert [iv.stream for iv in ivs] == [7] * 4 + [9] * 300
        assert {iv.card for iv in ivs} == {0}
        assert 0 <= rec.clock_error_ns < 10**9
        for iv, (start_ns, end_ns) in zip(ivs, truth):
            s = spans[iv.span]
            # placed within the anchor's window of when each event
            # completed: the first after the span began, the second after
            # it ended
            assert abs(iv.start_ns - start_ns) <= rec.clock_error_ns + 1
            assert abs(iv.end_ns - end_ns) <= rec.clock_error_ns + 1
            assert s.start_ns < start_ns <= end_ns and end_ns > s.end_ns
        made.append(_FakeEvent.made)
    # 304 device spans, two events each: the pool grew past its 256 in the
    # first stretch only
    assert made[0] > 256 and made[1] == made[0]
    assert profiling._POOLS[0].made == made[0]


def test_intervals_refuse_events_not_complete(fake_card):
    with profiling.recording(device=True) as rec:
        _launches(2, 0)
    rec._marks[-1][4].done = False
    with pytest.raises(RuntimeError, match="synchronize"):
        rec.intervals()
