"""The metrics' arithmetic on a recorded trace and on a run's clocks, the
breakdown, and the profiler's trace taken again when it caught nothing."""

import types

import pytest

from bench_torch import devtrace, harness

TAIL = "void tail::tail_kernel<(anonymous namespace)::FrameSrc, 2>(...)"
HIST = "void (anonymous namespace)::tile_hist_kernel<8>(...)"
CLAMP = "void at::native::vectorized_elementwise_kernel<4, clamp>(...)"
SCAN = "void at_cuda_detail::cub::DeviceScanKernel<...>(...)"
WALK = "void (anonymous namespace)::guided_walk_kernel<8>(...)"

# two frames, microseconds: a histogram, glue (two spans overlapping), the
# tail; idle gaps of 10 and 30 us
KERNELS = [(HIST, 0.0, 10.0), (CLAMP, 20.0, 30.0), (SCAN, 25.0, 35.0),
           (TAIL, 35.0, 135.0), (HIST, 165.0, 175.0), (CLAMP, 175.0, 185.0),
           (TAIL, 185.0, 285.0)]
HOST = [("cudaLaunchKernel", 12.0, 22.0), ("cudaEventSynchronize",
                                            131.0, 169.0)]


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _run(trace=None, **kw):
    cfg = {"height": 2160, "width": 3840,
           "params": {"radius": 2, "gf_radius": 8}}
    return harness.Run(cfg, trace=trace, **kw)


def test_busy_counts_overlap_once_and_idle_is_the_rest():
    tr = devtrace.Trace(2, KERNELS, HOST)
    assert devtrace.busy(KERNELS) == pytest.approx(10 + 15 + 100 + 10 + 10
                                                   + 100)
    assert devtrace.span(tr) == 285.0
    assert devtrace.idle_gaps(tr) == [(10.0, 20.0), (135.0, 165.0)]
    idle = _metric("device_idle_pct").read(_run(tr))
    assert idle == pytest.approx(100 * 40 / 285)


def test_glue_is_pytorchs_device_work():
    tr = devtrace.Trace(2, KERNELS, HOST)
    assert [devtrace.is_torch(k[0]) for k in KERNELS] == [
        False, True, True, False, False, True, False]
    assert devtrace.is_torch("Memset (Device)")
    assert _metric("glue_device_ms").read(_run(tr)) == pytest.approx(
        (15 + 10) / 2 * 1e-3)
    assert _metric("kernels_per_frame").read(_run(tr)) == 3.5


def test_rooflines_read_their_own_kernels():
    tr = devtrace.Trace(2, KERNELS, HOST)
    tail = _metric("tail_roofline")
    least = tail.least_ms(_run().config)
    assert tail.read(_run(tr)) == pytest.approx(100 * least / 0.1)
    # no guided kernel in this trace: the guided roofline reads nothing
    assert _metric("guided_roofline").read(_run(tr)) is None
    walk = devtrace.Trace(1, [(WALK, 0.0, 280.0)], [])
    assert _metric("guided_roofline").read(_run(walk)) == pytest.approx(
        100 * 0.0297 / 0.28, rel=2e-3)


def test_device_metrics_read_nothing_without_a_trace():
    for name in ("kernels_per_frame", "glue_device_ms", "tail_roofline",
                 "guided_roofline", "device_idle_pct"):
        assert _metric(name).read(_run()) is None


def test_clock_metrics():
    run = _run(frames=4, window_s=0.004, host_s=0.002, setup_s=7.5,
               latencies_s=[0.001 * k for k in range(1, 21)])
    assert _metric("frames_per_s").read(run) == pytest.approx(1000.0)
    assert _metric("host_call_ms").read(run) == pytest.approx(0.5)
    assert _metric("setup_s").read(run) == 7.5
    assert _metric("frame_ms_p95").read(run) == pytest.approx(19.0)
    assert _metric("frames_per_s").read(_run()) is None


def test_breakdown_names_what_the_host_was_doing():
    tr = devtrace.Trace(2, KERNELS, HOST)
    bd = devtrace.breakdown(tr)
    assert bd["device_ops"][0] == [
        devtrace.short(TAIL), pytest.approx(200e-6)]
    assert bd["idle_gaps"] == [
        ["cudaEventSynchronize", pytest.approx(30e-6)],
        ["cudaLaunchKernel", pytest.approx(10e-6)]]
    assert devtrace.host_doing(tr, 100.0) == "host in Python, no runtime call"
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


class _FakeProfile:
    """Stands in for torch.profiler.profile: its traces come from a list,
    an empty one first, as the profiler now and then returns."""

    traces: list = []

    def __init__(self, activities):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        from torch.autograd import DeviceType

        return [types.SimpleNamespace(
            name=n, device_type=DeviceType.CUDA,
            time_range=types.SimpleNamespace(start=a, end=b))
            for n, a, b in self.traces.pop(0)]


def test_an_empty_trace_is_taken_again(monkeypatch):
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    calls = []
    _FakeProfile.traces = [[], [], [(TAIL, 0.0, 5.0)]]
    tr = devtrace.capture(lambda: calls.append(1), 1)
    assert len(calls) == 3 and tr.kernels == [(TAIL, 0.0, 5.0)]
    _FakeProfile.traces = [[], [], [], [(TAIL, 0.0, 5.0)]]
    assert devtrace.capture(lambda: calls.append(1), 1) is None
    assert len(calls) == 6
