"""The transfer layer's metrics on hand-made traces: copies that overlap
kernels and copies that do not, a copy at exactly the link's rate, copies
up and down at once; and the host time of the transfer spans."""

import pytest

from bench_torch import devtrace, harness, spans

UP = "Memcpy HtoD (Pinned -> Device)"
DOWN = "Memcpy DtoH (Device -> Pinned)"
TAIL = "void tail::tail_kernel<(anonymous namespace)::FrameSrc, 2>(...)"
FILL = "Memset (Device)"
H, W = 2160, 3840
LINK_US = H * W / 64e9 * 1e6  # one 4K u8 frame over one direction


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _run(kernels, frames):
    return harness.Run({"height": H, "width": W},
                       trace=devtrace.Trace(frames, kernels, []))


# two frames, microseconds. Frame 0's copies run alone; frame 1's copy up
# runs under frame 0's tail for 60 of its 150 us, and its copy down wholly
# under a fill
DISJOINT_AND_OVERLAPPED = [
    (UP, 0.0, 150.0), (TAIL, 150.0, 450.0), (DOWN, 450.0, 600.0),
    (UP, 390.0, 540.0), (TAIL, 600.0, 900.0), (FILL, 900.0, 1100.0),
    (DOWN, 920.0, 1070.0)]


def test_copy_device_ms_counts_overlapping_copies_once():
    m = _metric("copy_device_ms")
    got = m.read(_run(DISJOINT_AND_OVERLAPPED, 2))
    # the copies' union: 0-150, 390-600, 920-1070
    assert got == pytest.approx((150 + 210 + 150) / 2 * 1e-3)
    assert m.read(_run([(TAIL, 0.0, 10.0)], 1)) is None
    assert m.read(harness.Run({})) is None


def test_copy_hidden_pct_is_the_copies_share_under_other_work():
    m = _metric("copy_hidden_pct")
    # under other work: 390-450 (the tail) and 920-1070 (the fill)
    got = m.read(_run(DISJOINT_AND_OVERLAPPED, 2))
    assert got == pytest.approx(100 * (60 + 150) / (150 + 210 + 150))
    serial = [(UP, 0.0, 150.0), (TAIL, 150.0, 450.0), (DOWN, 450.0, 600.0)]
    assert m.read(_run(serial, 1)) == pytest.approx(0.0)
    hidden = [(TAIL, 0.0, 450.0), (UP, 100.0, 250.0), (DOWN, 260.0, 410.0)]
    assert m.read(_run(hidden, 1)) == pytest.approx(100.0)
    assert m.read(_run([(TAIL, 0.0, 10.0)], 1)) is None


def test_copy_link_pct_reads_100_at_the_links_rate():
    m = _metric("copy_link_pct")
    assert m.least_ms({"height": H, "width": W}) == pytest.approx(
        2 * LINK_US * 1e-3)
    at_rate = [(UP, 0.0, LINK_US), (TAIL, LINK_US, 400.0),
               (DOWN, 400.0, 400.0 + LINK_US)]
    assert m.read(_run(at_rate, 1)) == pytest.approx(100.0)
    # at half the rate, 50
    slow = [(UP, 0.0, 2 * LINK_US), (DOWN, 400.0, 400.0 + 2 * LINK_US)]
    assert m.read(_run(slow, 1)) == pytest.approx(50.0)


def test_copy_link_pct_stays_at_most_100_with_up_and_down_at_once():
    m = _metric("copy_link_pct")
    # each direction at the link's own rate, both at once: the union of
    # the copies is one copy's time, their sum two
    both = [(UP, 0.0, LINK_US), (DOWN, 0.0, LINK_US)]
    assert m.read(_run(both, 1)) == pytest.approx(100.0)
    # frame 1's copy up under frame 0's copy down, each a little slower
    # than the link
    two = [(UP, 0.0, 1.1 * LINK_US), (DOWN, 50.0, 50.0 + 1.1 * LINK_US),
           (UP, 60.0, 60.0 + 1.1 * LINK_US),
           (DOWN, 120.0, 120.0 + 1.1 * LINK_US)]
    got = m.read(_run(two, 2))
    assert got == pytest.approx(100 / 1.1) and got <= 100.0
    assert m.read(_run([(TAIL, 0.0, 10.0)], 1)) is None


def test_host_transfer_ms_reads_the_transfer_layer(monkeypatch):
    m = _metric("host_transfer_ms")
    monkeypatch.setattr(spans, "measure", lambda run: spans.Readings(
        host_ms={"entry": 0.2, "transfer": 0.04}))
    assert m.read(harness.Run({})) == 0.04
    monkeypatch.setattr(spans, "measure",
                        lambda run: spans.Readings(host_ms={"entry": 0.2}))
    assert m.read(harness.Run({})) is None
    monkeypatch.setattr(spans, "measure", lambda run: None)
    assert m.read(harness.Run({})) is None
