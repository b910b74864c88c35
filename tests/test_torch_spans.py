"""The span recorder of tpuimg_torch.profiling, on CPU tensors: off it
records nothing; on, the public entries (morphology's too) record their
steps as a tree; the launch and load spans; self time by layer; the clock
pair; the spans in a written trace."""

import collections
import contextlib
import glob
import itertools
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import spans as bench_spans
import tpuimg_torch
from tpuimg_torch import (
    enhance, guided_filter, hist_equalize, kernels, profiling)
from tpuimg_torch.ops.morphology import morph_ypadded

# the fused paths above the tail's gate scale the blend in clahe_map's store
# and round q in the tail's: no enhance.scale or enhance.to_u8 glue
ENHANCE_STEPS = {
    "fused": ["clahe.hist", "clahe.tables", "clahe.map", "enhance.tail"],
    "fused1": ["clahe.hist", "clahe.tables", "enhance.tail"],
    "staged": ["clahe.hist", "clahe.tables", "clahe.map", "enhance.scale",
               "enhance.gaussian", "ops.guided_filter", "enhance.to_u8"],
}


def _frame(rng, h=72, w=96):
    return torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8))


def test_off_span_is_one_shared_object_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
    first = profiling.span("a", "entry")
    assert profiling.span("b", "glue", "detail", True) is first
    with first as got:
        assert got is first
    assert profiling._recorder is None


def test_off_records_nothing_and_on_changes_no_result(rng):
    img = _frame(rng)
    off = enhance(img)
    with profiling.recording() as rec:
        on = enhance(img)
    assert torch.equal(on, off)
    after = len(rec.spans)
    enhance(img)
    assert len(rec.spans) == after and profiling._recorder is None


@pytest.mark.parametrize("impl", list(ENHANCE_STEPS))
def test_enhance_records_one_root_a_call_with_its_steps(rng, impl):
    img = _frame(rng)
    with profiling.recording() as rec:
        enhance(img, impl=impl)
        enhance(img, impl=impl)
    sp = rec.spans
    roots = [s for s in sp if s.parent is None]
    assert [r.name for r in roots] == ["pipeline.enhance"] * 2
    assert all(r.layer == "entry" and r.root == r.id for r in roots)
    for root in roots:
        tree = [s for s in sp if s.root == root.id and s is not root]
        children = [s for s in tree if s.parent == root.id]
        assert [s.name for s in children] == ENHANCE_STEPS[impl]
        for s in tree:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert {s.name: s.layer for s in children if s.layer == "glue"} == {
            n: "glue" for n in ENHANCE_STEPS[impl]
            if n in ("clahe.tables", "enhance.scale", "enhance.to_u8")}
    ids = [s.id for s in sp]
    assert len(set(ids)) == len(ids)


@pytest.mark.parametrize("border, steps", [
    ("reflect101", ["guided.prepare", "guided.kernel"]),
    ("shrink", ["guided.prepare", "guided.kernel"])])
def test_guided_filter_records_its_root_and_steps(rng, border, steps):
    I = torch.from_numpy(rng.random((40, 56), dtype=np.float32))
    p = torch.from_numpy(rng.random((40, 56), dtype=np.float32))
    off = guided_filter(I, p, 4, 1e-3, border)
    with profiling.recording() as rec:
        on = guided_filter(I, p, 4, 1e-3, border)
    assert torch.equal(on, off)
    root, *rest = rec.spans
    assert (root.name, root.layer, root.parent) == (
        "ops.guided_filter", "entry", None)
    assert [(s.name, s.parent, s.root) for s in rest] == [
        (n, root.id, root.id) for n in steps]
    assert rest[-1].detail == border  # the kernel's span names the border


@pytest.mark.parametrize("shape", [(40, 56), (3, 40, 56)])
def test_hist_equalize_records_its_root_and_steps(rng, shape):
    """One root ``ops.hist_equalize`` a call, a frame or a stack, with the
    histogram, the table glue and the mapping inside it; the output is the
    one recording off gives."""
    img = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    off = hist_equalize(img)
    assert profiling.span("ops.hist_equalize", "entry") is profiling._NULL
    with profiling.recording() as rec:
        on = hist_equalize(img)
    assert torch.equal(on, off)
    root, *rest = rec.spans
    assert (root.name, root.layer, root.parent) == (
        "ops.hist_equalize", "entry", None)
    assert [(s.name, s.layer, s.parent, s.root) for s in rest] == [
        ("he.hist", "entry", root.id, root.id),
        ("he.tables", "glue", root.id, root.id),
        ("he.map", "entry", root.id, root.id)]
    for s in rest:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns


MORPH_ROOTS = {"erode": "ops.erode", "dilate": "ops.dilate",
               "morph_open": "ops.morph_open",
               "morph_close": "ops.morph_close", "morph_ypadded": None}


@pytest.mark.parametrize("op", list(MORPH_ROOTS))
def test_morphology_records_its_root_and_kernel(rng, op):
    """Each public morphology op records one root of its own name with one
    ``morph.kernel`` inside it; ``morph_ypadded``, the per-shard op, records
    its ``morph.kernel`` alone, inside its caller's root. Recording off, the
    spans are the shared do-nothing object and record nothing; the output
    is the one recording off gives."""
    img = torch.from_numpy(rng.integers(0, 256, (2, 40, 56), dtype=np.uint8))
    fn, args = ((morph_ypadded, (img, 3, 0)) if op == "morph_ypadded"
                else (getattr(tpuimg_torch, op), (img, 3)))
    root_name = MORPH_ROOTS[op] or "caller"
    off = fn(*args)
    for name in (root_name, "morph.kernel"):
        assert profiling.span(name, "entry") is profiling._NULL
    with profiling.recording() as rec:
        with (profiling.span(root_name, "entry") if op == "morph_ypadded"
              else contextlib.nullcontext()):
            on = fn(*args)
    assert torch.equal(on, off)
    root, *rest = rec.spans
    assert (root.name, root.layer, root.parent) == (root_name, "entry", None)
    assert [(s.name, s.layer, s.parent, s.root) for s in rest] == [
        ("morph.kernel", "entry", root.id, root.id)]
    assert root.start_ns <= rest[0].start_ns <= rest[0].end_ns <= root.end_ns
    fn(*args)
    assert len(rec.spans) == 2 and profiling._recorder is None


def test_span_refuses_an_unknown_layer_while_recording():
    with profiling.recording():
        with pytest.raises(ValueError, match="layer"):
            profiling.span("x", "kernels")


def test_nested_recordings_take_the_spans_until_they_end():
    with profiling.recording() as outer:
        with profiling.span("a", "entry"):
            pass
        with profiling.recording() as inner:
            with profiling.span("b", "entry"):
                pass
        with profiling.span("c", "entry"):
            pass
    assert [s.name for s in outer.spans] == ["a", "c"]
    assert [s.name for s in inner.spans] == ["b"]


def _ticking(monkeypatch, step_ns=1000):
    ticks = itertools.count(0, step_ns)
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(ticks))


def test_self_time_by_layer_on_nested_spans(monkeypatch):
    with profiling.recording() as rec:
        _ticking(monkeypatch)  # each clock read 1 us after the one before
        with profiling.span("root", "entry"):  # 0 .. 9000
            with profiling.span("tables", "glue"):  # 1000 .. 4000
                with profiling.span("launch", "launch"):  # 2000 .. 3000
                    pass
            with profiling.span("to_u8", "glue"):  # 5000 .. 6000
                pass
            with profiling.span("tail", "entry"):  # 7000 .. 8000
                pass
    sp = bench_spans.spans_of(rec)
    assert [(s.start, s.end) for s in sp] == [
        (0, 9000), (1000, 4000), (2000, 3000), (5000, 6000), (7000, 8000)]
    assert bench_spans.self_by(sp, "layer") == {
        "entry": 4000 + 1000, "glue": 2000 + 1000,
        "launch": 1000}
    by_layer = bench_spans.self_by(sp, "layer")
    assert sum(by_layer.values()) == 9000  # the roots' time, read inside
    assert bench_spans.self_by(sp, "name")["tables"] == 2000


def test_clock_pair_puts_spans_on_the_profilers_clock():
    rec = profiling.Recorder()
    rec.wall_ns, rec.perf_ns = 1_700_000_000_000_000_000, 5_000
    assert rec.epoch_ns(7_500) == 1_700_000_000_000_002_500
    trace_start_ns = 1_699_999_999_999_000_000
    # 1 ms of wall clock between the trace's start and the recorder's
    assert bench_spans.to_trace_us(5_000, rec.wall_ns, rec.perf_ns,
                                   trace_start_ns) == 1000.0
    assert bench_spans.to_trace_us(7_500, rec.wall_ns, rec.perf_ns,
                                   trace_start_ns) == 1002.5
    sp = [bench_spans.Span(1, None, 1, "a", "entry", 5_000, 7_500, None,
                           False)]
    (moved,) = bench_spans.on_trace(sp, rec.wall_ns, rec.perf_ns,
                                    trace_start_ns)
    assert (moved.start, moved.end) == (1000.0, 1002.5)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def tpuimg_fake(self, *args):
        self.calls.append(args)
        return 0


def test_launch_and_load_spans(monkeypatch):
    fake = _FakeLib()
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "launches", collections.Counter())
    monkeypatch.setattr(kernels, "build", lambda: Path("libfake.so"))
    monkeypatch.setattr(kernels, "bind", lambda path: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(kernels, "_stream", lambda index: 7)
    with profiling.recording() as rec:
        for _ in range(2):
            kernels.launch("tpuimg_fake", torch.device("cpu"), 1, 2)
    assert fake.calls == [(1, 2, 7)] * 2
    first, load, build, second = rec.spans
    assert (first.name, first.layer, first.detail, first.first) == (
        "kernels.launch", "launch", "tpuimg_fake", True)
    assert (second.detail, second.first) == ("tpuimg_fake", False)
    assert (load.name, load.layer, load.parent) == (
        "kernels.load", "load", first.id)
    assert (build.name, build.layer, build.parent) == (
        "kernels.build", "load", load.id)
    with profiling.recording() as again:
        kernels.load()  # loaded: no span
    assert again.spans == []


def test_trace_puts_the_spans_beside_the_ops(tmp_path, rng):
    logdir = str(tmp_path / "trace")
    a = torch.from_numpy(rng.random((128, 128), dtype=np.float32))
    with profiling.trace(logdir):
        with profiling.span("test.matmul", "glue"):
            a @ a
    assert profiling._recorder is None
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (mine,) = [e for e in events if e.get("cat") == "tpuimg_span"]
    (op,) = [e for e in events if e.get("name") == "aten::mm"]
    assert mine["name"] == "test.matmul" and mine["ph"] == "X"
    assert mine["args"]["layer"] == "glue"
    assert mine["tid"] != op["tid"]  # a track of their own
    assert mine["ts"] <= op["ts"]
    assert op["ts"] + op["dur"] <= mine["ts"] + mine["dur"]
