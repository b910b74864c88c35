"""The cell of batched histogram equalization, driven end to end on the CPU
at a tiny size (3 frames of 72x96 a call) with the configuration's own
limits: the program comes out correct, while the control (the reference in
bfloat16 in the program's place) and one table entry of one frame off by
one come out not correct. Its two metrics: the least time from the shapes,
and nothing to read without recorded spans."""

import time

import pytest
import torch

from bench_torch import control, devtrace, harness
from bench_torch.tests.test_harness import SECONDS, SEED, TINY

CELL = "he-1080p-b16.stream"
SMALL = {**TINY, "batch": 3}


def _cell():
    cell = harness.load_cell(CELL)
    cell.config.update(SMALL)
    return cell


def _run(cell, entry=None):
    return harness.run_cell(cell, SEED, SECONDS, False, torch.device("cpu"),
                            time.perf_counter(), entry=entry)


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_cell_finds_its_files_metrics_and_traffic():
    cell = harness.load_cell(CELL)
    cfg = cell.config
    assert (cfg["name"], cfg["entry"]) == ("he-1080p-b16",
                                          "tpuimg_torch.hist_equalize")
    assert (cfg["batch"], cfg["height"], cfg["width"]) == (16, 1080, 1920)
    assert (cfg["ring"], cfg["sample"], cfg["reduced"]) == (8, 16, [])
    assert cfg["limits"] == {"max_step": 0, "off_share": 0.0}
    assert set(cfg["limits_why"]) == set(cfg["limits"])
    assert cell.chips == 1
    assert (cell.traffic["loop"], cell.traffic["in_flight"]) == ("closed", 4)
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s",
                                                     "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"he_host_ms", "he_roofline", "host_call_ms",
            "kernels_per_frame", "device_idle_pct"} <= per_layer
    assert not per_layer & {"glue_device_ms", "host_glue_ms",
                            "tail_roofline", "host_launch_ms"}


def test_ring_holds_distinct_stacks():
    cell = _cell()
    args = cell.module.make_args(cell.config, SEED, torch.device("cpu"))
    assert len(args) == SMALL["ring"]
    for (stack,) in args:
        assert stack.dtype == torch.uint8 and stack.is_contiguous()
        assert stack.shape == (SMALL["batch"], SMALL["height"],
                               SMALL["width"])
    frames = torch.cat([a[0] for a in args])
    assert len({f.numpy().tobytes() for f in frames}) == len(frames)
    again = cell.module.make_args(cell.config, SEED, torch.device("cpu"))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(args, again))


def test_reference_takes_the_exact_quotient():
    """A flat frame maps to 255 (min before rounding); a 16x32 frame whose
    histogram alternates 1, 3 has cdf * 256 / 512 ending in .5 at every
    even value, rounded to even."""
    mod = _cell().module
    flat = torch.full((1, 40, 50), 77, dtype=torch.uint8)
    assert bool((mod.reference(None, flat, torch.float64) == 255).all())
    counts = torch.tensor([1, 3]).repeat(128)
    img = torch.repeat_interleave(torch.arange(256), counts).to(
        torch.uint8).reshape(1, 16, 32)
    table = mod.table(img[0], torch.float64)
    assert table[:3].tolist() == [0, 2, 2]  # rint(0.5), rint(2.0), rint(2.5)


def test_program_is_correct():
    res = _run(_cell())
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {c["value"] for c in res["checks"].values()} == {0.0}
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_control_is_not_correct():
    cell = _cell()
    res = _run(cell, control.control_entry(cell, torch.bfloat16))
    assert res["correct"] is False, res["checks"]
    assert all(c["value"] > c["limit"] for c in res["checks"].values())


def test_one_table_entry_off_by_one_is_not_correct():
    """Every call: the table entry of frame 0's first pixel, one step off."""
    from tpuimg_torch.kernels.hist import hist256_frames
    from tpuimg_torch.kernels.lut import lut_gather_frames
    from tpuimg_torch.ops.histogram import _he_tables

    def faulty(imgs):
        tables = _he_tables(hist256_frames(imgs), imgs[0].numel())
        v = int(imgs[0, 0, 0])
        tables[0, v] += 1 if tables[0, v] < 255 else -1
        return lut_gather_frames(tables, imgs)

    res = _run(_cell(), faulty)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["max_step"]["value"] == 1.0


def test_he_roofline_counts_the_stack_from_the_shapes():
    """2 bytes a pixel of 16 1080p frames: 0.0198 ms, bound by bytes; read
    over every device op a call, PyTorch's included."""
    cfg = harness.load_cell(CELL).config
    mod = _metric("he_roofline")
    least = mod.least_ms(cfg)
    assert least == pytest.approx(2 * 16 * 1080 * 1920 / 3.35e12 * 1e3,
                                  rel=1e-12)
    assert round(least, 4) == 0.0198
    run = harness.Run(cfg)
    assert mod.read(run) is None
    run.trace = devtrace.Trace(2, [
        ("void hist256_kernel(...)", 0.0, 40.0),
        ("at::native::cumsum", 40.0, 50.0),
        ("void lut_gather_kernel(...)", 45.0, 110.0)], [])
    assert mod.read(run) == pytest.approx(100 * least / 0.055)


def test_he_host_ms_reads_nothing_without_spans():
    mod = _metric("he_host_ms")
    assert mod.read(harness.Run(harness.load_cell(CELL).config)) is None


@pytest.mark.parametrize("host_ms, want", [
    ({"entry": 0.02, "glue": 0.03, "launch": 0.01}, 0.06),
    ({"entry": 0.02, "launch": 0.01}, 0.03),
    ({"launch": 0.01}, None)])
def test_he_host_ms_sums_the_layers_of_its_root(monkeypatch, host_ms, want):
    """The layers present are summed; launches with no root of the
    program's own around them (the parent's hist_equalize) read nothing."""
    from bench_torch import spans

    monkeypatch.setattr(spans, "measure",
                        lambda run: spans.Readings(host_ms=host_ms))
    got = _metric("he_host_ms").read(harness.Run({}))
    assert got == (None if want is None else pytest.approx(want))
