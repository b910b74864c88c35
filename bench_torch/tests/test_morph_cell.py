"""The cell of batched grayscale opening, driven end to end on the CPU at a
tiny size (2 frames of 72x96 a call, r 3) with the configuration's own
limits: the program comes out correct; a radius one short, erode alone and
a zero border in the program's place come out not correct, while the
control (the reference in bfloat16) reads 0 and 0, as a minimum or a
maximum of small integers rounds nothing. Its two metrics: the least time
from the shapes, and nothing to read without recorded spans."""

import time

import pytest
import torch
import torch.nn.functional as F

from bench_torch import control, devtrace, harness
from bench_torch.tests.test_harness import SECONDS, SEED, TINY

CELL = "morph-open-4k-b2.stream"
R = 3
SMALL = {**TINY, "batch": 2, "params": {"radius": R}}


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
    assert (cfg["name"], cfg["entry"]) == ("morph-open-4k-b2",
                                          "tpuimg_torch.morph_open")
    assert (cfg["batch"], cfg["height"], cfg["width"]) == (2, 2160, 3840)
    assert cfg["params"] == {"radius": 15}
    assert (cfg["ring"], cfg["sample"], cfg["reduced"]) == (16, 16, [])
    assert cfg["limits"] == {"max_step": 0, "off_share": 0.0}
    assert set(cfg["limits_why"]) == set(cfg["limits"])
    assert cell.chips == 1
    assert (cell.traffic["loop"], cell.traffic["in_flight"]) == ("closed", 4)
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s",
                                                     "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"morph_host_ms", "morph_roofline", "host_call_ms",
            "kernels_per_frame", "device_idle_pct", "device_idle_events_pct",
            "idle_in_program_events_pct"} <= per_layer
    assert not per_layer & {"he_host_ms", "he_roofline", "glue_device_ms",
                            "host_glue_ms", "tail_roofline"}


def test_ring_holds_distinct_stacks():
    cell = _cell()
    args = cell.module.make_args(cell.config, SEED, torch.device("cpu"))
    assert len(args) == SMALL["ring"]
    for (stack,) in args:
        assert stack.dtype == torch.uint8 and stack.is_contiguous()
        assert stack.shape == (2, SMALL["height"], SMALL["width"])
    frames = torch.cat([a[0] for a in args])
    assert len({f.numpy().tobytes() for f in frames}) == len(frames)
    again = cell.module.make_args(cell.config, SEED, torch.device("cpu"))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(args, again))


def test_reference_opens_by_the_square():
    """A bright 5x5 speck and a 1-pixel line vanish under a 7x7 opening; a
    9x9 block and a strip along the frame's edge stay, at their own
    values."""
    mod = _cell().module
    img = torch.full((1, 40, 50), 20, dtype=torch.uint8)
    img[0, 5:10, 5:10] = 200  # speck, narrower than the square
    img[0, 20, :] = 90  # scratch
    img[0, 25:34, 30:39] = 150  # block, wider than the square
    # a strip 4 wide at the edge: the replicate border widens it past 7
    img[0, :, -4:] = 60
    got = mod.reference(SMALL, img, torch.float64)
    want = torch.full_like(img, 20)
    want[0, 25:34, 30:39] = 150
    want[0, :, -4:] = 60
    assert torch.equal(got, want)


def test_program_is_correct():
    res = _run(_cell())
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {c["value"] for c in res["checks"].values()} == {0.0}
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_control_reads_zero():
    """bfloat16 holds every integer from 0 to 256, and a minimum or a
    maximum rounds nothing: the control cannot fail this configuration."""
    cell = _cell()
    res = _run(cell, control.control_entry(cell, torch.bfloat16))
    assert res["correct"] is True, res["checks"]
    assert {c["value"] for c in res["checks"].values()} == {0.0}


def _zero_border_open(imgs):
    """Each stage over a border of zeros in place of the replicate one."""
    from tpuimg_torch.kernels.sep_stencil import _extreme_pass

    def stage(x, mode):
        p = F.pad(x, (R, R, R, R))
        return _extreme_pass(_extreme_pass(p, R, 2, mode), R, 1, mode)

    return stage(stage(imgs, 0), 1)


def _faults():
    import tpuimg_torch

    return {"radius one short": lambda x: tpuimg_torch.morph_open(x, R - 1),
            "erode alone": lambda x: tpuimg_torch.erode(x, R),
            "zero border": _zero_border_open}


@pytest.mark.parametrize("fault", ["radius one short", "erode alone",
                                   "zero border"])
def test_fault_in_the_programs_place_is_not_correct(fault):
    res = _run(_cell(), _faults()[fault])
    assert res["correct"] is False, res["checks"]
    assert all(c["value"] > c["limit"] for c in res["checks"].values())


def test_morph_roofline_counts_the_stack_from_the_shapes():
    """2 bytes a pixel of two 4K frames: 0.0099 ms, bound by bytes over the
    12 compares a pixel; read over every device op a call."""
    cfg = harness.load_cell(CELL).config
    mod = _metric("morph_roofline")
    least = mod.least_ms(cfg)
    n = 2 * 2160 * 3840
    assert least == pytest.approx(2 * n / 3.35e12 * 1e3, rel=1e-12)
    assert 12 * n / 67e12 * 1e3 == pytest.approx(0.0030, abs=5e-5)
    assert round(least, 4) == 0.0099
    run = harness.Run(cfg)
    assert mod.read(run) is None
    run.trace = devtrace.Trace(2, [
        ("void open_close_kernel(...)", 0.0, 125.0),
        ("void open_close_kernel(...)", 125.0, 250.0)], [])
    assert mod.read(run) == pytest.approx(100 * least / 0.125)


def test_morph_host_ms_reads_nothing_without_spans():
    mod = _metric("morph_host_ms")
    assert mod.read(harness.Run(harness.load_cell(CELL).config)) is None


@pytest.mark.parametrize("host_ms, want", [
    ({"entry": 0.02, "launch": 0.01}, 0.03),
    ({"entry": 0.02}, 0.02),
    ({"launch": 0.01}, None)])
def test_morph_host_ms_sums_the_layers_of_its_root(monkeypatch, host_ms,
                                                   want):
    """The layers present are summed; launches with no root of the
    program's own around them (the parent's morph_open) read nothing."""
    from bench_torch import spans

    monkeypatch.setattr(spans, "measure",
                        lambda run: spans.Readings(host_ms=host_ms))
    got = _metric("morph_host_ms").read(harness.Run({}))
    assert got == (None if want is None else pytest.approx(want))
