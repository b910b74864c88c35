"""The cell of RGB frames by their gray guide at the shrink border, driven
end to end on the CPU at test_harness.py's tiny size with the
configuration's own limits: the program comes out correct and reports the
cell's end-to-end metrics, while the control (the reference in bfloat16 in
the program's place), p returned unchanged and the reflect-101 border in
the program's place come out not correct."""

import functools
import time

import torch

from bench_torch import control, harness
from bench_torch.tests.test_harness import SECONDS, SEED, TINY

CELL = "guided-rgb-shrink-4k.stream"


def _cell():
    cell = harness.load_cell(CELL)
    cell.config.update(TINY)
    return cell


def _run(cell, entry=None):
    return harness.run_cell(cell, SEED, SECONDS, False, torch.device("cpu"),
                            time.perf_counter(), entry=entry)


def test_ring_holds_rgb_sources_and_their_luma():
    cell = _cell()
    args = cell.module.make_args(cell.config, SEED, torch.device("cpu"))
    assert len(args) == TINY["ring"]
    h, w = TINY["height"], TINY["width"]
    for I, p in args:
        assert I.dtype == p.dtype == torch.float32
        assert I.shape == (h, w) and p.shape == (3, h, w)
        assert I.is_contiguous() and p.is_contiguous()
        assert float(p.min()) >= 0.0 and float(p.max()) <= 1.0
        luma = 0.299 * p[0] + 0.587 * p[1] + 0.114 * p[2]
        assert torch.equal(I, luma)
    # each channel carries its own noise
    _, p = args[0]
    assert not torch.equal(p[0], p[1])


def test_entry_takes_the_default_border():
    import inspect

    import tpuimg_torch

    fn = _cell().module.entry(_cell().config)
    assert "border" not in fn.keywords
    default = inspect.signature(tpuimg_torch.guided_filter).parameters[
        "border"].default
    assert default == "shrink"


def test_reference_means_windows_clamped_to_the_frame():
    """box_mean of ones is one everywhere (each sum over its own area), and
    a corner's mean covers the (r + 1)^2 pixels inside the frame."""
    mod = _cell().module
    x = torch.arange(35, dtype=torch.float64).reshape(5, 7)
    assert torch.equal(mod.box_mean(torch.ones(5, 7, dtype=torch.float64), 2),
                       torch.ones(5, 7, dtype=torch.float64))
    assert float(mod.box_mean(x, 2)[0, 0]) == float(x[:3, :3].mean())
    assert float(mod.box_mean(x, 9)[2, 3]) == float(x.mean())


def test_program_is_correct():
    res = _run(_cell())
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_control_is_not_correct():
    cell = _cell()
    res = _run(cell, control.control_entry(cell, torch.bfloat16))
    assert res["correct"] is False, res["checks"]


def test_source_returned_unchanged_is_not_correct():
    res = _run(_cell(), lambda I, p: p)
    assert res["correct"] is False, res["checks"]


def test_reflect101_border_is_not_correct():
    import tpuimg_torch

    cell = _cell()
    res = _run(cell, functools.partial(tpuimg_torch.guided_filter,
                                       **cell.config["params"],
                                       border="reflect101"))
    assert res["correct"] is False, res["checks"]


def test_shrink_roofline_counts_the_function_from_the_shapes():
    """28 bytes a 4K pixel (I, 3 planes of p and of q, f32): 0.0693 ms,
    bound by bytes; read over the walker kernels a frame, nothing where
    none ran (the parent's plain chain)."""
    from bench_torch import devtrace

    cfg = harness.load_cell(CELL).config
    mod = harness.load_module(harness.HERE / "metrics" / "shrink_roofline.py")
    least = mod.least_ms(cfg)
    assert abs(least - 4 * 7 * 2160 * 3840 / 3.35e12 * 1e3) < 1e-12
    run = harness.Run(cfg)
    assert mod.read(run) is None
    run.trace = devtrace.Trace(2, [
        ("void guided_twopass_kernel<true, true, true>(...)", 0.0, 1000.0),
        ("void guided_twopass_kernel<false, true, true>(...)", 1000.0,
         2000.0),
        ("at::native::tensor_kernel_scan_outer_dim<float>", 2000.0, 9000.0)],
        [])
    assert abs(mod.read(run) - 100 * least / 1.0) < 1e-9
    run.trace = devtrace.Trace(2, [("at::native::cumsum", 0.0, 9000.0)], [])
    assert mod.read(run) is None


def test_guided_host_ms_reads_nothing_off_a_traced_card_run():
    mod = harness.load_module(harness.HERE / "metrics" / "guided_host_ms.py")
    assert mod.read(harness.Run(harness.load_cell(CELL).config)) is None
