"""The cell of frames that live on the host, driven end to end on the CPU
at test_harness.py's tiny size with the configuration's own limits: the
program comes out correct and reports the cell's end-to-end metrics, while
the control (the reference in bfloat16 in the program's place) and a
planted fault come out not correct."""

import torch

from bench_torch import control, harness
from bench_torch.tests.test_harness import SECONDS, SEED, TINY

CELL = "enhance-4k-h2d.stream"


def _cell():
    cell = harness.load_cell(CELL)
    cell.config.update(TINY)
    return cell


def _run(cell, entry=None):
    import time

    return harness.run_cell(cell, SEED, SECONDS, False, torch.device("cpu"),
                            time.perf_counter(), entry=entry)


def test_ring_lives_on_the_host_and_names_the_device():
    cell = _cell()
    args = cell.module.make_args(cell.config, SEED, torch.device("cpu"))
    assert len(args) == TINY["ring"]
    for frame, device in args:
        assert frame.device.type == "cpu" and frame.dtype == torch.uint8
        assert frame.shape == (TINY["height"], TINY["width"])
        assert device == torch.device("cpu")


def test_program_is_correct():
    res = _run(_cell())
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_control_is_not_correct():
    cell = _cell()
    res = _run(cell, control.control_entry(cell, torch.bfloat16))
    assert res["correct"] is False, res["checks"]


def test_input_returned_unchanged_is_not_correct():
    res = _run(_cell(), lambda frame, device: frame)
    assert res["correct"] is False, res["checks"]
