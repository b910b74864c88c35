"""Each cell driven end to end on the CPU at a tiny size with the
configuration's own limits: the program comes out correct, the control
(the reference in bfloat16 in the program's place) and each fault planted
in the timed path come out not correct; the command refuses without a card
and in a checkout without the program; nothing imports JAX or tpuimg."""

import ast
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench_torch import control, harness

CELLS = ["enhance-4k.live", "guided-4k.stream", "enhance-8k.stream"]
TINY = {"height": 72, "width": 96, "ring": 4}
SEED = 2**31 + 77
SECONDS = 0.3


def _cell(name):
    cell = harness.load_cell(name)
    cell.config.update(TINY)
    return cell


def _run(cell, entry=None, seed=SEED):
    return harness.run_cell(cell, seed, SECONDS, False, torch.device("cpu"),
                            time.perf_counter(), entry=entry)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    res = _run(_cell(name))
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {m["name"] for m in harness.load_cell(name).end_to_end} == set(
        res["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = _cell(name)
    res = _run(cell, control.control_entry(cell, torch.bfloat16))
    assert res["correct"] is False, res["checks"]


def _unchanged(cell, real):
    # a step that returns its input unchanged: enhance's frame, guided's p
    return lambda *args: args[-1]


def _half_left_out(cell, real):
    # every other frame's output is never computed
    count = iter(range(10**9))

    def fn(*args):
        out = real(*args)
        return torch.zeros_like(out) if next(count) % 2 else out
    return fn


def _altered(cell, real):
    # each answer altered where it is produced, at one pixel: its u8 value
    # half the range away (wrapping), or a float value by 0.5
    step = 128 if cell.config["name"].startswith("enhance") else 0.5

    def fn(*args):
        out = real(*args)
        out[3, 5] += step
        return out
    return fn


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_are_not_correct(name, fault):
    cell = _cell(name)
    res = _run(cell, fault(cell, cell.module.entry(cell.config)))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", ["enhance-4k.live", "enhance-8k.stream"])
def test_a_few_pixels_three_steps_off_are_not_correct(name):
    # a fault too small for max_step and off_share: four pixels of every
    # frame three steps off, as a seam of the blend or a tile edge would be
    cell = _cell(name)
    real = cell.module.entry(cell.config)

    def fn(*args):
        out = real(*args)
        patch = out[10:12, 20:22].int()
        out[10:12, 20:22] = torch.where(patch > 127, patch - 3,
                                        patch + 3).to(torch.uint8)
        return out
    res = _run(cell, fn)
    checks = res["checks"]
    assert checks["max_step"]["value"] <= checks["max_step"]["limit"]
    assert checks["off_share"]["value"] <= checks["off_share"]["limit"]
    assert checks["wide_share"]["value"] > checks["wide_share"]["limit"]
    assert res["correct"] is False


def test_control_script_readings():
    cell = _cell("guided-4k.stream")
    got = control.readings(cell, 3, SECONDS, torch.device("cpu"))
    bad = control.readings(cell, 4, SECONDS, torch.device("cpu"),
                           control.control_entry(cell, torch.bfloat16))
    limit = cell.config["limits"]["max_abs"]
    assert got["max_abs"] < limit < bad["max_abs"]
    s = control.summary([got], [bad])
    assert s["max_abs"] == {"program_max": got["max_abs"],
                            "control_min": bad["max_abs"]}
    assert control.seeds("1-3,7") == [1, 2, 3, 7]


def test_report_prints_the_checks_last(capsys):
    harness.report({"correct": False, "checks": {
        "max_abs": {"value": float("inf"), "limit": 1e-4}}})
    out, err = capsys.readouterr()
    assert json.loads(out.splitlines()[-1])["checks"]["max_abs"] == {
        "value": "inf", "limit": 1e-4}
    assert err.splitlines()[-1] == "check max_abs inf limit 0.0001"


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, *extra, "bench_torch/run.py", "--workload",
         CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    proc = _command(harness.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


FAKE_CARD = ("import runpy, sys, torch; torch.cuda.is_available = lambda: "
             "True; torch.cuda.device_count = lambda: 1; sys.argv = "
             "sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')")


def test_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path, "-c", FAKE_CARD)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "tpuimg_torch" in proc.stderr


def test_foreign_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpuimg_torch_probe", sys)
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    monkeypatch.setitem(sys.modules, "tpuimg.kernels", sys)
    assert harness.foreign_modules() == ["flax", "tpuimg"]


def test_no_jax_or_tpuimg_import():
    for path in harness.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "tpuimg"), (
                    f"{path} imports {name}")
    probe = ("import sys, time, torch; from bench_torch import harness; "
             "c = harness.load_cell('enhance-4k.live'); "
             f"c.config.update({TINY!r}); harness.run_cell(c, 1, 0.1, False, "
             "torch.device('cpu'), time.perf_counter()); "
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'tpuimg')))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
