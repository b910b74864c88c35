"""BENCHMARK.json against the rules of its format and its limits, and every
name in it against a file of the harness that reads it."""

import json
import re

import pytest
import torch

from bench_torch import harness, reference

BENCH_PATH = harness.ROOT / "BENCHMARK.json"
BENCH = json.loads(BENCH_PATH.read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH_PATH.stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (harness.ROOT / word).is_file()


def test_run_seconds_fit_a_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        path = harness.ROOT / c["file"]
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert path.with_suffix(".py").is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    assert len({w["name"] for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    metrics = BENCH[group]
    assert 1 <= len(metrics) <= (16 if group == "end_to_end" else 128)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        keys = ({"name", "unit", "better", "bound", "source"}
                if group == "end_to_end" else
                {"name", "unit", "better", "source", "layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert _line(m["layer"]) and m["moves"] in e2e
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_listed_cells_report_what_the_metric_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        moves = e2e[m.get("moves", m["name"])]
        for name in m.get("workloads", []):
            assert name in moves.get("workloads", [name]), (m["name"], name)


@pytest.mark.parametrize("name", ["enhance-4k", "enhance-8k"])
def test_enhance_limits_are_the_numbers_compared(name):
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    frame = torch.zeros((2, 3), dtype=torch.uint8)
    assert set(reference.u8_gaps(frame, frame)) == set(cfg["limits"])
    # a single wrong row of a 4K frame fails wide_share tenfold
    assert cfg["limits"]["wide_share"] <= 0.1 / 2160
