"""The work counts of the roofline metrics, from shapes: at 4K they give
the bounds that chip_smoke.py prints for the enhance tail (0.0198 ms) and
the guided filter with a distinct guide (0.0297 ms), both bound by bytes."""

import json

import pytest

from bench_torch import harness, roofline

CONFIGS = harness.HERE / "configs"


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_operation_counts():
    assert roofline.gauss_ops(2) == 14
    assert roofline.guided_ops(4) == 36
    assert roofline.guided_ops(2) == 28


@pytest.mark.parametrize("metric,config,ms", [
    ("tail_roofline", "enhance-4k", 0.0198),
    ("guided_roofline", "guided-4k", 0.0297)])
def test_least_time_at_4k(metric, config, ms):
    cfg = _config(config)
    assert (cfg["height"], cfg["width"]) == (2160, 3840)
    least = _metric(metric).least_ms(cfg)
    assert round(least, 4) == ms
    n = 2160 * 3840
    bytes_ms = (8 if metric == "tail_roofline" else 12) * n / 3.35e12 * 1e3
    assert least == pytest.approx(bytes_ms)  # bound by bytes


def test_least_time_at_8k_is_four_times_4k():
    cfg = _config("enhance-8k")
    assert (cfg["height"], cfg["width"]) == (4320, 7680)
    least = _metric("tail_roofline").least_ms(cfg)
    assert round(least, 4) == 0.0792
    assert least == pytest.approx(4 * _metric("tail_roofline").least_ms(
        _config("enhance-4k")))


def test_share_is_none_without_device_time():
    assert roofline.share(0.02, 0.0) is None
    assert roofline.share(0.02, 0.2) == pytest.approx(10.0)
