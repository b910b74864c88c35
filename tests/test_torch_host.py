"""tpuimg_torch.enhance_host on the CPU: the same frames as enhance for
NumPy and CPU tensor inputs, within the benchmark's limits of its plain
reference, its spans and byte counters, and its typed errors. Its streams,
pinned memory and completion order are tested on the card in
tests/test_torch_cuda.py."""

import json

import numpy as np
import pytest
import torch

import tpuimg_torch
from bench_torch import reference
from bench_torch.harness import HERE as BENCH_DIR
from tpuimg_torch import enhance, enhance_host, profiling
from tpuimg_torch.core.validate import DeviceError, DTypeError, ShapeError

SHAPES = [(72, 96), (33, 50)]
KINDS = ["numpy", "tensor", "strided"]


def _frame(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _as(kind, frame):
    if kind == "numpy":
        return frame
    if kind == "tensor":
        return torch.from_numpy(frame.copy())
    # a non-contiguous view of a wider frame holding the same pixels
    wide = np.zeros((frame.shape[0], 2 * frame.shape[1]), np.uint8)
    wide[:, ::2] = frame
    return torch.from_numpy(wide)[:, ::2]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_equals_enhance_bit_for_bit(shape, kind):
    frame = _frame(shape, 11)
    got = enhance_host(_as(kind, frame), "cpu")
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    assert torch.equal(got, enhance(torch.from_numpy(frame)))


@pytest.mark.parametrize("params", [
    {}, {"tiles": 4, "radius": 1, "gf_radius": 4, "impl": "staged"}])
def test_passes_enhances_parameters(params):
    frame = _frame((72, 96), 12)
    assert torch.equal(enhance_host(frame, "cpu", **params),
                       enhance(torch.from_numpy(frame), **params))


@pytest.mark.parametrize("shape", SHAPES)
def test_within_the_benchmarks_limits_of_the_plain_reference(shape):
    cfg = json.loads((BENCH_DIR / "configs" / "enhance-4k-h2d.json")
                     .read_text())
    frame = _frame(shape, 13)
    got = enhance_host(frame, "cpu", **cfg["params"])
    want = reference.enhance(torch.from_numpy(frame), **cfg["params"])
    gaps = reference.u8_gaps(got, want)
    for name, limit in cfg["limits"].items():
        assert gaps[name] <= limit, (name, gaps)


def test_output_is_a_frame_of_its_own():
    frame = torch.from_numpy(_frame((72, 96), 14))
    out = enhance_host(frame, "cpu")
    want = out.clone()
    frame.zero_()  # the caller reuses its input after the call
    again = enhance_host(frame, "cpu")
    assert torch.equal(out, want)
    assert again.data_ptr() != out.data_ptr()


def test_spans_a_root_with_enhance_and_the_transfers_inside():
    frame = _frame((72, 96), 15)
    with profiling.recording() as rec:
        enhance_host(frame, "cpu")
    spans = rec.spans
    root = spans[0]
    assert (root.name, root.layer, root.parent) == (
        "host.enhance", "entry", None)
    assert all(s.root == root.id for s in spans)
    inside = [(s.name, s.layer) for s in spans if s.parent == root.id]
    # nothing is staged on the CPU: pinning needs a card
    assert inside == [("host.upload", "transfer"),
                      ("pipeline.enhance", "entry"),
                      ("host.download", "transfer")]
    (pipe,) = [s for s in spans if s.name == "pipeline.enhance"]
    assert [s.name for s in spans if s.parent == pipe.id][0] == "clahe.hist"
    assert "transfer" in profiling.LAYERS


def test_byte_counters_add_up():
    # nothing is staged on the CPU: pinning needs a card
    before = enhance_host.staged_bytes
    sizes = [(72, 96), (33, 50), (72, 96)]
    for i, shape in enumerate(sizes):
        enhance_host(_as(KINDS[i], _frame(shape, 16 + i)), "cpu")
    assert enhance_host.staged_bytes - before == 0


def test_public_and_typed_errors(monkeypatch):
    assert tpuimg_torch.enhance_host is enhance_host
    assert "enhance_host" in tpuimg_torch.__all__
    frame = _frame((72, 96), 17)
    with pytest.raises(ShapeError):
        enhance_host(np.stack([frame, frame]), "cpu")
    with pytest.raises(DTypeError):
        enhance_host(frame.astype(np.float32), "cpu")
    with pytest.raises(DeviceError):
        enhance_host(frame, "meta")
    with pytest.raises(DeviceError):  # a frame already on a device
        enhance_host(torch.empty((72, 96), dtype=torch.uint8,
                                 device="meta"), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(DeviceError):
            enhance_host(frame, device)
