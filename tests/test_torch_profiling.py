"""tpuimg_torch.profiling and the host-clock timer, on CPU tensors."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from tpuimg_torch.core.timing import Timing, time_fn, time_host
from tpuimg_torch.pipeline import enhance
from tpuimg_torch.profiling import trace


def test_host_timer_reports_pixels_and_refuses_cuda_tensors():
    x = torch.zeros((16, 32))
    t = time_fn(lambda v: v + 1, x, iters=4, pixels=x.numel())
    assert t.clock == "host" and t.pixels == 512 and t.gpix_s > 0
    assert Timing(ms=1.0, ms_min=1.0, iters=1, card="cpu").gpix_s is None

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    with pytest.raises(ValueError, match="time_cuda"):
        time_host(lambda v: v, x.as_subclass(FakeCuda))


def test_trace_writes_a_chrome_trace(rng, tmp_path):
    img = torch.from_numpy(rng.integers(0, 256, (64, 96), dtype=np.uint8))
    logdir = str(tmp_path / "trace")
    with trace(logdir) as where:
        out = enhance(img)
    assert where == logdir and out.shape == img.shape
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
