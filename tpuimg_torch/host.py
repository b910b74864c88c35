"""Frames that live on the host: ``enhance`` of a host frame into a pinned
host frame, the copies overlapped with other frames' kernels.

A video pipeline keeps its frames in host memory: a CPU decoder writes
them, and an encoder or a display reads the enhanced frames back.
``enhance_host`` takes such a frame and returns its enhanced frame in
pinned host memory. On the card each call runs wholly on one stream of a
small per-device pool, frame i on stream i mod ``POOL_STREAMS``: the copy
up, ``enhance``'s launches (``kernels.launch`` takes the current stream)
and the copy down. An event recorded after the copy down is then waited on
by the caller's current stream. So the completion contract of every kernel
wrapper holds: the call does not synchronise, and the output is complete,
and the input free to reuse, once the caller's stream reaches the point
after the call. A pool stream never waits on the caller's stream: that
stream holds the earlier frames' waits, and waiting on it would serialize
every frame. The input's bytes must therefore be in place when the call is
made.

Pinned memory comes from PyTorch's caching host allocator, which records
the event of each asynchronous copy that uses a block and hands the block
out again only once that event has completed. A pageable input is first
copied on the host into such a block (``host.stage``); each output is a
block of its own, so an output the caller still holds is never written
again. On the device, ``enhance`` allocates what it uses on the stream that
uses it, and its one workspace kept between calls (``kernels/hist.py``) is
kept per stream, so the pool's streams share no device buffer.

``device="cpu"`` takes the same steps with the CPU as the device and
``enhance``'s plain path; nothing is staged, since pinning needs a card.
"""

from __future__ import annotations

import contextlib

import torch

from tpuimg_torch.core.validate import DeviceError, ShapeError, check_image
from tpuimg_torch.pipeline import enhance
from tpuimg_torch.profiling import span

POOL_STREAMS = 4


class _Pool:
    """A device's streams, each with the event that marks its last frame
    done, handed out in turn."""

    def __init__(self, device: torch.device):
        self.streams = [torch.cuda.Stream(device)
                        for _ in range(POOL_STREAMS)]
        self.done = [torch.cuda.Event() for _ in range(POOL_STREAMS)]
        self.turn = 0

    def next(self) -> tuple[torch.cuda.Stream, torch.cuda.Event]:
        i = self.turn
        self.turn = (i + 1) % POOL_STREAMS
        return self.streams[i], self.done[i]


_POOLS: dict[int, _Pool] = {}  # device index -> its pool


def _target(device) -> torch.device:
    """The device a call runs on: the current CUDA device for None."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise DeviceError(f"enhance_host runs on a CUDA card or the CPU, "
                          f"not {device}")
    if not torch.cuda.is_available():
        raise DeviceError("enhance_host runs on the CUDA card and there is "
                          "none; pass device='cpu' to run on the CPU")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _host_frame(frame) -> torch.Tensor:
    """``frame`` as a contiguous u8 (H, W) CPU tensor; a NumPy array shares
    its memory."""
    if isinstance(frame, torch.Tensor):
        if frame.device.type != "cpu":
            raise DeviceError(f"enhance_host takes a frame on the host, got "
                              f"one on {frame.device}; call enhance")
    else:
        frame = torch.as_tensor(frame)
    check_image(frame, "frame", dtypes=[torch.uint8])
    if frame.ndim != 2:
        raise ShapeError(f"enhance_host takes a single (H, W) frame, got "
                         f"shape {tuple(frame.shape)}")
    return frame.contiguous()


def enhance_host(
    frame,
    device=None,
    *,
    clip_limit: float = 2.0,
    tiles: int = 8,
    radius: int = 2,
    sigma: float = 1.5,
    gf_radius: int = 8,
    gf_eps: float = 1e-3,
    impl: str = "fused",
) -> torch.Tensor:
    """``enhance`` of a u8 (H, W) host frame (a pinned or pageable CPU
    tensor, or a NumPy array) on ``device`` (None: the current CUDA
    device), returned as a u8 CPU tensor, pinned on the card. On the card
    the output is complete once the caller's current stream reaches the
    point after the call, and only then may the caller reuse the input."""
    with span("host.enhance", "entry"):
        target = _target(device)
        cuda = target.type == "cuda"
        card = target if cuda else None  # the copies' device spans
        src = _host_frame(frame)
        if cuda and not src.is_pinned():
            with span("host.stage", "transfer"):
                staged = torch.empty(src.shape, dtype=torch.uint8,
                                     pin_memory=True)
                staged.copy_(src)
            src = staged
            enhance_host.staged_bytes += src.numel()
        if cuda:
            pool = _POOLS.get(target.index)
            if pool is None:
                pool = _POOLS[target.index] = _Pool(target)
            stream, done = pool.next()
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            with span("host.upload", "transfer", device=card) as s:
                up = torch.empty(src.shape, dtype=torch.uint8, device=target)
                s.queue()
                up.copy_(src, non_blocking=True)
            out = enhance(up, clip_limit, tiles, radius, sigma, gf_radius,
                          gf_eps, impl)
            with span("host.download", "transfer", device=card) as s:
                back = torch.empty(out.shape, dtype=torch.uint8,
                                   pin_memory=cuda)
                s.queue()
                back.copy_(out, non_blocking=True)
            if cuda:
                done.record(stream)
        if cuda:
            torch.cuda.current_stream(target).wait_event(done)
        return back


# bytes of pageable frames copied on the host into pinned memory, over every
# call: the slow path, where the caller's frames are not pinned
enhance_host.staged_bytes = 0
