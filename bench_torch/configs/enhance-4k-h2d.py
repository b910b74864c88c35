"""enhance-4k-h2d: ``tpuimg_torch.enhance_host`` on u8 4K frames that live
in a pinned host ring, uploaded, enhanced and downloaded, and its plain
reference beside it."""

import functools

import torch

from bench_torch import frames, reference as ref


def make_args(cfg, seed, device):
    """The ring, made on ``device`` and copied into host memory (pinned
    when ``device`` is a card): one (frame, device) tuple per distinct
    frame, so that the program runs where the run does."""
    ring = frames.scene_ring(cfg["ring"], cfg["height"], cfg["width"], seed,
                             device)
    host = torch.empty(ring.shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    host.copy_(ring)  # waits for the copy: the frames are in place
    return [(host[i], device) for i in range(cfg["ring"])]


def entry(cfg):
    """The program's entry point with the configuration's parameters; what
    it leaves to its defaults (the implementation) stays its own."""
    from tpuimg_torch import enhance_host

    return functools.partial(enhance_host, **cfg["params"])


def reference(cfg, img, device, dtype):
    return ref.enhance(img.to(device), **cfg["params"], dtype=dtype)


def compare(out, expected):
    return ref.u8_gaps(out.to(expected.device), expected)
