"""enhance-8k: ``tpuimg_torch.enhance`` on u8 8K frames, and its plain
reference beside it."""

import functools

from bench_torch import frames, reference as ref


def make_args(cfg, seed, device):
    """The ring: one argument tuple per distinct frame."""
    ring = frames.scene_ring(cfg["ring"], cfg["height"], cfg["width"], seed,
                             device)
    return [(ring[i],) for i in range(cfg["ring"])]


def entry(cfg):
    """The program's entry point with the configuration's parameters; what
    it leaves to its defaults (the implementation) stays its own."""
    import tpuimg_torch

    return functools.partial(tpuimg_torch.enhance, **cfg["params"])


def reference(cfg, img, dtype):
    return ref.enhance(img, **cfg["params"], dtype=dtype)


def compare(out, expected):
    return ref.u8_gaps(out, expected)
