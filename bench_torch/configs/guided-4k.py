"""guided-4k: ``tpuimg_torch.guided_filter`` of f32 4K frames by a
distinct guide, and its plain reference beside it."""

import functools

from bench_torch import frames, reference as ref


def make_args(cfg, seed, device):
    """The ring: one (I, p) pair per slot."""
    I, p = frames.guide_ring(cfg["ring"], cfg["height"], cfg["width"], seed,
                             device)
    return [(I[i], p[i]) for i in range(cfg["ring"])]


def entry(cfg):
    import tpuimg_torch

    return functools.partial(tpuimg_torch.guided_filter, **cfg["params"])


def reference(cfg, I, p, dtype):
    prm = cfg["params"]
    if prm["border"] != "reflect101":
        raise ValueError(f"the reference has no border {prm['border']!r}")
    return ref.guided_filter(I.to(dtype), p.to(dtype), prm["radius"],
                             prm["eps"])


def compare(out, expected):
    return {"max_abs": ref.float_gap(out, expected)}
