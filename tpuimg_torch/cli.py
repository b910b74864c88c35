"""Demo / benchmark CLI, the counterpart of the reference's L3 layer (port of
``tpuimg.cli``).

Each subcommand mirrors one reference demo executable (SURVEY.md §3 call
stacks): load or synthesize an image, run the op (a plain PyTorch rung and
the CUDA kernels), verify by max-abs-diff against the NumPy oracle, time
it, and write result PNGs.

    python -m tpuimg_torch gaussian 3840 2160 1 1.0 100 [src.png]
    python -m tpuimg_torch integral [--width 3840 --height 2160 --nreps 100]
    python -m tpuimg_torch integral-autotest [--runs 20]
    python -m tpuimg_torch he image.png
    python -m tpuimg_torch enhance [image.png] [--clip 2.0 --tiles 8]
    python -m tpuimg_torch clahe image.png [--clip 1.0 --xtiles 8]
    python -m tpuimg_torch guided [--radius 4 --eps 0.3] [--src ...]
    python -m tpuimg_torch morphology [--radius 5 --mode 0] [--src ...]
    python -m tpuimg_torch sweep {gaussian,guided,morphology} [--radii 1-7]
    python -m tpuimg_torch stream 'frames/*.png' [--op enhance]

Everything runs on the CUDA card (``--platform gpu``, the default), timed
by CUDA events, and the card's name and power limit head the output; with
no card the command fails with exit code 2 and computes nothing.
``--platform cpu`` runs the kernels' plain PyTorch versions on the CPU,
timed by the host clock. The rung ladders: ``torch`` is the kernel
module's plain version on the same device, timed only as a comparison;
``cuda`` is the public op, which on the card runs the CUDA kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _maxdiff(a, b):
    # host-side on purpose: the reference side is a host NumPy oracle, so a
    # device-side compare (ops.metrics) would just move the transfer from
    # download(out) to upload(ref)
    return float(np.abs(_host(a).astype(np.float64)
                        - _host(b).astype(np.float64)).max())


def _host(x) -> np.ndarray:
    """A host NumPy array of a tensor on any device (``np.asarray`` of a
    CUDA tensor raises)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _to(args, a) -> torch.Tensor:
    """A host array on the command's device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(args.device)


def _time(args, fn, arg, nreps, pixels):
    from tpuimg_torch.core.timing import time_fn

    return time_fn(fn, arg, iters=max(8, min(nreps, 64)), pixels=pixels,
                   card=args.card)


def _report(name, ms, gpix, diff, tol):
    status = "OK" if diff <= tol else "FAIL"
    print(f"{name:28s} {ms:9.3f} ms  {gpix:8.2f} GPix/s  maxdiff={diff:g} [{status}]")
    return diff <= tol


def _load_or_random(path, w, h, dtype):
    from tpuimg_torch.utils import imread_gray

    if path:
        img = imread_gray(path)
        if dtype == np.float32:
            img = img.astype(np.float32) / 255.0
        return img
    rng = np.random.default_rng(0)
    if dtype == np.float32:
        return rng.random((h, w), dtype=np.float32)
    return rng.integers(0, 256, (h, w), dtype=np.uint8)


def _out_path(base, tag):
    root, _ = os.path.splitext(base or "demo.png")
    return f"{root}_{tag}.png"


def cmd_gaussian(args):
    from tpuimg_torch import gaussian
    from tpuimg_torch.core.borders import pad_reflect101
    from tpuimg_torch.core.kernelgen import gaussian_kernel_1d
    from tpuimg_torch.core.params import GaussianConfig
    from tpuimg_torch.kernels.sep_stencil import gaussian_plain
    from tpuimg_torch.oracle import gaussian_ref
    from tpuimg_torch.utils import imwrite

    rr, sg = args.radius, args.sigma
    GaussianConfig(radius=rr, sigma=sg)  # validate
    img = _load_or_random(args.src, args.width, args.height, np.float32)
    h, w = img.shape
    ref = gaussian_ref(img, rr, sg)
    x = _to(args, img)
    ok = True

    # the runnable impl ladder, as the reference keeps its gaussian rungs
    # timed in one harness (gaussian.cu:409-663): naive full-window 2D conv,
    # the separable plain version, and the CUDA kernel
    k1 = np.asarray(gaussian_kernel_1d(2 * rr + 1, sg))
    k2 = np.outer(k1, k1).astype(np.float32)

    def naive2d(v):
        # (2r+1)^2 shifted adds, no separability — the naive rung
        # (gGaussianFilter, gaussian.cu:conv loop)
        xp = pad_reflect101(v, rr, rr)
        acc = torch.zeros_like(v)
        for i in range(2 * rr + 1):
            for j in range(2 * rr + 1):
                acc = acc + float(k2[i, j]) * xp[i : i + h, j : j + w]
        return acc

    rungs = [
        ("naive2d", naive2d),
        ("torch", lambda v: gaussian_plain(v, rr, sg)),
        ("cuda", lambda v: gaussian(v, rr, sg)),
    ]
    for impl, fn in rungs:
        out = _host(fn(x))
        r = _time(args, fn, x, args.nreps, h * w)
        ok &= _report(f"gaussian[{impl}] r={rr}", r.ms, r.gpix_s,
                      _maxdiff(out, ref), 1e-4)
        if args.src:
            imwrite(_out_path(args.src, f"gauss_{impl}"),
                    np.clip(out * 255, 0, 255).astype(np.uint8))
    return ok


def cmd_integral(args):
    from tpuimg_torch import integral
    from tpuimg_torch.kernels.scan2d import integral_plain
    from tpuimg_torch.oracle import integral_ref

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (args.height, args.width), dtype=np.uint8)
    ref = integral_ref(img)
    x = _to(args, img)
    ok = True
    for impl, fn in (("torch", integral_plain), ("cuda", integral)):
        out = _host(fn(x))
        r = _time(args, fn, x, args.nreps, img.size)
        ok &= _report(f"integral[{impl}]", r.ms, r.gpix_s, _maxdiff(out, ref), 0)
    return ok


def _autotest(args, run_one, tag, tol: float = 0.0):
    """Randomized-shape property loop (reference autoTestDemo,
    Integral/main.cpp:154-237), appending one line per run to res.log.
    `run_one(rng, h, w) -> (desc, diff[, tol])`; integer ops require
    diff == 0, float/quantized ops pass `tol` (e.g. 1 gray step for CLAHE).
    A 3-tuple return overrides the family tolerance for that run (mixed-mode
    families: the guided shrink/CN1 class paths carry the 1e-3 float
    contract, the fused reflect path the tighter 1e-4). The draws follow
    tpuimg's order, so a seed gives both CLIs the same runs."""
    rng = np.random.default_rng(args.seed)
    failures = 0
    done = 0
    deadline = getattr(args, "deadline", 0)
    with open("res.log", "a") as log:
        for _ in range(args.runs):
            if deadline and time.time() >= deadline:
                # cooperative stop between runs, at an epoch second
                print(f"deadline reached after {done} runs", flush=True)
                break
            h = int(rng.integers(64, args.max_size))
            w = int(rng.integers(64, args.max_size))
            res = run_one(rng, h, w)
            desc, diff = res[0], res[1]
            rtol = res[2] if len(res) > 2 else tol
            line = (f"Size: {w} x {h}, Max difference of tpuimg_torch{tag}"
                    f"{desc} and oracle: {diff:g}")
            print(line, flush=True)
            log.write(line + "\n")
            log.flush()
            failures += diff > rtol
            done += 1
    word = "exact" if tol == 0 else f"within {tol:g}"
    print(f"{done - failures}/{done} {word}")
    return failures == 0


def _bucket_shape(args, h, w):
    """Round a drawn shape up to --bucket multiples. Unlike the integral's
    zero-embed (which additionally proves the trailing-zero slice identity),
    the generic form fills the WHOLE bucketed frame with random content: the
    device op and the oracle consume the identical frame, so the per-run
    contract is unchanged — only the shape-draw space is quantized onto the
    lattice, and the log line records the bucketed shape."""
    if not getattr(args, "bucket", 0):
        return h, w, ""
    hp = -(-h // args.bucket) * args.bucket
    wp = -(-w // args.bucket) * args.bucket
    return hp, wp, f" (bucket {wp} x {hp})"


def cmd_integral_autotest(args):
    """--bucket N embeds the drawn frame in a zero-padded frame whose sides
    are multiples of N before the device op. Exact by construction: an
    integral image's top-left h×w region is unchanged by trailing zero
    rows/cols, and the FULL padded output is still verified against the
    oracle of the padded frame, so nothing is checked more loosely than the
    unbucketed protocol. tpuimg buckets to bound its compiled programs; the
    CUDA kernels take every shape, so here it keeps the draws of tpuimg's
    bucketed runs."""
    from tpuimg_torch import integral
    from tpuimg_torch.kernels.scan2d import integral_plain
    from tpuimg_torch.oracle import integral_ref

    op = integral_plain if args.impl == "torch" else integral

    def run_one(rng, h, w):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        if args.bucket:
            hp = -(-h // args.bucket) * args.bucket
            wp = -(-w // args.bucket) * args.bucket
            frame = np.zeros((hp, wp), np.uint8)
            frame[:h, :w] = img
            out = _host(op(_to(args, frame)))
            diff = _maxdiff(out, integral_ref(frame))
            # implied mathematically; cheap insurance on the slice identity
            diff = max(diff, _maxdiff(out[:h, :w], integral_ref(img)))
            return f" (bucket {wp} x {hp})", diff
        return "", _maxdiff(op(_to(args, img)), integral_ref(img))

    return _autotest(args, run_one, "")


def cmd_he_autotest(args):
    from tpuimg_torch import hist_equalize
    from tpuimg_torch.oracle import hist_equalize_ref

    def run_one(rng, h, w):
        h, w, bdesc = _bucket_shape(args, h, w)
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        return bdesc, _maxdiff(hist_equalize(_to(args, img)),
                               hist_equalize_ref(img))

    return _autotest(args, run_one, "-he")


def cmd_morph_autotest(args):
    from tpuimg_torch import dilate, erode
    from tpuimg_torch.oracle import dilate_ref, erode_ref

    def run_one(rng, h, w):
        h, w, bdesc = _bucket_shape(args, h, w)
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        r = int(rng.integers(1, args.max_radius + 1))
        if args.bucket:
            # tpuimg's bucketed radius ladder, spanning its three dispatch
            # regimes (fused strip / van Herk / large-r)
            ladder = (1, 2, 4, 7, 12, 20, 31)
            r = max(v for v in ladder if v <= max(r, 1))
        x = _to(args, img)
        if rng.integers(2):
            diff = _maxdiff(dilate(x, r), dilate_ref(img, r))
            return f"-dilate r{r}{bdesc}", diff
        diff = _maxdiff(erode(x, r), erode_ref(img, r))
        return f"-erode r{r}{bdesc}", diff

    return _autotest(args, run_one, "")


def cmd_clahe_autotest(args):
    """CLAHE truth is the line-by-line oracle; quantization to u8 makes the
    contract ≤1 gray step, not exact (KNOWN_DIVERGENCES)."""
    from tpuimg_torch import clahe
    from tpuimg_torch.core.validate import TpuImgError
    from tpuimg_torch.oracle import clahe_ref

    def run_one(rng, h, w):
        h, w, bdesc = _bucket_shape(args, h, w)
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        xt = int(rng.integers(2, 9))
        yt = int(rng.integers(2, 9))
        clip = float(rng.uniform(1.0, 60.0))
        if args.bucket:
            # tpuimg's bucketed ladders of tile grid and clip limit
            grids = ((2, 2), (4, 4), (8, 8))
            xt, yt = grids[int(rng.integers(len(grids)))]
            ladder = (2.0, 40.0)
            clip = ladder[int(rng.integers(len(ladder)))]
        # centered padding must satisfy the dLimitSize reflect bound
        # (ops/histogram geometry validation); skip invalid grid draws
        try:
            got = clahe(_to(args, img), clip, xt, yt)
        except TpuImgError:
            return f"-clahe {xt}x{yt} (skipped: invalid grid){bdesc}", 0.0
        return (f"-clahe {xt}x{yt} clip{clip:.1f}{bdesc}",
                _maxdiff(got, clahe_ref(img, clip, xt, yt)))

    return _autotest(args, run_one, "", tol=1.0)


def cmd_gaussian_autotest(args):
    from tpuimg_torch import gaussian
    from tpuimg_torch.oracle import gaussian_ref

    def run_one(rng, h, w):
        h, w, bdesc = _bucket_shape(args, h, w)
        img = rng.random((h, w), dtype=np.float32)
        r = int(rng.integers(1, 8))
        sigma = float(rng.uniform(0.5, 3.0))
        if args.bucket:
            # tpuimg's bucketed (r, sigma) ladder, covering every radius
            pairs = ((1, 0.5), (2, 1.0), (3, 1.5), (4, 1.0),
                     (5, 2.0), (6, 3.0), (7, 2.0))
            r, sigma = pairs[r - 1]
        got = gaussian(_to(args, img), r, sigma)
        return (f"-gauss r{r} s{sigma:g}{bdesc}",
                _maxdiff(got, gaussian_ref(img, r, sigma)))

    return _autotest(args, run_one, "", tol=1e-5)


def cmd_guided_autotest(args):
    from tpuimg_torch import guided_filter
    from tpuimg_torch.oracle import guided_filter_ref

    def run_one(rng, h, w):
        h, w, bdesc = _bucket_shape(args, h, w)
        I = rng.random((h, w), dtype=np.float32)
        r = int(rng.integers(1, 17))
        if args.bucket:
            # tpuimg's bucketed radius ladder (the r1-16 endpoints + mid
            # rungs)
            ladder = (1, 2, 3, 4, 8, 12, 16)
            r = max(v for v in ladder if v <= r)
        if min(h, w) <= 2 * r:  # tpuimg's fused-path geometry bound
            r = max(1, min(h, w) // 2 - 1)
        # the randomized record also covers the reference's CLASS-path
        # semantics — shrink-window border and the CN1
        # 3-channel-source/gray-guide variant
        # (GuidedFilter/guided_filter.cpp:28-66) — at their 1e-3 contract;
        # the fused reflect path keeps the tighter 1e-4
        mode = ("reflect", "shrink", "cn1", "reflect")[int(rng.integers(4))]
        x = _to(args, I)
        if mode == "cn1":
            p = rng.random((3, h, w), dtype=np.float32)
            got = guided_filter(x, _to(args, p), r, 1e-3, border="shrink")
            ref = np.stack([
                guided_filter_ref(I, pc, r, 1e-3, border="shrink")
                for pc in p])
            return f"-guided-cn1 r{r}{bdesc}", _maxdiff(got, ref), 1e-3
        p = rng.random((h, w), dtype=np.float32)
        if mode == "shrink":
            got = guided_filter(x, _to(args, p), r, 1e-3, border="shrink")
            ref = guided_filter_ref(I, p, r, 1e-3, border="shrink")
            return f"-guided r{r} shrink{bdesc}", _maxdiff(got, ref), 1e-3
        got = guided_filter(x, _to(args, p), r, 1e-3, border="reflect101")
        ref = guided_filter_ref(I, p, r, 1e-3, border="reflect101")
        return f"-guided r{r}{bdesc}", _maxdiff(got, ref)

    return _autotest(args, run_one, "", tol=1e-4)


def _enhance_ref(img, clip, tiles, radius, sigma, gf_radius, gf_eps):
    """The enhance pipeline composed from the NumPy oracles."""
    from tpuimg_torch.oracle import clahe_ref, gaussian_ref, guided_filter_ref

    eq = clahe_ref(img, clip, tiles, tiles)
    f = eq.astype(np.float32) / np.float32(255.0)
    sm = gaussian_ref(f, radius, sigma)
    q = guided_filter_ref(f, sm, gf_radius, gf_eps, border="reflect101")
    return np.clip(np.rint(q * 255.0), 0, 255).astype(np.uint8)


def cmd_enhance_autotest(args):
    """Randomized parity for the flagship fused pipeline: enhance(img)
    (f32 CLAHE bridge + one-kernel gaussian+guided tail) vs the composed
    NumPy oracles. CLAHE's own contract is ≤1 gray step; the downstream
    chain is an average-of-averages (non-expanding), so the end-to-end
    contract is ≤2 steps after the final rint."""
    from tpuimg_torch.pipeline import enhance

    def run_one(rng, h, w):
        h, w, bdesc = _bucket_shape(args, h, w)
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        got = enhance(_to(args, img))
        ref = _enhance_ref(img, 2.0, 8, 2, 1.5, 8, 1e-3)
        return f"-enhance{bdesc}", _maxdiff(got, ref)

    return _autotest(args, run_one, "", tol=2.0)


def cmd_enhance(args):
    """Flagship pipeline demo: CLAHE → gaussian → guided on one frame, the
    fused, fused1 and staged impls timed side by side and verified against
    the composed NumPy oracles — the chain the reference cannot run in one
    program (each of its demos is a separate executable with host
    round-trips between them, SURVEY.md §3)."""
    from tpuimg_torch.pipeline import enhance
    from tpuimg_torch.utils import imwrite

    img = _load_or_random(args.image, args.width, args.height, np.uint8)
    ref = _enhance_ref(img, args.clip, args.tiles, args.radius, args.sigma,
                       args.gf_radius, args.gf_eps)
    x = _to(args, img)
    ok = True
    for impl in ("fused", "fused1", "staged"):
        fn = lambda v: enhance(v, args.clip, args.tiles, args.radius,
                               args.sigma, args.gf_radius, args.gf_eps,
                               impl=impl)
        out = _host(fn(x))
        r = _time(args, fn, x, args.nreps, img.size)
        # every impl shares the enhance-autotest <=2-step contract: CLAHE's
        # permitted 1-step deviation propagated through the tail can cross
        # an rint boundary even on the staged path
        ok &= _report(f"enhance[{impl}]", r.ms, r.gpix_s,
                      _maxdiff(out, ref), 2)
        if args.image:
            imwrite(_out_path(args.image, f"enhance_{impl}"), out)
    return ok


def cmd_he(args):
    from tpuimg_torch import hist_equalize
    from tpuimg_torch.oracle import hist_equalize_ref
    from tpuimg_torch.utils import imread_gray, imwrite

    img = imread_gray(args.image)
    x = _to(args, img)
    out = _host(hist_equalize(x))
    diff = _maxdiff(out, hist_equalize_ref(img))
    r = _time(args, hist_equalize, x, args.nreps, img.size)
    ok = _report("hist_equalize", r.ms, r.gpix_s, diff, 0)
    imwrite(_out_path(args.image, "tpuhe"), out)
    return ok


def cmd_clahe(args):
    from tpuimg_torch import clahe
    from tpuimg_torch.core.params import ClaheConfig
    from tpuimg_torch.oracle import clahe_ref
    from tpuimg_torch.utils import imread_gray, imread_rgb, imwrite

    cfg = ClaheConfig(clip_limit=args.clip, xtiles=args.xtiles,
                      ytiles=args.ytiles)
    try:
        rgb = imread_rgb(args.image)
        # image decoders hand back (H, W, 3) even for grayscale sources, so
        # ndim alone cannot detect color — check the channels actually
        # differ (a gray PNG through the Lab round-trip would shift values
        # by several levels)
        color = rgb.ndim == 3 and int(np.ptp(rgb, axis=-1).max()) > 0
        if not color and rgb.ndim == 3:
            rgb = rgb[..., 0]
    except OSError:  # a decoder failure: read it as gray below
        rgb, color = None, False
    if color:
        # reference claheDemo: BGR→Lab, CLAHE on L, merge back — but here the
        # whole chain runs on the device (ops/color.py)
        from tpuimg_torch.ops.color import lab_to_rgb, rgb_to_lab

        lab = rgb_to_lab(_to(args, rgb))
        L = lab[..., 0]
        Leq = clahe(L, cfg.clip_limit, cfg.xtiles, cfg.ytiles)
        out_rgb = _host(lab_to_rgb(torch.stack(
            [Leq, lab[..., 1], lab[..., 2]], dim=-1)))
        imwrite(_out_path(args.image, "tpuclahe"), out_rgb)
        L_np = _host(L)
        got = _host(Leq)
    else:
        L_np = rgb if rgb is not None else imread_gray(args.image)
        got = _host(clahe(_to(args, L_np), cfg.clip_limit, cfg.xtiles,
                          cfg.ytiles))
        imwrite(_out_path(args.image, "tpuclahe"), got)

    ref = clahe_ref(L_np, cfg.clip_limit, cfg.xtiles, cfg.ytiles)
    fn = lambda v: clahe(v, cfg.clip_limit, cfg.xtiles, cfg.ytiles)
    r = _time(args, fn, _to(args, L_np), args.nreps, L_np.size)
    return _report("clahe", r.ms, r.gpix_s, _maxdiff(got, ref), 1)


def cmd_guided(args):
    from tpuimg_torch.core.params import GuidedConfig
    from tpuimg_torch.core.validate import ParamError
    from tpuimg_torch.kernels.boxsum import (
        guided_filter_kernel, guided_filter_plain)
    from tpuimg_torch.oracle import guided_filter_ref
    from tpuimg_torch.utils import imwrite

    cfg = GuidedConfig(radius=args.radius, eps=args.eps, border="reflect101")
    src = _load_or_random(args.src, args.width, args.height, np.float32)
    guide = _load_or_random(args.guide or args.src, args.width, args.height,
                            np.float32)
    if guide.shape != src.shape:
        raise ParamError(
            f"guide {guide.shape} and src {src.shape} must match; pass both "
            f"--src and --guide as same-sized images"
        )
    ref = guided_filter_ref(guide, src, cfg.radius, cfg.eps,
                            border="reflect101")
    I, p = _to(args, guide), _to(args, src)
    ok = True
    # the runnable impl ladder: the plain box chain, the reference-shaped
    # two-kernel split (gCalcAB/gWeightByABm with a and b through device
    # memory), and the one-pass walker kernel
    rungs = [
        ("torch", lambda v: guided_filter_plain(v, p, cfg.radius, cfg.eps)),
        ("cuda-twopass", lambda v: guided_filter_kernel(
            v, p, cfg.radius, cfg.eps, variant="twopass")),
        ("cuda-onepass", lambda v: guided_filter_kernel(
            v, p, cfg.radius, cfg.eps, variant="onepass")),
    ]
    for impl, fn in rungs:
        out = _host(fn(I))
        r = _time(args, fn, I, args.nreps, src.size)
        ok &= _report(f"guided[{impl}] r={cfg.radius}", r.ms, r.gpix_s,
                      _maxdiff(out, ref), 1e-3)
        if args.src:
            imwrite(_out_path(args.src, f"guided_{impl}"),
                    np.clip(out * 255, 0, 255).astype(np.uint8))
    return ok


def cmd_morphology(args):
    from tpuimg_torch import dilate, erode, morph_close, morph_open
    from tpuimg_torch.core.params import MorphConfig
    from tpuimg_torch.kernels.sep_stencil import (
        morphology_plain, open_close_plain)
    from tpuimg_torch.oracle import close_ref, dilate_ref, erode_ref, open_ref
    from tpuimg_torch.utils import imwrite

    ops = {  # the op, its oracle, its plain version
        "erode": (erode, erode_ref, lambda v, r: morphology_plain(v, r, 0)),
        "dilate": (dilate, dilate_ref,
                   lambda v, r: morphology_plain(v, r, 1)),
        "open": (morph_open, open_ref,
                 lambda v, r: open_close_plain(v, r, 0)),
        "close": (morph_close, close_ref,
                  lambda v, r: open_close_plain(v, r, 1)),
    }
    cfg = MorphConfig(radius=args.radius, mode=args.mode)
    name = args.op if args.op else ("erode" if cfg.mode == 0 else "dilate")
    op, ref_fn, plain = ops[name]

    if args.color != "gray" and args.src:
        # reference morphologyRGBDemo (per-channel, main.cpp:113-177) /
        # morphologyLABDemo (L channel only, :180-242) — all on the device
        from tpuimg_torch.utils import imread_rgb

        rgb = _to(args, imread_rgb(args.src))
        if args.color == "rgb":
            chans = rgb.permute(2, 0, 1)  # (3, H, W): one call, 3 frames
            out = _host(op(chans, cfg.radius).permute(1, 2, 0))
        else:  # lab
            from tpuimg_torch.ops.color import lab_to_rgb, rgb_to_lab

            lab = rgb_to_lab(rgb)
            L = op(lab[..., 0], cfg.radius)
            out = _host(lab_to_rgb(torch.stack(
                [L, lab[..., 1], lab[..., 2]], dim=-1)))
        imwrite(_out_path(args.src, f"morph_{name}_{args.color}"), out)
        print(f"wrote {args.color} {name} result")
        return True

    img = _load_or_random(args.src, args.width, args.height, np.uint8)
    ref = ref_fn(img, cfg.radius)
    x = _to(args, img)
    ok = True
    rungs = (("torch", lambda v: plain(v, cfg.radius)),
             ("cuda", lambda v: op(v, cfg.radius)))
    for impl, fn in rungs:
        out = _host(fn(x))
        r = _time(args, fn, x, args.nreps, img.size)
        ok &= _report(f"morph[{impl}] {name} r={cfg.radius}",
                      r.ms, r.gpix_s, _maxdiff(out, ref), 0)
        if args.src:
            imwrite(_out_path(args.src, f"morph_{impl}_{name}"), out)
    return ok


def cmd_sweep(args):
    """Parameter sweeps (reference GuidedFilter/run.py, Morphology/
    plot_time.py protocols); writes JSON results."""
    from tpuimg_torch import erode, gaussian, guided_filter

    if "," in args.radii:  # explicit list, e.g. "1,2,4,8,15,30"
        radii = [int(v) for v in args.radii.split(",")]
    else:  # range, e.g. "1-30"
        parts = args.radii.split("-")
        radii = list(range(int(parts[0]), int(parts[-1]) + 1))
    rng = np.random.default_rng(0)
    img_f = _to(args, rng.random((args.height, args.width), dtype=np.float32))
    img_u = _to(args, rng.integers(0, 256, (args.height, args.width),
                                   dtype=np.uint8))
    results = []
    for r in radii:
        if args.op == "gaussian":
            fn, arg = (lambda v, r=r: gaussian(v, r, 1.0)), img_f
        elif args.op == "guided":
            fn, arg = (lambda v, r=r: guided_filter(
                v, v, r, 0.3, border="reflect101")), img_f
        else:
            fn, arg = (lambda v, r=r: erode(v, r)), img_u
        t = _time(args, fn, arg, args.nreps, args.width * args.height)
        results.append({"radius": r, "ms": t.ms, "gpix_s": t.gpix_s,
                        "clock": t.clock, "device": t.card})
        print(f"radius {r:2d}: {t.ms:9.3f} ms  {t.gpix_s:8.2f} GPix/s")
    out = os.path.join(args.out_dir, f"sweep_{args.op}.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}")
    if args.plot:
        # latency-vs-radius plot (the reference's plot_time.py output)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot([r["radius"] for r in results], [r["ms"] for r in results],
                marker="o")
        ax.set_xlabel("radius")
        ax.set_ylabel("ms / frame")
        ax.set_title(f"{args.op} {args.width}x{args.height} ({args.card})")
        fig.tight_layout()
        png = os.path.join(args.out_dir, f"sweep_{args.op}.png")
        fig.savefig(png, dpi=120)
        print(f"wrote {png}")
    return True


def cmd_stream(args):
    """End-to-end streaming: native threaded decode → device pipeline → PNG.

    The production-serving shape: the C++ prefetcher (tpuimg_torch.native)
    decodes ahead on worker threads while the card runs the op, so decode,
    transfer and compute overlap. ``--op enhance`` goes through
    ``enhance_host``: each frame is staged into pinned memory, uploaded,
    enhanced and downloaded on a stream of its own, with up to
    ``POOL_STREAMS`` frames in flight, one a stream, while the host encodes
    the oldest. The other ops keep a 1-deep pipeline in which the card
    computes frame i while the host encodes frame i-1 (launches are
    asynchronous; ``.cpu()`` of the previous result is where the host
    waits).
    """
    import collections
    import glob as globmod

    from tpuimg_torch import clahe, erode, gaussian, hist_equalize, native
    from tpuimg_torch.host import POOL_STREAMS, enhance_host
    from tpuimg_torch.pipeline import _to_u8

    paths = sorted(globmod.glob(args.pattern))
    if not paths:
        print(f"no files match {args.pattern}")
        return False
    os.makedirs(args.out, exist_ok=True)

    ops = {
        "clahe": lambda x: clahe(x, args.clip, 8, 8),
        "he": hist_equalize,
        "erode": lambda x: erode(x, args.radius),
        # rint+clip: the library's float->u8 convention
        "gaussian": lambda x: _to_u8(gaussian(
            x.to(torch.float32) / 255.0, args.radius, 1.5)),
    }
    if args.op == "enhance":
        depth = POOL_STREAMS

        def submit(frame):
            return enhance_host(frame, args.device)
    else:
        depth, fn = 1, ops[args.op]

        def submit(frame):
            return fn(torch.from_numpy(frame).to(args.device))

    def write():
        pidx, pres, done = pending.popleft()
        if done is not None:
            done.synchronize()
        base = os.path.splitext(os.path.basename(paths[pidx]))[0]
        native.write_png(  # output is PNG regardless of input ext
            os.path.join(args.out, base + ".png"), _host(pres))

    staged = enhance_host.staged_bytes
    moved = 0  # bytes each way: enhance_host's output is its frame's size
    cuda = args.device.type == "cuda"
    t0 = time.perf_counter()
    n = 0
    pending = collections.deque()
    with native.FrameStream(paths, (args.height, args.width), gray=True,
                            threads=args.threads) as fs:
        for idx, frame in fs:
            result = submit(frame)
            moved += frame.nbytes
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            pending.append((idx, result, done))
            while len(pending) > depth:
                write()
                n += 1
        while pending:
            write()
            n += 1
    dt = time.perf_counter() - t0
    print(f"processed {n} frames ({args.width}x{args.height}, op={args.op}) "
          f"in {dt:.2f}s = {n / dt:.2f} fps end-to-end [{args.card}]")
    if args.op == "enhance":
        print(f"moved {moved} B to the device and {moved} B back; "
              f"{enhance_host.staged_bytes - staged} B staged into pinned "
              f"memory on the host")
    return True


def _parser():
    p = argparse.ArgumentParser(prog="tpuimg_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--platform", default="gpu", choices=["cpu", "gpu"],
                   help="gpu (default): the CUDA card, or exit code 2 "
                        "without one; cpu: the plain PyTorch versions")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gaussian")
    g.add_argument("width", type=int, nargs="?", default=3840)
    g.add_argument("height", type=int, nargs="?", default=2160)
    g.add_argument("radius", type=int, nargs="?", default=1)
    g.add_argument("sigma", type=float, nargs="?", default=1.0)
    g.add_argument("nreps", type=int, nargs="?", default=20)
    g.add_argument("src", nargs="?", default=None)
    g.set_defaults(fn=cmd_gaussian)

    i = sub.add_parser("integral")
    i.add_argument("--width", type=int, default=3840)
    i.add_argument("--height", type=int, default=2160)
    i.add_argument("--nreps", type=int, default=20)
    i.set_defaults(fn=cmd_integral)

    a = sub.add_parser("integral-autotest")
    a.add_argument("--runs", type=int, default=10)
    # 6000 matches the reference autoTestDemo range (Integral/main.cpp:193)
    # and covers the wide-frame carry regime (carry > 2^20 beyond 4224 px)
    a.add_argument("--max-size", type=int, default=6000)
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("--impl", default="cuda", choices=["torch", "cuda"])
    a.add_argument("--bucket", type=int, default=0)  # 0 = off
    # cooperative stop (epoch seconds), checked between runs
    a.add_argument("--deadline", type=int, default=0)
    a.set_defaults(fn=cmd_integral_autotest)

    ah = sub.add_parser("he-autotest")
    ah.add_argument("--runs", type=int, default=10)
    ah.add_argument("--max-size", type=int, default=6000)
    ah.add_argument("--seed", type=int, default=0)
    ah.add_argument("--bucket", type=int, default=0)
    ah.add_argument("--deadline", type=int, default=0)
    ah.set_defaults(fn=cmd_he_autotest)

    am = sub.add_parser("morph-autotest")
    am.add_argument("--runs", type=int, default=10)
    am.add_argument("--max-size", type=int, default=4000)
    am.add_argument("--max-radius", type=int, default=31)
    am.add_argument("--seed", type=int, default=0)
    am.add_argument("--bucket", type=int, default=0)
    am.add_argument("--deadline", type=int, default=0)
    am.set_defaults(fn=cmd_morph_autotest)

    for nm, fun, mx in [("clahe-autotest", cmd_clahe_autotest, 4000),
                        ("gaussian-autotest", cmd_gaussian_autotest, 4000),
                        ("guided-autotest", cmd_guided_autotest, 3000),
                        ("enhance-autotest", cmd_enhance_autotest, 3000)]:
        ax = sub.add_parser(nm)
        ax.add_argument("--runs", type=int, default=10)
        ax.add_argument("--max-size", type=int, default=mx)
        ax.add_argument("--seed", type=int, default=0)
        ax.add_argument("--bucket", type=int, default=0)
        ax.add_argument("--deadline", type=int, default=0)
        ax.set_defaults(fn=fun)

    e = sub.add_parser("he")
    e.add_argument("image")
    e.add_argument("--nreps", type=int, default=20)
    e.set_defaults(fn=cmd_he)

    en = sub.add_parser("enhance")
    en.add_argument("image", nargs="?", default=None)
    en.add_argument("--width", type=int, default=3840)
    en.add_argument("--height", type=int, default=2160)
    en.add_argument("--clip", type=float, default=2.0)
    en.add_argument("--tiles", type=int, default=8)
    en.add_argument("--radius", type=int, default=2)
    en.add_argument("--sigma", type=float, default=1.5)
    en.add_argument("--gf-radius", type=int, default=8)
    en.add_argument("--gf-eps", type=float, default=1e-3)
    en.add_argument("--nreps", type=int, default=20)
    en.set_defaults(fn=cmd_enhance)

    c = sub.add_parser("clahe")
    c.add_argument("image")
    c.add_argument("--clip", type=float, default=1.0)
    c.add_argument("--xtiles", type=int, default=8)
    c.add_argument("--ytiles", type=int, default=8)
    c.add_argument("--nreps", type=int, default=20)
    c.set_defaults(fn=cmd_clahe)

    u = sub.add_parser("guided")
    u.add_argument("--radius", type=int, default=4)
    u.add_argument("--eps", type=float, default=0.3)
    u.add_argument("--nreps", type=int, default=20)
    u.add_argument("--width", type=int, default=3840)
    u.add_argument("--height", type=int, default=2160)
    u.add_argument("--src", default=None)
    u.add_argument("--guide", default=None)
    u.set_defaults(fn=cmd_guided)

    m = sub.add_parser("morphology")
    m.add_argument("--radius", type=int, default=5)
    m.add_argument("--mode", type=int, default=0, choices=[0, 1])
    m.add_argument("--op", default=None,
                   choices=["erode", "dilate", "open", "close"])
    m.add_argument("--color", default="gray", choices=["gray", "rgb", "lab"])
    m.add_argument("--nreps", type=int, default=20)
    m.add_argument("--width", type=int, default=3840)
    m.add_argument("--height", type=int, default=2160)
    m.add_argument("--src", default=None)
    m.set_defaults(fn=cmd_morphology)

    s = sub.add_parser("sweep")
    s.add_argument("op", choices=["gaussian", "guided", "morphology"])
    s.add_argument("--radii", default="1-7")
    s.add_argument("--nreps", type=int, default=20)
    s.add_argument("--width", type=int, default=3840)
    s.add_argument("--height", type=int, default=2160)
    s.add_argument("--plot", action="store_true")
    s.add_argument("--out-dir", default=".")
    s.set_defaults(fn=cmd_sweep)

    st = sub.add_parser("stream")
    st.add_argument("pattern", help="glob of input images")
    st.add_argument("--op", default="enhance",
                    choices=["enhance", "clahe", "he", "erode", "gaussian"])
    st.add_argument("--out", default="stream_out")
    st.add_argument("--width", type=int, default=1920)
    st.add_argument("--height", type=int, default=1080)
    st.add_argument("--radius", type=int, default=3)
    st.add_argument("--clip", type=float, default=2.0)
    st.add_argument("--threads", type=int, default=4)
    st.set_defaults(fn=cmd_stream)
    return p


def _device(platform: str) -> torch.device:
    """The command's device: the current CUDA card for "gpu", which must
    exist (no CPU fallback), or the CPU."""
    from tpuimg_torch.core.validate import DeviceError

    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise DeviceError(
            "--platform gpu (the default) runs on a CUDA card and there is "
            "none; pass --platform cpu to run the plain PyTorch versions on "
            "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _device_banner(device: torch.device) -> str:
    """Report the device before running (the reference's initDevice,
    Integral/cuda_utils.h:94-120) and return its label. On the card this
    builds and loads the kernels first, so no timed call pays the build."""
    if device.type == "cpu":
        print("tpuimg_torch: device=cpu (the kernels' plain PyTorch "
              "versions), times by the host clock", file=sys.stderr)
        return "cpu"
    from tpuimg_torch import kernels
    from tpuimg_torch.core.timing import card_label

    label = card_label()
    t0 = time.perf_counter()
    kernels.load()
    print(f"tpuimg_torch: device={device} [{label}] "
          f"{torch.cuda.get_device_name(device)}, kernels loaded in "
          f"{time.perf_counter() - t0:.1f} s, times by CUDA events",
          file=sys.stderr)
    return label


def main(argv=None):
    args = _parser().parse_args(argv)
    from tpuimg_torch.core.validate import DeviceError, TpuImgError

    try:
        args.device = _device(args.platform)
        args.card = _device_banner(args.device)
        ok = args.fn(args)
    except TpuImgError as e:
        # config dataclasses / op validation reject bad parameters with
        # typed errors, and a missing card with DeviceError; surface them
        # as a clean CLI failure (the reference CHECK-macro exit(-1)
        # analog, Histogram/cuda_utils.h:7-36)
        what = "no device" if isinstance(e, DeviceError) else (
            "invalid parameters")
        print(f"tpuimg_torch: {what}: {e}", file=sys.stderr)
        return 2
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
