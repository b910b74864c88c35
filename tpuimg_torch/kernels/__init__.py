"""Build and load the hand-written CUDA kernels (the counterpart of
``tpuimg.kernels.interpret_mode``).

All sources under ``tpuimg_torch/csrc/`` compile with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
link into one shared library with a plain C interface, loaded with
``ctypes``. The library is built at first use into ``tpuimg_torch/_build/``
under a name keyed by a hash of the sources and flags, so a fresh checkout
builds everything on its first call and an edited source never loads a stale
library. A failed build raises ``KernelBuildError``; nothing falls back to
the plain PyTorch versions.

Each wrapper (kernels/hist.py, lut.py, sep_stencil.py, boxsum.py,
scan2d.py) takes its plain version for a CPU tensor only. For a CUDA tensor
it launches its kernel on the current stream, without synchronising, or
raises. ``enhance_plan.py`` launches ``enhance``'s fused chain on a card as
one C call a frame, from a plan made once per shape and parameters.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from tpuimg_torch.profiling import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
MAX_TAPS = 33  # csrc/enhance_plan.cuh kMaxTaps
TAIL_MAX_RADIUS = 64  # csrc/enhance_tail.cuh kTailMaxRadius
GAUSS_MAX_RADIUS = 96  # csrc/gaussian.cu kGaussMaxRadius
# a block's shared memory on the card (227 KB), the kernels' ceiling
SMEM_MAX_BYTES = 232_448
# csrc/guided.cu kSmemMaxRadius: the onepass kernel's shared-memory route, and
# the frame entry's ceiling; the row-padded entry takes larger radii on its
# scratch route
GUIDED_SMEM_MAX_RADIUS = 64
GUIDED_TWOPASS_MAX_RADIUS = 64  # csrc/guided.cu kTwopassMaxRadius
# csrc/hist256.cu kMaxSplitGroups: calls on at most this many groups may
# count a group in several blocks, through a workspace of 257 int32 a group
HIST_SPLIT_MAX_GROUPS = 1024


class Taps(ctypes.Structure):
    """csrc/enhance_plan.cuh ``Taps``: gaussian weights passed by value."""

    _fields_ = [("w", ctypes.c_float * MAX_TAPS)]


class GaussTaps(ctypes.Structure):
    """csrc/gaussian.cu ``GaussTaps``: gaussian weights passed by value."""

    _fields_ = [("w", ctypes.c_float * (2 * GAUSS_MAX_RADIUS + 1))]


# C entry points and their argument types; each returns cudaGetLastError()
_SIGNATURES = {
    # img, h, w, ytiles, xtiles, th, tw, pad_top, pad_left, cluster, rows,
    # out, stream
    "tpuimg_tile_hist": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                         _P),
    # img, h, w, ytiles, xtiles, th, tw, pad_top, pad_left, cluster, rows,
    # limit, fr, out, stream
    "tpuimg_tile_tables": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _F, _P, _P),
    # img, h, w, y0, tables, ytiles, xtiles, th, pad_top, pad_left, inv_tw,
    # out_f32, scale, out, stream
    "tpuimg_clahe_map": (_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _F, _I, _F,
                         _P, _P),
    # f, h, w, taps, rg, r, eps, scratch, out_u8, out, stream
    "tpuimg_enhance_tail": (_P, _I, _I, Taps, _I, _I, _F, _P, _I, _P, _P),
    # src, n, h, w, taps, r, out, stream (ypadded: src rows h + 2r)
    "tpuimg_gaussian": (_P, _I, _I, _I, GaussTaps, _I, _P, _P),
    "tpuimg_gaussian_ypadded": (_P, _I, _I, _I, GaussTaps, _I, _P, _P),
    # I, n_i, p, n, h, w, r, eps, self_guided, q, stream (ypadded: I and p
    # rows h + 4r)
    "tpuimg_guided_onepass": (_P, _I, _P, _I, _I, _I, _I, _F, _I, _P, _P),
    "tpuimg_guided_onepass_ypadded": (_P, _I, _P, _I, _I, _I, _I, _F, _I, _P,
                                      _P),
    # I, n_i, p, n, h, w, r, eps, self_guided, scratch, q, stream
    "tpuimg_guided_onepass_ypadded_scratch": (_P, _I, _P, _I, _I, _I, _I, _F,
                                              _I, _P, _P, _P),
    # I, n_i, p, n, h, w, r, eps, a, b, q, stream (shrink: the shrink border)
    "tpuimg_guided_twopass": (_P, _I, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P),
    "tpuimg_guided_twopass_shrink": (_P, _I, _P, _I, _I, _I, _I, _F, _P, _P,
                                     _P, _P),
    # x, groups, p, ws, ws_ints, out, stream
    "tpuimg_hist256": (_P, _I, _L, _P, _L, _P, _P),
    "tpuimg_hist256_packed": (_P, _I, _L, _P, _L, _P, _P),
    # x, groups, p, ws, ws_ints, factor, tables, stream
    "tpuimg_he_tables": (_P, _I, _L, _P, _L, _F, _P, _P),
    # img, n, frames, tables, tstride, elem_bytes, blocks, per_block, out,
    # stream
    "tpuimg_lut_gather": (_P, _L, _I, _P, _I, _I, _I, _L, _P, _P),
    # img, frames, h, w, out, stream
    "tpuimg_integral": (_P, _I, _I, _I, _P, _P),
    # src, n, h, w, dtype, r, mode, scratch, dst, stream (ypadded: src rows
    # h + 2r)
    "tpuimg_morphology": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "tpuimg_morphology_ypadded": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # r, element size -> the tile route's side, 0 past it
    "tpuimg_morph_tile": (_I, _I),
    # src, n, h, w, dtype, r, tile, mode, dst, stream
    "tpuimg_open_close": (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # img, h, w, tables, ytiles, xtiles, th, pad_top, pad_left, inv_tw,
    # scale, taps, rg, r, eps, scratch, out_u8, out, stream
    "tpuimg_enhance_tail_clahe": (_P, _I, _I, _P, _I, _I, _I, _I, _I, _F, _F,
                                  Taps, _I, _I, _F, _P, _I, _P, _P),
    # plan, img, workspace, out, stream (kernels/enhance_plan.py)
    "tpuimg_enhance_run": (_P, _P, _P, _P, _P),
}

_lib = None
# launches of each C entry in this process, by entry name
launches: collections.Counter[str] = collections.Counter()


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtpuimg_torch_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their joined output, or
    ``KernelBuildError`` naming the first that failed."""
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
    except OSError as e:
        raise KernelBuildError(f"cannot run {cmds[0][0]}: {e}") from e
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the sources into the build directory unless the library for
    this exact source hash is already there. Returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the lock serialises concurrent builds; the library is linked under a
    # temporary name that is renamed into place, so no reader sees half of it
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        objdir = BUILD_DIR / f"obj{os.getpid()}"
        objdir.mkdir(exist_ok=True)
        try:
            srcs = [p for p in _sources() if p.suffix == ".cu"]
            objs = [str(objdir / f"{p.stem}.o") for p in srcs]
            log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(p)]
                            for p, o in zip(srcs, objs)])
            log += _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *objs]])
        finally:
            shutil.rmtree(objdir, ignore_errors=True)
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    return lib


# entries that are not launches: argument types and result type
_QUERIES = {
    "tpuimg_cuda_error_string": ([_I], ctypes.c_char_p),
    # n, h, w, r, self_guided -> floats of scratch, or -1
    "tpuimg_guided_onepass_scratch_floats": ([_I] * 5, _L),
    # h, w, rg, r -> floats of scratch, or -1 (refused)
    "tpuimg_enhance_tail_scratch_floats": ([_I] * 4, _L),
    # rg, r -> 1 on the shared-memory route, 0 on the scratch route
    "tpuimg_enhance_tail_shared": ([_I] * 2, _I),
    # -> bytes of an enhance plan
    "tpuimg_enhance_plan_bytes": ([], _L),
    # fused1, h, w, ytiles, xtiles, th, tw, pad_top, pad_left, cluster, rows,
    # limit, fr, inv_tw, scale, taps, rg, r, eps, tables_at, blend_at,
    # scratch_at, plan -> a CUDA error code (kernels/enhance_plan.py)
    "tpuimg_enhance_plan": ([_I] * 12 + [_F] * 3 + [Taps, _I, _I, _F]
                            + [_L] * 3 + [_P], _I),
}


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from csrc/ and declare its entries' types."""
    lib = ctypes.CDLL(str(path))
    entries = {name: (list(args), ctypes.c_int)
               for name, args in _SIGNATURES.items()}
    for name, (argtypes, restype) in {**entries, **_QUERIES}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        with span("kernels.load", "load"):
            with span("kernels.build", "load"):
                path = build()
            _lib = bind(path)
    return _lib


def _stream(index: int) -> int:
    """The handle of card ``index``'s current stream."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` with ``args`` plus ``device``'s current stream,
    with ``device`` (the current card where it has no index) the current
    card; raise ``KernelLaunchError`` unless it returns cudaSuccess. Each
    call counts one on ``launches[name]``; the span marks the process's
    first launch of ``name``, which loads its kernels onto the card, and is
    a device span of ``device`` queued at the C call."""
    first = launches[name] == 0
    with span("kernels.launch", "launch", name, first, device) as s:
        fn = getattr(load(), name)
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index == current:
            s.queue()
            err = fn(*args, _stream(index))
        else:
            with torch.cuda.device(index):
                s.queue()
                err = fn(*args, _stream(index))
    launches[name] += 1
    if err != 0:
        msg = load().tpuimg_cuda_error_string(err).decode()
        raise KernelLaunchError(f"{name}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of ``device``'s card, which the grid
    plans fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda_tensor(x: torch.Tensor, name: str, dtype,
                        batched: bool = False) -> None:
    """The checks every wrapper makes before handing a tensor's pointer to a
    kernel: an (H, W) frame, or (..., H, W) frames when ``batched``, of
    ``dtype`` (a dtype, or a tuple of the dtypes the kernel takes)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                         f"got {x.dtype}")
    if x.ndim < 2 if batched else x.ndim != 2:
        want = "at least 2" if batched else "2"
        raise ValueError(f"{name} must have {want} dims, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
