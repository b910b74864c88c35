"""Build and load the hand-written CUDA kernels (the counterpart of
``tpuimg.kernels.interpret_mode``).

All sources under ``tpuimg_torch/csrc/`` compile with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``. The library is built at first use into ``tpuimg_torch/_build/``
under a name keyed by a hash of the sources and flags, so a fresh checkout
builds everything on its first call and an edited source never loads a stale
library. A failed build raises ``KernelBuildError``; nothing falls back to
the plain PyTorch versions.

Each wrapper (kernels/hist.py, lut.py, boxsum.py) takes its plain version for
a CPU tensor only. For a CUDA tensor it launches its kernel on the current
stream, without synchronising, or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_TAPS = 33  # csrc/enhance_tail.cu kMaxTaps


class Taps(ctypes.Structure):
    """csrc/enhance_tail.cu ``Taps``: gaussian weights passed by value."""

    _fields_ = [("w", ctypes.c_float * MAX_TAPS)]


# C entry points and their argument types; each returns cudaGetLastError()
_SIGNATURES = {
    # img, h, w, ytiles, xtiles, th, tw, pad_top, pad_left, out, stream
    "tpuimg_tile_hist": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # img, h, w, tables, ytiles, xtiles, th, pad_top, pad_left, inv_tw,
    # out_f32, out, stream
    "tpuimg_clahe_map": (_P, _I, _I, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P),
    # f, h, w, taps, rg, r, eps, out, stream
    "tpuimg_enhance_tail": (_P, _I, _I, Taps, _I, _I, _F, _P, _P),
}

_lib = None


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


def build() -> Path:
    """Compile the sources into the build directory unless the library for
    this exact source hash is already there. Returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the lock serialises concurrent builds; nvcc writes to a temporary
    # name that is renamed into place, so no reader sees half a library
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cu = [str(p) for p in _sources() if p.suffix == ".cu"]
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise KernelBuildError(f"cannot run {cmd[0]}: {e}") from e
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.tpuimg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpuimg_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` with ``args`` plus ``device``'s current stream;
    raise ``KernelLaunchError`` unless it returns cudaSuccess."""
    lib = load()
    with torch.cuda.device(device):  # the tensor's card is the current one
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.tpuimg_cuda_error_string(err).decode()
        raise KernelLaunchError(f"{name}: CUDA error {err} ({msg})")


def require_cuda_tensor(x: torch.Tensor, name: str,
                        dtype: torch.dtype) -> None:
    """The checks every wrapper makes before handing a (2-D) tensor's
    pointer to a kernel."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{name} must have 2 dims, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
