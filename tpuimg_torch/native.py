"""ctypes binding for the native loader (port of ``tpuimg.native``).

Fast PNG/JPEG decode and PNG encode, and a threaded prefetching frame
stream, from ``tpuimg_torch/csrc/loader.cpp`` (the port's copy of the JAX
package's ``native/loader.cpp``). The library is built at first use with
``g++`` into ``tpuimg_torch/_build/``, under a name keyed by a hash of the
source and flags, linked under a temporary name and renamed into place
under a file lock, so concurrent first calls build once and no reader sees
half a library. A failed build raises ``NativeBuildError``. Everything here
is optional: ``tpuimg_torch.utils`` reads and writes images through cv2 or
PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "loader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng16", "-ljpeg", "-pthread")

_lib = None
_load_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtpuimg_torch_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/loader.cpp`` unless the library for this source hash
    is already built. Returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
        try:
            done = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeBuildError(f"cannot run g++: {e}") from e
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"g++ failed ({done.returncode}):\n{' '.join(cmd)}\n"
                f"{done.stdout}{done.stderr}")
        os.replace(tmp, lib)
    return lib


def load():
    """Build if needed, then load the library once per process."""
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.tpuimg_image_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.tpuimg_image_dims.restype = ctypes.c_int
        lib.tpuimg_read_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.tpuimg_read_image.restype = ctypes.c_int
        lib.tpuimg_write_png.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.tpuimg_write_png.restype = ctypes.c_int
        lib.tpuimg_stream_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.tpuimg_stream_open.restype = ctypes.c_void_p
        lib.tpuimg_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.tpuimg_stream_next.restype = ctypes.c_long
        lib.tpuimg_stream_close.argtypes = [ctypes.c_void_p]
        lib.tpuimg_stream_close.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the loader builds and loads here (g++, libpng16, libjpeg)."""
    try:
        load()
        return True
    except (OSError, NativeBuildError):
        return False


def read_image(path: str, gray: bool = True) -> np.ndarray:
    """Decode a PNG/JPEG to uint8 (H, W) or (H, W, 3)."""
    lib = load()
    want = 1 if gray else 3
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.tpuimg_image_dims(path.encode(), want, ctypes.byref(w),
                             ctypes.byref(h)) != 0:
        raise IOError(f"failed to decode {path}")
    shape = (h.value, w.value) if gray else (h.value, w.value, 3)
    buf = np.empty(shape, np.uint8)
    if lib.tpuimg_read_image(path.encode(), want,
                             buf.ctypes.data_as(ctypes.c_void_p),
                             w.value, h.value) != 0:
        raise IOError(f"failed to decode {path}")
    return buf


def write_png(path: str, img) -> None:
    """Encode a uint8 (H, W) or (H, W, 3) host array (or CPU tensor)."""
    lib = load()
    img = np.asarray(img)
    if img.dtype != np.uint8:
        # an implicit cast would wrap/truncate (float [0,1] -> near-black)
        raise TypeError(
            f"write_png takes uint8 (use the library's rint+clip "
            f"convention first), got {img.dtype}")
    img = np.ascontiguousarray(img)
    c = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or c not in (1, 3):
        # loader.cpp writes IHDR as gray/RGB only; RGBA would silently
        # produce a channel-shifted file (row stride w*c vs 3*w consumed)
        raise ValueError(f"write_png supports 1 or 3 channels, got {c}")
    h, w = img.shape[:2]
    if lib.tpuimg_write_png(path.encode(),
                            img.ctypes.data_as(ctypes.c_void_p), w, h, c) != 0:
        raise IOError(f"failed to write {path}")


class FrameStream:
    """Threaded prefetching frame stream with a fixed slot shape.

    Decodes and resizes on native worker threads ahead of the consumer so
    the card never waits on IO:

        with FrameStream(paths, (2160, 3840), gray=True) as fs:
            for idx, frame in fs:
                out = tpuimg_torch.clahe(torch.from_numpy(frame).to(dev))

    Frames may arrive out of order; ``idx`` is the frame's index in
    ``paths``. A frame that fails to decode raises ``IOError`` naming it.
    """

    def __init__(self, paths, slot_hw, gray: bool = True, threads: int = 4,
                 capacity: int = 8):
        self._lib = load()
        self._n = len(paths)
        self._gray = gray
        self._hw = tuple(slot_hw)
        self._lock = threading.Lock()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = self._lib.tpuimg_stream_open(
            arr, len(paths), 1 if gray else 3, self._hw[1], self._hw[0],
            threads, capacity)
        if not self._handle:
            raise IOError("failed to open stream")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        shape = self._hw if self._gray else (*self._hw, 3)
        for _ in range(self._n):
            # _lock serializes against close(): ctypes releases the GIL
            # during the blocking next(), so without it a concurrent
            # close() could free the native stream mid-call (and a
            # post-close next() would pass NULL and segfault)
            with self._lock:
                if self._handle is None:
                    return
                buf = np.empty(shape, np.uint8)
                idx = self._lib.tpuimg_stream_next(
                    self._handle, buf.ctypes.data_as(ctypes.c_void_p))
            if idx == -1:
                return
            if idx < -1:  # -(index + 2): that frame failed to decode
                raise IOError(f"failed to decode frame {-idx - 2}")
            yield idx, buf

    def close(self):
        with self._lock:
            if self._handle:
                self._lib.tpuimg_stream_close(self._handle)
                self._handle = None

    def __del__(self):
        # last-resort cleanup: a dropped stream (no `with`, exception
        # before close) would otherwise leak the native worker threads and
        # decoded-slot buffers for the life of the process
        if getattr(self, "_lock", None) is not None:
            self.close()
