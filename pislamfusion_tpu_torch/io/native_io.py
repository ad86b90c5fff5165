"""ctypes bindings for the native image decode + prefetch pipeline
(native/imageio.cpp). Builds the shared library on first use (g++, linked
against the system libjpeg/libpng) and caches the .so next to the source;
every entry point degrades gracefully to PIL when the toolchain or the
libraries are absent.

A copy of pislamfusion_tpu/io/native_io.py with its own copy of the
source (`pislamfusion_tpu_torch/native/imageio.cpp`), built into the
package's git-ignored `_build/` directory. This is host IO: `nvcc` does
not build it, and nothing on the card's path reads an image file.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_SRC = os.path.join(_NATIVE_DIR, "imageio.cpp")
_SO = os.path.join(_PKG_DIR, "_build", "libpsfimageio.so")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _build() -> bool:
    # built under a name of this process's own, then renamed into place,
    # so that processes building at once never load a half-written file
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
           "-o", tmp, "-ljpeg", "-lpng", "-lz", "-lpthread"]
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            print("native imageio build failed:", r.stderr[-500:])
            return False
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        print("native imageio build failed:", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.isfile(_SRC):
            _build_failed = True
            return None
        if (not os.path.isfile(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            print("native imageio load failed:", e)
            _build_failed = True
            return None
        lib.nio_load_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.nio_load_f32.restype = ctypes.c_int
        lib.nio_free.argtypes = [ctypes.c_void_p]
        lib.pf_create.argtypes = [ctypes.c_int]
        lib.pf_create.restype = ctypes.c_void_p
        lib.pf_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int]
        lib.pf_submit.restype = ctypes.c_int
        lib.pf_wait.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.pf_wait.restype = ctypes.c_int
        lib.pf_destroy.argtypes = [ctypes.c_void_p]
        lib.nio_save_png.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
        lib.nio_save_png.restype = ctypes.c_int
        lib.nio_save_png_async.argtypes = lib.nio_save_png.argtypes
        lib.nio_save_png_async.restype = ctypes.c_int
        lib.nio_save_flush.argtypes = []
        lib.nio_save_flush.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _take_buffer(lib, ptr, w, h, c) -> np.ndarray:
    n = w * h * c
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.nio_free(ptr)
    return arr.reshape((h, w) if c == 1 else (h, w, c))


def imread_f32(path: str, gray: bool = False) -> Optional[np.ndarray]:
    """Decode to float32 RGB [H,W,3] (or gray [H,W]) via the native path;
    None if the native library is unavailable or the decode failed."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = ctypes.POINTER(ctypes.c_float)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.nio_load_f32(path.encode(), ctypes.byref(ptr), ctypes.byref(w),
                          ctypes.byref(h), 1 if gray else 0)
    if rc != 0:
        return None
    return _take_buffer(lib, ptr, w.value, h.value, 1 if gray else 3)


class Prefetcher:
    """Decode-ahead pipeline over C++ worker threads (the reference's
    dataset prepare thread, DatasetRTMapper.cpp:171-205). Usage:

        pf = Prefetcher(threads=2)
        tickets = [pf.submit(p) for p in paths[:4]]   # prime
        img = pf.wait(tickets[0])
    """

    def __init__(self, threads: int = 2):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native imageio unavailable")
        self._h = self._lib.pf_create(threads)

    def submit(self, path: str, gray: bool = False) -> int:
        return self._lib.pf_submit(self._h, path.encode(),
                                   1 if gray else 0)

    def wait(self, ticket: int) -> Optional[np.ndarray]:
        ptr = ctypes.POINTER(ctypes.c_float)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        rc = self._lib.pf_wait(self._h, ticket, ctypes.byref(ptr),
                               ctypes.byref(w), ctypes.byref(h),
                               ctypes.byref(c))
        if rc != 0:
            return None
        return _take_buffer(self._lib, ptr, w.value, h.value, c.value)

    def close(self):
        if self._h:
            self._lib.pf_destroy(self._h)
            self._h = None

    def __del__(self):   # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:
            pass


def save_png(path: str, arr: np.ndarray, wait: bool = True) -> bool:
    """PNG encode+write through the native writer (libpng level-2, encode
    and fwrite off the GIL on a worker thread). arr: [H, W] or [H, W, 3]
    uint8. wait=False queues the write (flush with flush_writes()) — the
    mode the geo-tile exporter uses for its hundreds of 256^2 tiles.
    Returns False when the native library is unavailable (caller falls
    back to its Python writer)."""
    lib = get_lib()
    if lib is None:
        return False
    a = np.ascontiguousarray(arr)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    c = 1 if a.ndim == 2 else a.shape[2]
    if c not in (1, 3):
        return False
    h, w = a.shape[:2]
    fn = lib.nio_save_png if wait else lib.nio_save_png_async
    rc = fn(path.encode(), a.ctypes.data_as(ctypes.c_void_p), w, h, c)
    return rc == 0


def flush_writes() -> int:
    """Block until every queued async PNG write finished; returns the
    number of FAILED writes since the last flush."""
    lib = get_lib()
    if lib is None:
        return 0
    return int(lib.nio_save_flush())
