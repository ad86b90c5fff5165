"""Builds the CUDA kernels of `csrc/` and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers, so
`nvcc` takes seconds) and is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into `_build/<name>-<hash>.so` beside this file, where the hash covers the
source, every header in `csrc/` and the flags — an edited source builds
anew, an unchanged one loads the library already built. Only the
sources in this checkout are built. A failed build raises with the
compiler's output; nothing falls back.

`build_all()` starts one `nvcc` per source, all at once, and waits for
them: the way to build every kernel before a timed run. `load` holds a
lock over its check, build and load, so that threads that first use one
kernel together (SLAM's thread and the fusion consumer) build it once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
KERNELS = ("flatpyr", "patchgather", "shearwarp", "fastselect",
           "bandedstack", "bilineargrid", "packedpyr", "bandedsandwich")

_LIBS: dict = {}
_LOAD_LOCK = threading.Lock()


def kernel_wrappers() -> dict:
    """{kernel: the wrapper that launches it and counts its launches in
    its `launches` attribute}, for each of KERNELS."""
    from .ops import shearwarp as sw
    from .ops import stencil
    from .ops.features import fastselect, flatpyr, packedpyr
    from .ops.features import patchgather as pg
    return {"flatpyr": flatpyr.build_flat_pyramid,
            "patchgather": pg.gather_patches, "shearwarp": sw.warp_patch,
            "fastselect": fastselect.fast_cell_winners,
            "bandedstack": stencil.banded_stack,
            "bilineargrid": pg.bilinear_grid,
            "packedpyr": packedpyr.build_packed_pyramid,
            "bandedsandwich": stencil.banded_sandwich}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "pislamfusion_tpu_torch build only where the CUDA "
                       "toolkit is installed")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc for `name` unless its library exists. Returns
    (process or None, temp path, final path)."""
    out = _lib_path(name)
    if os.path.isfile(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-o", tmp,
                                    os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str) -> str:
    """Wait for a build started by _start; returns the compiler's output
    ("" when the library already existed)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return log


def build_all(names=KERNELS) -> dict:
    """Build every named kernel library, one nvcc each, in parallel.
    Returns {name: compiler output} (registers, shared memory, spills)."""
    started = [(n,) + _start(n) for n in names]
    logs, errors = {}, []
    for name, proc, tmp, out in started:      # wait for every nvcc
        try:
            logs[name] = _finish(name, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            proc, tmp, out = _start(name)
            _finish(name, proc, tmp, out)
            lib = ctypes.CDLL(out)
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
