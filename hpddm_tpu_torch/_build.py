"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, ``build/libhpddm_torch_kernels.so`` inside
the package, at first use. The library is rebuilt when any source is newer
than it. Nothing is built or loaded at import time: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libhpddm_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "hpddm_tpu_torch are built on a machine with the "
                           "CUDA toolkit")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(src) > built for src in sources())


def build(force: bool = False) -> str:
    """Compile the kernels if the library is missing or stale; returns its
    path. The compile goes to a temporary file renamed into place, so an
    interrupted build leaves no half-written library."""
    if not force and not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry point's
    argument and return types declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("dia_spmv_f32", "dia_spmv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                       ctypes.POINTER(ctypes.c_int), ptr]
        fn.restype = i32
    _lib = lib
    return lib
