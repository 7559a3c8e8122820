"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, ``build/lib<name>.so`` inside
the package, at first use. The compilers of all stale sources are started
together and run in parallel. A library is rebuilt when its source is newer
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
from types import SimpleNamespace
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of every entry point, by source file (pointers and the
# stream as c_void_p, so ctypes does not cut them to 32 bits)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "dia_spmv": {f"dia_spmv_{t}": [_P, _P, _P, _I, _I, _I,
                                   ctypes.POINTER(ctypes.c_int), _P]
                 for t in ("f32", "f64")},
    "dia_spmm": {f"dia_spmm_{t}": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   ctypes.POINTER(ctypes.c_int), _P]
                 for t in ("f32", "f64")},
    "ell_spmv": {f"ell_spmv_{t}": [_P, _P, _P, _P, _I, _I, _I, _I, _P]
                 for t in ("f32", "f64")},
    "pexchange": {f"pexchange_{t}": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
                  for t in ("f32", "f64")},
}

_lib: Optional[SimpleNamespace] = None


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path(src: str) -> str:
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}.so")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "hpddm_tpu_torch are built on a machine with the "
                           "CUDA toolkit")
    return path


def _stale(src: str) -> bool:
    lib = library_path(src)
    return not os.path.exists(lib) or \
        os.path.getmtime(src) > os.path.getmtime(lib)


def build(force: bool = False) -> List[str]:
    """Compile every source whose library is missing or stale (all of them
    with ``force``), one ``nvcc`` per source, all started together; returns
    the libraries' paths. Each compile goes to a temporary file renamed
    into place, so an interrupted build leaves no half-written library."""
    srcs = sources()
    todo = [s for s in srcs if force or _stale(s)]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        try:
            for src in todo:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                jobs.append((src, tmp, proc))
            errors = []
            for src, tmp, proc in jobs:
                out, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed on {src} ({proc.returncode}):"
                                  f"\n{out}\n{err}")
                else:
                    os.replace(tmp, library_path(src))
            if errors:
                raise RuntimeError("\n".join(errors))
        finally:
            for _, tmp, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
    return [library_path(s) for s in srcs]


def load() -> SimpleNamespace:
    """Every kernel entry point, by name, from the libraries built on first
    use, with argument and return types declared."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    fns = {}
    for src in sources():
        stem = os.path.splitext(os.path.basename(src))[0]
        lib = ctypes.CDLL(library_path(src))
        for name, argtypes in SIGNATURES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
            fns[name] = fn
    _lib = SimpleNamespace(**fns)
    return _lib
