"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, ``build/lib<name>.so`` inside
the package, at first use. The compilers of all stale sources are started
together and run in parallel. A library is rebuilt when its source, or a
header (``csrc/*.cuh``) that the sources share, is newer than it.
``load_from`` builds and loads the sources of another directory into
another one (a parent commit's kernels, timed beside by a benchmark).
``ptxas -v`` reports each kernel's registers, shared memory and spills;
``resources`` reads them from the last build's log. Nothing is built or
loaded at import time: the CPU tests import every module on machines
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import shutil
import subprocess
import tempfile
from types import SimpleNamespace
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of every entry point, by source file (pointers and the
# stream as c_void_p, so ctypes does not cut them to 32 bits)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "dia_spmv": {
        **{f"dia_spmv_{t}": [_P, _P, _P, _I, _I, _I,
                             ctypes.POINTER(ctypes.c_int), _P]
           for t in ("f32", "f64", "c128")},
        **{f"dia_spmm_{t}": [_P, _P, _P, _I, _I, _I, _I, _I,
                             ctypes.POINTER(ctypes.c_int), _P]
           for t in ("f32", "f64", "c128")}},
    "ell_spmv": {f"ell_spmv_{t}": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _P]
                 for t in ("f32", "f64")},
    "pexchange": {f"pexchange_{t}": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P]
                  for t in ("f32", "f64")},
}

_lib: Optional[SimpleNamespace] = None
# the compiler's messages of the last build, by source stem
LOGS: Dict[str, str] = {}


def sources(csrc: str = CSRC) -> List[str]:
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def _stem(src: str) -> str:
    return os.path.splitext(os.path.basename(src))[0]


def library_path(src: str, build_dir: str = BUILD_DIR) -> str:
    return os.path.join(build_dir, f"lib{_stem(src)}.so")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "hpddm_tpu_torch are built on a machine with the "
                           "CUDA toolkit")
    return path


def _stale(src: str, build_dir: str) -> bool:
    lib = library_path(src, build_dir)
    inputs = [src, *glob.glob(os.path.join(os.path.dirname(src), "*.cuh"))]
    return not os.path.exists(lib) or \
        max(map(os.path.getmtime, inputs)) > os.path.getmtime(lib)


def build(force: bool = False, csrc: str = CSRC,
          build_dir: str = BUILD_DIR) -> List[str]:
    """Compile every source of ``csrc`` whose library in ``build_dir`` is
    missing or stale (all of them with ``force``), one ``nvcc`` per source,
    all started together; returns the libraries' paths. Each compile goes
    to a temporary file renamed into place, so an interrupted build leaves
    no half-written library."""
    srcs = sources(csrc)
    todo = [s for s in srcs if force or _stale(s, build_dir)]
    if todo:
        os.makedirs(build_dir, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        try:
            for src in todo:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
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
                    os.replace(tmp, library_path(src, build_dir))
                    LOGS[_stem(src)] = out + err
            if errors:
                raise RuntimeError("\n".join(errors))
        finally:
            for _, tmp, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
    return [library_path(s, build_dir) for s in srcs]


def load() -> SimpleNamespace:
    """Every kernel entry point, by name, from the libraries built on first
    use, with argument and return types declared."""
    global _lib
    if _lib is None:
        _lib = load_from(CSRC, BUILD_DIR, SIGNATURES)
    return _lib


def load_from(csrc: str, build_dir: str,
              signatures: Dict[str, Dict[str, list]]) -> SimpleNamespace:
    """The entry points that ``signatures`` names (by source stem), from
    the sources of ``csrc`` built into ``build_dir``."""
    build(csrc=csrc, build_dir=build_dir)
    fns = {}
    for src in sources(csrc):
        stem = _stem(src)
        if stem not in signatures:
            continue
        lib = ctypes.CDLL(library_path(src, build_dir))
        for name, argtypes in signatures[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
            fns[name] = fn
    return SimpleNamespace(**fns)


def _demangle(names: List[str]) -> List[str]:
    """C++ names through ``c++filt`` where it is installed, else as given."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) \
        else names


def resources(log: str) -> List[dict]:
    """Each kernel's registers, static shared memory and spill bytes from
    a ``ptxas -v`` log, in the order compiled: dicts with ``kernel`` (the
    demangled name and template arguments, without the parameter list),
    ``registers``, ``smem``, ``spill_stores`` and ``spill_loads``."""
    found = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            found.append({"kernel": m.group(1), "registers": 0, "smem": 0,
                          "spill_stores": 0, "spill_loads": 0})
            continue
        if not found:
            continue
        cur = found[-1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    for rec, name in zip(found, _demangle([r["kernel"] for r in found])):
        rec["kernel"] = re.sub(r"^void ", "", name).split("(")[0]
    return found
