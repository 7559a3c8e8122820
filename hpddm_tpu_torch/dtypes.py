"""Scalar type helpers (counterpart of ``hpddm_tpu/dtypes.py``).

Torch dtypes throughout; numpy dtypes are accepted where a caller hands
host data over (``as_torch_dtype``).
"""

from __future__ import annotations

import numpy as np
import torch

_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or a name
    ("float32", "bfloat16", ...: the values of -hpddm_coarse_dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype == "bfloat16":
        return torch.bfloat16
    return _TO_TORCH[np.dtype(dtype)]


def underlying(dtype) -> torch.dtype:
    """Real type underlying a (possibly complex) scalar type."""
    dtype = as_torch_dtype(dtype)
    if dtype == torch.complex64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.float64
    return dtype


def is_complex(dtype) -> bool:
    return as_torch_dtype(dtype) in (torch.complex64, torch.complex128)


def conj(x: torch.Tensor) -> torch.Tensor:
    """Conjugate for complex dtypes, identity otherwise (Wrapper<K>::conj)."""
    return x.conj() if x.is_complex() else x


def downscaled(dtype) -> torch.dtype:
    """Next-lower precision (coarse-level storage under mixed precision):
    f64 -> f32, f32 -> bf16, c128 -> c64, c64 -> c64 (there is no complex
    bf16), as ``hpddm_tpu/dtypes.py:34-48``."""
    dtype = as_torch_dtype(dtype)
    return {torch.float64: torch.float32, torch.float32: torch.bfloat16,
            torch.complex128: torch.complex64}.get(dtype, dtype)


def upscaled(dtype) -> torch.dtype:
    """Next-higher precision (residual replay / reproducibility checks):
    bf16 -> f32 -> f64, c64 -> c128; f64 and c128 stay."""
    dtype = as_torch_dtype(dtype)
    return {torch.bfloat16: torch.float32, torch.float32: torch.float64,
            torch.complex64: torch.complex128}.get(dtype, dtype)


def is_low_precision(dtype) -> bool:
    """Below f64: setup-time factorizations are computed in f64 and rounded
    once (``local_solve.py``, ``geneo.py`` and the coarse inverse)."""
    return as_torch_dtype(dtype) in (torch.float32, torch.bfloat16,
                                     torch.float16)


def machine_eps(dtype) -> float:
    return float(torch.finfo(underlying(dtype)).eps)


# Dirichlet-penalty constants (HPDDM_define.hpp:47-48).
HPDDM_EPS = 1.0e-12
HPDDM_PEN = 1.0e+30
