"""Batched DIA SpMV: the CUDA kernel and its plain PyTorch version.

Counterpart of ``hpddm_tpu/ops/pallas_spmv.py`` (``_dia_spmv_blocked``,
:98). ``dia_spmv`` computes

    y[s, i] = sum_k vals[s, k, i] * x[s, i + offsets[k]]

with x read as 0 outside [0, n), for vals (S, nd, n) and x (S, n) in f32 or
f64. On CUDA tensors it launches the hand-written kernel
``csrc/dia_spmv.cu``; on CPU tensors it runs ``dia_spmv_reference``, the
same function in plain PyTorch. A CUDA tensor that the kernel does not take
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

# launches of the CUDA kernel since the last reset (plain-version calls on
# CPU tensors are not counted)
launches = 0

MAX_DIAGS = 32                # DIA_MAX_DIAGS of csrc/dia_spmv.cu
_MAX_S = 65535                # grid.y limit of the launch


def dia_spmv_reference(vals: torch.Tensor, x: torch.Tensor,
                       offsets: Sequence[int]) -> torch.Tensor:
    """Plain version: y = sum_k vals[:, k] * shift(x, offsets[k]), summed in
    diagonal order from zero. x: (S, n) or (S, n, mu); vals: (S, nd, n)."""
    S, nd, n = vals.shape
    extra = x.dim() - 2
    w = max((abs(int(o)) for o in offsets), default=0)
    xp = F.pad(x, (0, 0) * extra + (w, w))          # zero halo on axis 1
    out = x.new_zeros(x.shape, dtype=torch.result_type(vals, x))
    for k, off in enumerate(offsets):
        shifted = xp[:, w + off: w + off + n]
        out = out + vals[:, k].reshape(S, n, *([1] * extra)) * shifted
    return out


def dia_spmv(vals: torch.Tensor, x: torch.Tensor,
             offsets: Sequence[int]) -> torch.Tensor:
    """y (S, n) = DIA product of vals (S, nd, n) with x (S, n)."""
    global launches
    if vals.device.type == "cpu" and x.device.type == "cpu":
        return dia_spmv_reference(vals, x, offsets)
    if not (vals.is_cuda and x.is_cuda and vals.device == x.device):
        raise ValueError(f"dia_spmv: vals on {vals.device}, x on {x.device}; "
                         "both must be on the same CUDA device")
    if vals.dtype != x.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia_spmv: dtypes {vals.dtype}/{x.dtype}; the kernel "
                        "takes float32 or float64, the same for both")
    if vals.dim() != 3 or x.dim() != 2:
        raise ValueError(f"dia_spmv: shapes {tuple(vals.shape)} and "
                         f"{tuple(x.shape)}; expected (S, nd, n) and (S, n)")
    S, nd, n = vals.shape
    if tuple(x.shape) != (S, n) or len(offsets) != nd:
        raise ValueError(f"dia_spmv: vals {tuple(vals.shape)}, x "
                         f"{tuple(x.shape)}, {len(offsets)} offsets disagree")
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv: vals and x must be contiguous")
    if nd > MAX_DIAGS or S > _MAX_S or n * max(nd, 1) >= 2 ** 31:
        raise ValueError(f"dia_spmv: S={S}, nd={nd}, n={n} exceed the "
                         f"kernel's limits (nd <= {MAX_DIAGS}, S <= {_MAX_S})")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"dia_spmv: x on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from hpddm_tpu_torch import _build

    lib = _build.load()
    fn = lib.dia_spmv_f64 if x.dtype == torch.float64 else lib.dia_spmv_f32
    y = torch.empty_like(x)
    offs = (ctypes.c_int * max(nd, 1))(*[int(o) for o in offsets])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(vals.data_ptr(), x.data_ptr(), y.data_ptr(), S, nd, n, offs,
             stream)
    if err != 0:
        raise RuntimeError(f"dia_spmv: kernel launch failed, cudaError {err}")
    launches += 1
    return y
