"""Batched ELL SpMM: the CUDA kernel and its plain PyTorch version.

Counterpart of ``hpddm_tpu/ops/pallas_ell.py`` (``_windowed_spmv``, :133).
``ell_spmv`` computes

    y[s, i, m] = sum_j vals[s, j, i] * x[s, cols[s, j, i], m]

for a slot-major ELL batch, vals (S, w, n) and int32 cols (S, w, n)
(``BatchedELL``), and x (S, n, mu) in f32 or f64. On CUDA
tensors it launches the hand-written kernel ``csrc/ell_spmv.cu``, all mu
right-hand sides in one launch; on CPU tensors it runs
``ell_spmv_reference``, the same function in plain PyTorch. A CUDA tensor
that the kernel does not take raises; nothing falls back.
"""

from __future__ import annotations

import torch

# launches of the CUDA kernel since the last reset (plain-version calls on
# CPU tensors are not counted)
launches = 0

_MAX_S = 65535                # grid.y limit of the launch


def ell_spmv_reference(vals: torch.Tensor, cols: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version: the slots summed in storage order from zero, one
    product and one sum per slot. vals, cols: (S, w, n); x: (S, n, mu)."""
    S, w, n = vals.shape
    mu = x.shape[-1]
    idx = cols.long()
    out = x.new_zeros((S, n, mu), dtype=torch.result_type(vals, x))
    for j in range(w):
        xj = torch.gather(x, 1, idx[:, j, :, None].expand(S, n, mu))
        out = out + vals[:, j, :, None] * xj
    return out


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y (S, n, mu) = slot-major ELL product of vals, cols (S, w, n) with x
    (S, n, mu)."""
    global launches
    tensors = (vals, cols, x)
    if all(t.device.type == "cpu" for t in tensors):
        return ell_spmv_reference(vals, cols, x)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"ell_spmv: vals on {vals.device}, cols on "
                         f"{cols.device}, x on {x.device}; all must be on "
                         "the same CUDA device")
    if vals.dtype != x.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ell_spmv: dtypes {vals.dtype}/{x.dtype}; the kernel "
                        "takes float32 or float64, the same for both")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_spmv: cols of dtype {cols.dtype}; the kernel "
                        "takes int32")
    if vals.dim() != 3 or x.dim() != 3 or cols.shape != vals.shape:
        raise ValueError(f"ell_spmv: shapes {tuple(vals.shape)}, "
                         f"{tuple(cols.shape)} and {tuple(x.shape)}; expected "
                         "(S, w, n), (S, w, n) and (S, n, mu)")
    S, w, n = vals.shape
    mu = x.shape[2]
    if tuple(x.shape[:2]) != (S, n):
        raise ValueError(f"ell_spmv: vals {tuple(vals.shape)} and x "
                         f"{tuple(x.shape)} disagree")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ell_spmv: vals, cols and x must be contiguous")
    if S > _MAX_S or max(n, w, mu) >= 2 ** 31:
        raise ValueError(f"ell_spmv: S={S}, w={w}, n={n}, mu={mu} exceed "
                         f"the kernel's limits (S <= {_MAX_S})")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"ell_spmv: x on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from hpddm_tpu_torch import _build

    lib = _build.load()
    fn = lib.ell_spmv_f64 if x.dtype == torch.float64 else lib.ell_spmv_f32
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
             S, n, w, mu, stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv: kernel launch failed, cudaError {err}")
    launches += 1
    return y
