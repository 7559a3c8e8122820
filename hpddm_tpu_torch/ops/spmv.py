"""Batched local sparse matrix products (counterpart of ``hpddm_tpu/ops/spmv.py``).

* DIA: shifted multiply-adds over the diagonals. On a CUDA tensor a single
  right-hand side goes through the SpMV kernel (ops/dia_spmv.py
  ``dia_spmv``), as the JAX package sends it to its Pallas kernel
  (``hpddm_tpu/ops/spmv.py:210-219``), and a panel of right-hand sides
  through the SpMM kernel (``dia_spmm``, the port of
  ``_dia_spmv_blocked_mu``). The JAX package keeps mu > 1 on XLA after a
  TPU measurement (``_MAX_PALLAS_MU``); that says nothing of this card.
* ELL: a gather and a sum over each row's slots of the slot-major batch.
  Every ELL product on a CUDA tensor, any mu, goes through
  the hand-written kernel (ops/ell_spmv.py) with the batch's payload, as
  the JAX package sends its windowed ELL operators to its Pallas kernel
  (``hpddm_tpu/ops/spmv.py:193-196``).
* Dense: a batched matmul.

All operate on a batch x: (S, n_max, mu).
"""

from __future__ import annotations

import torch

from hpddm_tpu_torch.core.formats import BatchedDense, BatchedDIA, BatchedELL
from hpddm_tpu_torch.ops.dia_spmv import (dia_spmm, dia_spmv,
                                          dia_spmv_reference)
from hpddm_tpu_torch.ops.ell_spmv import ell_spmv, ell_spmv_reference


def spmm_dia(A: BatchedDIA, x: torch.Tensor) -> torch.Tensor:
    """Plain version: y[s, i, :] = sum_k vals[s, k, i] * x[s, i + off_k, :]."""
    return dia_spmv_reference(A.values, x, A.offsets)


def spmm_ell(A: BatchedELL, x: torch.Tensor) -> torch.Tensor:
    """Plain version: y[s, i, :] = sum_j vals[s, j, i] * x[s, cols[s, j, i], :]."""
    return ell_spmv_reference(A.values, A.cols, x)


def spmm_dense(A: BatchedDense, x: torch.Tensor) -> torch.Tensor:
    return torch.bmm(A.values, x)


def spmm(A, x: torch.Tensor) -> torch.Tensor:
    """Dispatch on format. x: (S, n_max, mu) -> (S, n_max, mu)."""
    if isinstance(A, BatchedDIA):
        if x.shape[-1] == 1:
            y = dia_spmv(A.values, x[:, :, 0].contiguous(), A.offsets)
            return y[:, :, None]
        return dia_spmm(A.values, x.contiguous(), A.offsets)
    if isinstance(A, BatchedELL):
        return ell_spmv(A.values, A.cols, x.contiguous(), A.payload)
    if isinstance(A, BatchedDense):
        return spmm_dense(A, x)
    raise TypeError(f"unsupported matrix type {type(A)}")
