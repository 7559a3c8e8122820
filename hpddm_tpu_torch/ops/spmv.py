"""Batched local sparse matrix products (counterpart of ``hpddm_tpu/ops/spmv.py``).

* DIA: shifted multiply-adds over the diagonals. On a CUDA tensor a single
  right-hand side goes through the SpMV kernel (ops/dia_spmv.py
  ``dia_spmv``), as the JAX package sends it to its Pallas kernel
  (``hpddm_tpu/ops/spmv.py:210-219``), and a panel of right-hand sides
  through the SpMM kernel (``dia_spmm``, the port of
  ``_dia_spmv_blocked_mu``). The JAX package keeps mu > 1 on XLA after a
  TPU measurement (``_MAX_PALLAS_MU``); that says nothing of this card.
  A DIA batch annotated with its grid box (``canvas_hw``) takes the same
  flat path on both devices, where the JAX package takes its 2-D canvas
  form (``hpddm_tpu/ops/spmv.py:208-209``): the seam check guarantees
  that the canvas form reads zero padding exactly where the flat form
  reads a stored zero, so for finite x the two compute the same sums in
  the same order, bitwise, and B1/B2 compute them in one launch where a
  torch canvas form takes about two per diagonal. The plain canvas forms
  (``spmm_dia_canvas``, ``spmm_dia_canvas_muT``) stay as the parity
  references. ``spmm_muT`` takes a panel with the right-hand-side axis
  leading (B3, ``dia_spmm_muT``, on the card), for ``gmv``'s multi-RHS
  grid branch.
* ``-hpddm_gmv_dtype bfloat16``: a DIA batch with its bf16 mirror
  (``values_lp``) takes the plain DIA form on the mirror on both devices,
  accumulating in x's dtype, as the JAX package skips its Pallas kernel
  when the mirror is set (``hpddm_tpu/ops/spmv.py:213-219``); the kernels
  read the full-precision values only. A bf16-valued instantiation of
  B1/B2 is ROADMAP queue B's follow-up.
* ELL: a gather and a sum over each row's slots of the slot-major batch.
  Every ELL product on a CUDA tensor, any mu, goes through
  the hand-written kernel (ops/ell_spmv.py) with the batch's payload, as
  the JAX package sends its windowed ELL operators to its Pallas kernel
  (``hpddm_tpu/ops/spmv.py:193-196``).
* Dense: a batched matmul.

All operate on a batch x: (S, n_max, mu), the ``_muT`` forms on xT
(S, mu, n_max).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hpddm_tpu_torch.core.formats import BatchedDense, BatchedDIA, BatchedELL
from hpddm_tpu_torch.ops.dia_spmv import (dia_spmm, dia_spmm_muT,
                                          dia_spmm_muT_reference, dia_spmv,
                                          dia_spmv_reference)
from hpddm_tpu_torch.ops.ell_spmv import ell_spmv, ell_spmv_reference


def _hot_values(A: BatchedDIA) -> torch.Tensor:
    """The value planes of the product: the bf16 mirror where it is set,
    else the full values (``hpddm_tpu/ops/spmv.py:30-33``)."""
    return A.values_lp if A.values_lp is not None else A.values


def spmm_dia(A: BatchedDIA, x: torch.Tensor) -> torch.Tensor:
    """Plain version: y[s, i, :] = sum_k vals[s, k, i] * x[s, i + off_k, :]."""
    return dia_spmv_reference(_hot_values(A), x, A.offsets)


def dia_canvas_moves(offsets, Wd: int):
    """The flat DIA offsets as 2-D canvas moves (di, dj) with |di|, |dj|
    <= 1 on a canvas of width Wd, or None if an offset is not
    stencil-like."""
    moves = []
    for o in offsets:
        di = int(round(o / Wd)) if Wd else 0
        dj = int(o) - di * Wd
        if abs(dj) > 1 or abs(di) > 1:
            return None
        moves.append((di, dj))
    return moves


def spmm_dia_canvas(A: BatchedDIA, x: torch.Tensor) -> torch.Tensor:
    """Plain canvas form for grid stencils (A.canvas_hw set): the value
    planes and each right-hand side viewed as (H, W) canvases, the +-W
    diagonals as row moves and the +-1 diagonals as column moves into a
    zero halo, summed in diagonal order from zero
    (``hpddm_tpu/ops/spmv.py:66``; a panel is a leading batch axis, as
    its ``spmm_dia_canvas_muT``). Valid where the E/W couplings vanish on
    the canvas row seams (``Schwarz.set_grid_geometry`` checks); a
    non-stencil offset pattern takes the flat form. ``spmm`` does not
    call it: it is the reference that the flat path is held to."""
    if dia_canvas_moves(A.offsets, A.canvas_hw[1]) is None:
        return spmm_dia(A, x)
    return spmm_dia_canvas_muT(A, x.permute(0, 2, 1)) \
        .permute(0, 2, 1).contiguous()


def spmm_dia_canvas_muT(A: BatchedDIA, xT: torch.Tensor) -> torch.Tensor:
    """Plain canvas form with the right-hand-side axis leading: xT (S, mu,
    n) -> (S, mu, n) (``hpddm_tpu/ops/spmv.py:115``). ``spmm_muT`` does not
    call it: it is the reference that B3 on a canvas operator is held
    to."""
    H, Wd = A.canvas_hw
    moves = dia_canvas_moves(A.offsets, Wd)
    if moves is None:
        return dia_spmm_muT_reference(A.values, xT, A.offsets)
    S, k, n = A.values.shape
    mu = xT.shape[1]
    vc = A.values.reshape(S, k, H, Wd)
    xc = xT.reshape(S, mu, H, Wd)
    xp = F.pad(xc, (1, 1, 1, 1))
    out = xc.new_zeros((S, mu, H, Wd),
                       dtype=torch.result_type(A.values, xT))
    for ki, (di, dj) in enumerate(moves):
        out = out + vc[:, ki, None] * \
            xp[:, :, 1 + di: 1 + di + H, 1 + dj: 1 + dj + Wd]
    return out.reshape(S, mu, n)


def spmm_dia_canvas_muT_scan(A: BatchedDIA, xT: torch.Tensor, pair: int = 2,
                             scale=None) -> torch.Tensor:
    """The RHS-leading product in groups of ``pair`` right-hand sides, each
    scaled by ``scale`` (S, n) where given: the JAX package's ``lax.scan``
    form (``hpddm_tpu/ops/spmv.py:150``), which it takes at mu >= 3 on large
    panels to keep a TPU accumulator from spilling. Each group goes
    through ``spmm_muT`` (B3 on the card), so its sums are the fused
    form's; ``gmv`` takes the fused form, and the smoke times both."""
    S, mu, n = xT.shape
    if mu <= pair or mu % pair:
        y = spmm_muT(A, xT)
        return y if scale is None else y * scale[:, None, :]
    y = torch.empty_like(xT)
    for g in range(0, mu, pair):
        ym = spmm_muT(A, xT[:, g: g + pair])
        y[:, g: g + pair] = ym if scale is None else ym * scale[:, None, :]
    return y


def spmm_ell(A: BatchedELL, x: torch.Tensor) -> torch.Tensor:
    """Plain version: y[s, i, :] = sum_j vals[s, j, i] * x[s, cols[s, j, i], :]."""
    return ell_spmv_reference(A.values, A.cols, x)


def spmm_dense(A: BatchedDense, x: torch.Tensor) -> torch.Tensor:
    return torch.bmm(A.values, x)


def spmm(A, x: torch.Tensor) -> torch.Tensor:
    """Dispatch on format. x: (S, n_max, mu) -> (S, n_max, mu)."""
    if isinstance(A, BatchedDIA):
        if A.values_lp is not None:
            return spmm_dia(A, x)
        if x.shape[-1] == 1:
            y = dia_spmv(A.values, x[:, :, 0].contiguous(), A.offsets)
            return y[:, :, None]
        return dia_spmm(A.values, x.contiguous(), A.offsets)
    if isinstance(A, BatchedELL):
        return ell_spmv(A.values, A.cols, x.contiguous(), A.payload)
    if isinstance(A, BatchedDense):
        return spmm_dense(A, x)
    raise TypeError(f"unsupported matrix type {type(A)}")


def spmm_muT(A: BatchedDIA, xT: torch.Tensor) -> torch.Tensor:
    """The DIA product of a panel with the right-hand-side axis leading:
    xT (S, mu, n) -> (S, mu, n), through B3 (``dia_spmm_muT``) on the card
    and its plain version on the CPU; a canvas operator takes the flat
    sums, as ``spmm``; the bf16 mirror, where set, its plain version."""
    if A.values_lp is not None:
        return dia_spmm_muT_reference(A.values_lp, xT, A.offsets)
    return dia_spmm_muT(A.values, xT.contiguous(), A.offsets)
