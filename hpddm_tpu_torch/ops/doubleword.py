"""Double-word (paired) arithmetic for on-device iterative refinement
(counterpart of ``hpddm_tpu/ops/doubleword.py``).

The solution is carried as an unevaluated pair ``x = hi + lo`` of
working-precision tensors (about twice the mantissa bits), and the
residual ``r = b - A x`` is computed with error-free transformations
(Knuth 2Sum, Dekker split / 2Prod: double-word arithmetic, Joldes,
Muller and Popescu 2017). On the TPU it stands in for f64; on a card with
native f64 it is measured against a plain f64 solve.

Every operation is an eager elementwise torch op: each rounds on its own,
so no multiply-add is contracted into an FMA (which ``torch.compile``
could do, and which would break the transforms).
"""

from __future__ import annotations

from typing import Tuple

import torch

from hpddm_tpu_torch.core.formats import BatchedDIA, BatchedELL

Pair = Tuple[torch.Tensor, torch.Tensor]


def _split_factor(dtype) -> float:
    # Dekker split: 2^ceil(p/2) + 1 with p the significand's bits
    return 4097.0 if dtype == torch.float32 else 134217729.0


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free sum: a + b = s + e exactly (Knuth, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free sum assuming |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free product: a * b = p + e exactly (Dekker's split: every
    partial product is exactly representable)."""
    p = a * b
    f = _split_factor(a.dtype)
    ca = f * a
    ah = ca - (ca - a)
    al = a - ah
    cb = f * b
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dw_renorm(h: torch.Tensor, lo: torch.Tensor) -> Pair:
    """Renormalize so |lo| <= ulp(hi)/2."""
    return fast_two_sum(h, lo)


def dw_add(x: Pair, y: Pair) -> Pair:
    """Double-word + double-word (the sloppy variant: O(eps^2) relative
    error, ample for a residual)."""
    sh, se = two_sum(x[0], y[0])
    se = se + (x[1] + y[1])
    return fast_two_sum(sh, se)


def dw_neg(x: Pair) -> Pair:
    return -x[0], -x[1]


def dw_mul_f32(a: torch.Tensor, x: Pair) -> Pair:
    """Working-precision value times double-word."""
    p, pe = two_prod(a, x[0])
    pe = pe + a * x[1]
    return fast_two_sum(p, pe)


def dw_from(a: torch.Tensor) -> Pair:
    return a, torch.zeros_like(a)


def dw_to(x: Pair, dtype=None) -> torch.Tensor:
    s = x[0] + x[1]
    return s.to(dtype) if dtype is not None else s


def spmm_dia_dw(A: BatchedDIA, x: Pair) -> Pair:
    """Double-word DIA product y = A x (x, y double-word, the values in
    working precision): the flat form's shifted slices, each diagonal an
    error-free product folded into a double-word accumulator."""
    S, nd, n = A.values.shape
    xh, xl = x
    mu = xh.shape[-1]
    max_off = max((abs(o) for o in A.offsets), default=0)
    zero = xh.new_zeros((S, n, mu))
    if max_off == 0:
        if not nd:
            return zero, zero
        return dw_mul_f32(A.values[:, 0, :, None], (xh, xl))
    pad = (0, 0, max_off, max_off)
    xph = torch.nn.functional.pad(xh, pad)
    xpl = torch.nn.functional.pad(xl, pad)
    acc = (zero, zero)
    for k, off in enumerate(A.offsets):
        sl = slice(max_off + off, max_off + off + n)
        term = dw_mul_f32(A.values[:, k, :, None], (xph[:, sl], xpl[:, sl]))
        acc = dw_add(acc, term)
    return acc


def spmm_ell_dw(A: BatchedELL, x: Pair) -> Pair:
    """Double-word ELL product: one gather per slot of the slot-major
    batch and a double-word sum over the slots in slot order."""
    xh, xl = x
    S, w, n = A.values.shape
    mu = xh.shape[-1]
    zero = xh.new_zeros((S, n, mu))
    acc = (zero, zero)
    for j in range(w):
        idx = A.cols[:, j, :, None].long().expand(-1, -1, mu)
        term = dw_mul_f32(A.values[:, j, :, None],
                          (torch.gather(xh, 1, idx), torch.gather(xl, 1, idx)))
        acc = dw_add(acc, term)
    return acc


def spmm_dw(A, x: Pair) -> Pair:
    """Dispatch on format (DIA or ELL: a dense local block has no
    error-free product here)."""
    if isinstance(A, BatchedDIA):
        return spmm_dia_dw(A, x)
    if isinstance(A, BatchedELL):
        return spmm_ell_dw(A, x)
    raise TypeError(
        f"double-word SpMM needs DIA or ELL local matrices, got {type(A)}")
