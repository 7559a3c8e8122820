"""Batched local direct solves (counterpart of ``hpddm_tpu/ops/local_solve.py``).

Subdomain problems are small (1e3-1e4 dofs), so local solves are batched
dense factorizations instead of the reference's sparse direct solvers
(MUMPS / PARDISO, e.g. ``MumpsSub::numfact/solve``). Strategies
(``-hpddm_local_solver``), real and complex:

* ``inv``: the explicit inverse, computed once at setup, makes every
  solve one batched matmul;
* ``lu``: LU with partial pivoting (``torch.linalg.lu_factor`` /
  ``lu_solve``), the reference's own kind of local solve;
* ``chol``: Cholesky for Hermitian positive definite local matrices, two
  triangular solves (L, then its conjugate transpose);
* ``qr``: Householder QR, x = R^-1 Q^H b.

``factorize_pinv`` is the eigh-based pseudo-inverse of (possibly
singular) Hermitian Neumann matrices. These are library factorizations,
as in the JAX package (outside Pallas). Padded rows must be identity rows
(``pack_local_matrices`` guarantees it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hpddm_tpu_torch.dtypes import is_low_precision

KINDS = ("inv", "lu", "chol", "qr")


@dataclasses.dataclass(frozen=True)
class LocalSolver:
    kind: str
    # inv: A^-1 ; lu: packed LU, aux = pivots (1-based, int32) ;
    # chol: L ; qr: Q, aux = R ; each (S, n, n)
    factor: torch.Tensor
    aux: Optional[torch.Tensor] = None

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Solve A x = b for a batch b: (S, n, mu). A factor kept in
        another dtype than b (``Schwarz.build(dtype=...)``) is promoted
        with b, as the JAX package's einsum promotes it."""
        f = promoted(self.factor, b)
        rhs = promoted(b, self.factor)
        if self.kind == "inv":
            return torch.bmm(f, rhs)
        if self.kind == "lu":
            return torch.linalg.lu_solve(f, self.aux, rhs)
        if self.kind == "chol":
            y = torch.linalg.solve_triangular(f, rhs, upper=False)
            return torch.linalg.solve_triangular(f.mH, y, upper=True)
        if self.kind == "qr":
            return torch.linalg.solve_triangular(
                promoted(self.aux, b), f.mH @ rhs, upper=True)
        raise ValueError(f"unknown local solver kind {self.kind!r}")


def promoted(a: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """a in the dtype that a product of a and other is computed in (the
    type promotion of jnp's einsum and matmul, which torch.bmm does not
    do); a itself when it already has it."""
    dt = torch.promote_types(a.dtype, other.dtype)
    return a if a.dtype == dt else a.to(dt)


def invert(A: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch (..., n, n). Below f64 the inverse is computed in
    f64 on the same device and rounded once: inverting an ill-conditioned
    local matrix in f32 loses ~cond(A) accuracy (the JAX package does the
    same through host f64, ``local_solve.py:71-75``)."""
    if is_low_precision(A.dtype):
        return torch.linalg.inv(A.to(torch.float64)).to(A.dtype)
    return torch.linalg.inv(A)


def factor_parts(A: torch.Tensor, kind: str):
    """(factor, aux) of ``kind`` for a batch A (..., n, n), the arrays of
    ``LocalSolver``: the JAX package computes lu, chol and qr in A's own
    dtype (``hpddm_tpu/ops/local_solve.py:76-84``) and so does the port.
    ``chol`` of a matrix that is not Hermitian positive definite raises."""
    if kind == "inv":
        return invert(A), None
    if kind == "lu":
        return torch.linalg.lu_factor(A)
    if kind == "chol":
        return torch.linalg.cholesky(A), None
    if kind == "qr":
        return torch.linalg.qr(A)
    raise ValueError(f"unknown local solver kind {kind!r}")


def factorize(A: torch.Tensor, kind: str = "inv") -> LocalSolver:
    """Factorize a batch of dense local matrices A: (S, n, n)."""
    factor, aux = factor_parts(A, kind)
    return LocalSolver(kind=kind, factor=factor, aux=aux)


def factorize_pinv(A: torch.Tensor, rtol: float = 1e-10) -> LocalSolver:
    """Pseudo-inverse factorization of (possibly singular) Hermitian
    Neumann matrices (FETI's K^+; HPDDM regularizes or QR-pseudo-inverts,
    HPDDM_schur.hpp:338-353), batched and eigh-based:
    A^+ = V diag(1/lambda where |lambda| > rtol max|lambda|) V^H. The JAX
    package's product takes V^T (``hpddm_tpu/ops/local_solve.py:87-96``),
    the same for real A; for complex A the conjugate transpose is the
    pseudo-inverse (ROADMAP queue C, C12)."""
    w, v = torch.linalg.eigh(A)
    tol = rtol * torch.amax(torch.abs(w), dim=-1, keepdim=True)
    big = torch.abs(w) > tol
    inv_w = torch.where(big, 1.0 / torch.where(big, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    return LocalSolver(kind="inv",
                       factor=(v * inv_w.to(v.dtype)[..., None, :]) @ v.mH)
