"""Batched local direct solves (counterpart of ``hpddm_tpu/ops/local_solve.py``).

Subdomain problems are small (1e3-1e4 dofs), so local solves are batched
dense factorizations instead of the reference's sparse direct solvers
(MUMPS / PARDISO, e.g. ``MumpsSub::numfact/solve``). This slice ports the
``inv`` strategy: the explicit inverse, computed once at setup, makes every
solve one batched matmul. Padded rows must be identity rows
(``pack_local_matrices`` guarantees it).
"""

from __future__ import annotations

import dataclasses

import torch

from hpddm_tpu_torch.dtypes import is_low_precision


@dataclasses.dataclass(frozen=True)
class LocalSolver:
    kind: str
    factor: torch.Tensor          # inv: A^-1, (S, n, n)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Solve A x = b for a batch b: (S, n, mu). A factor kept in
        another dtype than b (``Schwarz.build(dtype=...)``) is promoted
        with b, as the JAX package's einsum promotes it."""
        if self.kind == "inv":
            return torch.bmm(promoted(self.factor, b),
                             promoted(b, self.factor))
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


def factorize(A: torch.Tensor, kind: str = "inv") -> LocalSolver:
    """Factorize a batch of dense local matrices A: (S, n, n)."""
    if kind == "inv":
        return LocalSolver(kind="inv", factor=invert(A))
    if kind in ("lu", "chol", "qr"):
        raise NotImplementedError(
            f"local_solver={kind!r} is not ported yet (ROADMAP queue A, "
            "slice 5); use 'inv'")
    raise ValueError(f"unknown local solver kind {kind!r}")
