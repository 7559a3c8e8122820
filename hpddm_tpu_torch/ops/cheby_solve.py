"""Chebyshev inexact local solves for large subdomains (counterpart of
``hpddm_tpu/ops/cheby_solve.py``).

Batched dense factors cap local sizes at about 10k unknowns (O(n^2)
memory) and the DST solver (ops/fft_solve.py) is exact only for the
constant-coefficient stencil. For large heterogeneous grid subdomains the
local solve is inexact: k steps of preconditioned Chebyshev iteration on
the local matrix, preconditioned by the DST solve with the diagonal
scaling R (spectrally equivalent for variable-coefficient diffusion) or by
the Jacobi diagonal. Chebyshev with fixed coefficients is a fixed linear
operator, so the Schwarz preconditioner stays linear and plain GMRES stays
valid. No factor memory; every step is one operator product (the DIA
kernel B1 on the card for a DIA batch, ``ops/spmv.spmm``) and one inner
solve, with no host read inside the recursion.

The per-subdomain spectral bounds of M^-1 A come from ``power_its`` steps
of batched power iteration (lmax) and of shifted power iteration (lmin),
widened to hi = 1.05 lmax, lo = max(0.7 lmin, 1e-4 lmax). The JAX
package draws its start vector with ``jax.random.normal(PRNGKey(seed))``,
which torch cannot reproduce: the port draws it from a ``torch.Generator``
seeded with ``seed``, and takes the caller's ``v0`` where given (the
parity tests hand it the JAX package's vector). The power iteration takes
``sum(v * w)`` without a conjugate, as the JAX package does, so the bounds
hold for real matrices only; ``Schwarz`` refuses complex ones (ROADMAP
queue C, C16).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from hpddm_tpu_torch.core.formats import BatchedDense, BatchedDIA, BatchedELL
from hpddm_tpu_torch.ops.spmv import spmm


@dataclasses.dataclass(frozen=True)
class JacobiSolver:
    """Diagonal solve: the minimal inner preconditioner."""
    dinv: torch.Tensor                  # (S, n_max)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self.dinv[:, :, None] * b


def with_dtype(A, dtype):
    """The batch A with its values in dtype (A itself when they are)."""
    if A.values.dtype == dtype:
        return A
    if isinstance(A, BatchedELL):
        return A.astype(dtype)
    return dataclasses.replace(A, values=A.values.to(dtype))


@dataclasses.dataclass(frozen=True)
class ChebyLocalSolver:
    """k-step preconditioned Chebyshev as a batched local solver."""
    A: Any                              # Batched{DIA,ELL,Dense} local matrices
    inner: Optional[Any]                # DST solver (fft_solve) or None
    dinv: Optional[torch.Tensor]        # (S, n_max) Jacobi when inner is None
    # R = sqrt(diag(L)/diag(A)), which makes the DST preconditioner
    # M = R^-1 L R^-1 match A's diagonal: for a heterogeneous coefficient
    # spec(M^-1 A) clusters by the local jumps, not the global contrast
    scale: Optional[torch.Tensor]       # (S, n_max) or None
    lo: torch.Tensor                    # (S,) lower spectral bound of M^-1 A
    hi: torch.Tensor                    # (S,) upper spectral bound
    k: int

    def _minv(self, r: torch.Tensor) -> torch.Tensor:
        if self.inner is not None:
            if self.scale is not None:
                s = self.scale[:, :, None]
                return s * self.inner.solve(s * r)
            return self.inner.solve(r)
        return self.dinv[:, :, None] * r

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Approximate A^-1 b by k Chebyshev steps; b: (S, n_max, mu)."""
        dt = torch.promote_types(b.dtype, self.A.values.dtype)
        A = with_dtype(self.A, dt)
        b = b.to(dt)
        theta = ((self.hi + self.lo) / 2.0)[:, None, None]
        delta = ((self.hi - self.lo) / 2.0)[:, None, None]
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        x = torch.zeros_like(b)
        r = b
        d = self._minv(r) / theta
        for _ in range(self.k):
            x = x + d
            r = r - spmm(A, d)
            z = self._minv(r)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * z
            rho = rho_new
        return x + d


def _extract_dinv(A, n_max: int) -> torch.Tensor:
    """1 / diag(A) where the diagonal is nonzero, else 1: (S, n_max). DIA
    reads the values plane at offset 0 (a canvas-annotated batch too), ELL
    sums each row's slots that hold its own column (slot-major layout),
    dense reads the diagonal."""
    if isinstance(A, BatchedDIA):
        diag = A.values[:, A.offsets.index(0), :]
    elif isinstance(A, BatchedELL):
        row = torch.arange(n_max, dtype=A.cols.dtype,
                           device=A.cols.device)[None, None, :]
        diag = torch.sum(torch.where(A.cols == row, A.values,
                                     torch.zeros_like(A.values)), dim=1)
    elif isinstance(A, BatchedDense):
        diag = torch.diagonal(A.values, dim1=1, dim2=2)
    else:
        raise TypeError(type(A))
    return torch.where(torch.abs(diag) > 0, 1.0 / diag,
                       torch.ones_like(diag))


def build_cheby_solver(A, row_mask: torch.Tensor, inner: Optional[Any] = None,
                       k: int = 16, power_its: int = 30, seed: int = 7,
                       v0: Optional[torch.Tensor] = None) -> ChebyLocalSolver:
    """Estimate the per-subdomain bounds of M^-1 A and build the solver
    (``hpddm_tpu/ops/cheby_solve.py:105``).

    row_mask: (S, n_max) bool, the valid rows (pads are left out of the
    estimates; the DST solve returns 0 there and the POU is 0 there).
    v0: the start vector (S, n_max, 1) before masking and normalization;
    None draws it from a ``torch.Generator`` seeded with ``seed`` (on the
    CPU, so every device starts from the same vector)."""
    S, n_max = row_mask.shape
    dtype = A.values.dtype
    dinv = None if inner is not None else _extract_dinv(A, n_max)
    scale = None
    if inner is not None:
        # the DST solver is built for the unit-coefficient operator, whose
        # diagonal is constant; any constant works up to a factor that the
        # bounds absorb, so diag(L) is taken as 1
        dA = 1.0 / _extract_dinv(A, n_max)
        r = torch.sqrt(torch.where(torch.abs(dA) > 0, 1.0 / torch.abs(dA),
                                   torch.ones_like(dA)))
        scale = torch.where(row_mask, r, torch.zeros_like(r)).to(dtype)
    ones = torch.ones(S, dtype=dtype, device=row_mask.device)
    sol = ChebyLocalSolver(A=A, inner=inner, dinv=dinv, scale=scale,
                           lo=ones, hi=ones, k=k)
    mask = row_mask[:, :, None].to(dtype)

    def op(v):
        return sol._minv(spmm(A, v)) * mask

    def normalize(v):
        nrm = torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True))
        return v / torch.where(nrm > 0, nrm, torch.ones_like(nrm))

    if v0 is None:
        gen = torch.Generator().manual_seed(seed)
        v0 = torch.randn((S, n_max, 1), generator=gen, dtype=torch.float64)
    v = normalize(v0.to(device=row_mask.device, dtype=dtype) * mask)
    # lmax: power iteration on M^-1 A
    lam = None
    for _ in range(power_its):
        w = op(v)
        lam = torch.sum(v * w, dim=(1, 2))
        v = normalize(w)
    lmax = lam
    # lmin: power iteration on (s I - M^-1 A), s = 1.05 lmax
    shift = (1.05 * lmax)[:, None, None]
    for _ in range(power_its):
        w = shift * v * mask - op(v)
        lam = torch.sum(v * w, dim=(1, 2))
        v = normalize(w)
    lmin = shift[:, 0, 0] - lam
    # widen both ends: an overestimated hi only slows convergence, lo must
    # stay positive
    hi = 1.05 * lmax
    lo = torch.maximum(0.7 * lmin, 1e-4 * lmax)
    return dataclasses.replace(sol, lo=lo.to(dtype), hi=hi.to(dtype))
