"""Preconditioned conjugate gradient, pseudo-block over multiple RHS
(counterpart of ``hpddm_tpu/solvers/cg.py``, the reference's
include/HPDDM_CG.hpp:31-168).

POU-weighted dot products, per-RHS convergence tracking (a right-hand side
that has converged stops updating) and the convergence reference ||b||, as
GMRES. The reference's switch from CG to GMRES under a nonsymmetric
preconditioner (HPDDM_CG.hpp:40-42) lives in ``solvers/krylov.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpddm_tpu_torch.dtypes import HPDDM_EPS, underlying
from hpddm_tpu_torch.solvers.base import LinearOperator
from hpddm_tpu_torch.solvers.gmres import (KrylovResult, first_crossing,
                                           krylov_result)


def cg(op: LinearOperator, b: torch.Tensor,
       x0: Optional[torch.Tensor] = None, tol: float = 1.0e-6,
       max_it: int = 100) -> KrylovResult:
    """Solve SPD A x = b with preconditioned CG. b, x0: (S, n, mu)."""
    x = torch.zeros_like(b) if x0 is None else x0
    rdtype = underlying(b.dtype)
    mu = b.shape[-1]
    dev = b.device
    norm = torch.sqrt(op.init_norm_sq(b)).to(rdtype)
    norm = torch.where(norm < HPDDM_EPS, torch.ones_like(norm), norm)

    r = b - op.gmv(x)
    z = op.apply(r)
    p = z
    rz = op.dot(r, z)
    it = 1
    first_it = torch.zeros(mu, dtype=torch.int64, device=dev)
    rel = torch.full((mu,), float("inf"), dtype=rdtype, device=dev)
    hist = torch.full((max_it + 1, mu), -1.0, dtype=rdtype, device=dev)
    while it <= max_it and bool(torch.any(first_it == 0)):
        Ap = op.gmv(p)
        pAp = op.dot(p, Ap)
        alpha = rz / torch.where(torch.abs(pAp) > 0, pAp,
                                 torch.ones_like(pAp))
        # right-hand sides that have converged stop updating
        active = first_it == 0
        alpha = torch.where(active, alpha, torch.zeros_like(alpha))
        x = x + alpha * p
        r = r - alpha * Ap
        z = op.apply(r)
        rz_new = op.dot(r, z)
        res = torch.sqrt(torch.abs(op.norm_sq(r))).to(rdtype)
        first_it = first_crossing(first_it, active & (res <= tol * norm), it)
        beta = rz_new / torch.where(torch.abs(rz) > 0, rz,
                                    torch.ones_like(rz))
        p = z + beta * p
        rz = rz_new
        rel = res / norm
        hist[min(it, max_it)] = rel.to(rdtype)
        it += 1
    return krylov_result(x, first_it, it, max_it, rel, hist)
