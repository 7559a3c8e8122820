"""Damped Richardson iteration (counterpart of
``hpddm_tpu/solvers/richardson.py``: the reference's Richardson branch,
option ``-hpddm_richardson_damping_factor``, default 1.0)."""

from __future__ import annotations

from typing import Optional

import torch

from hpddm_tpu_torch.dtypes import HPDDM_EPS, underlying
from hpddm_tpu_torch.solvers.base import LinearOperator
from hpddm_tpu_torch.solvers.gmres import (KrylovResult, first_crossing,
                                           krylov_result)


def richardson(op: LinearOperator, b: torch.Tensor,
               x0: Optional[torch.Tensor] = None, tol: float = 1.0e-6,
               max_it: int = 100, damping: float = 1.0) -> KrylovResult:
    """x <- x + damping * M^-1 (b - A x); the residual checked is the one
    before each update."""
    x = torch.zeros_like(b) if x0 is None else x0
    rdtype = underlying(b.dtype)
    mu = b.shape[-1]
    dev = b.device
    norm = torch.sqrt(op.init_norm_sq(b)).to(rdtype)
    norm = torch.where(norm < HPDDM_EPS, torch.ones_like(norm), norm)
    it = 1
    first_it = torch.zeros(mu, dtype=torch.int64, device=dev)
    rel = torch.full((mu,), float("inf"), dtype=rdtype, device=dev)
    hist = torch.full((max_it + 1, mu), -1.0, dtype=rdtype, device=dev)
    while it <= max_it and bool(torch.any(first_it == 0)):
        r = b - op.gmv(x)
        x = x + damping * op.apply(r)
        res = torch.sqrt(op.norm_sq(r)).to(rdtype)
        first_it = first_crossing(first_it, res <= tol * norm, it)
        rel = res / norm
        hist[min(it, max_it)] = rel.to(rdtype)
        it += 1
    return krylov_result(x, first_it, it, max_it, rel, hist)
