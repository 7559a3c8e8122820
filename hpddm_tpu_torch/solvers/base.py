"""Operator protocol for the Krylov layer (counterpart of ``hpddm_tpu/solvers/base.py``).

The reference's Krylov methods are templated on an ``Operator`` exposing
``GMV`` (global SpMV), ``apply`` (preconditioner) and a POU scaling that
weights all inner products (include/HPDDM_iterative.hpp:49-90). Here an
operator is a small object holding plain functions on tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class LinearOperator:
    """Bundle of (gmv, apply, weighted reductions).

    x layout: (S, n, mu), a batch of subdomains times right-hand sides.
    weight: (S, n) partition of unity for inner products, or None for
    plain dots.
    """

    def __init__(self,
                 gmv: Callable[[torch.Tensor], torch.Tensor],
                 apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 weight: Optional[torch.Tensor] = None,
                 norm_filter: Optional[Callable[[torch.Tensor],
                                                torch.Tensor]] = None):
        self.gmv = gmv
        self.apply = apply if apply is not None else (lambda x: x)
        self.weight = weight
        # optional filter applied to b before the convergence reference
        # norm (IterativeMethod::initializeNorm downscales Dirichlet-
        # penalty entries by HPDDM_PEN, HPDDM_iterative.hpp:455-470)
        self.norm_filter = norm_filter

    def init_norm_sq(self, b: torch.Tensor) -> torch.Tensor:
        """Convergence-reference squared norm of b (penalty-filtered)."""
        if self.norm_filter is not None:
            b = self.norm_filter(b)
        return self.norm_sq(b)

    def weighted(self, y: torch.Tensor) -> torch.Tensor:
        """y (S, n, ...) times the partition of unity, broadcast over y's
        trailing axes; y itself without a weight."""
        if self.weight is None:
            return y
        return self.weight.reshape(self.weight.shape + (1,) * (y.dim() - 2)) \
            * y

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Weighted per-RHS dot <x, y> -> (mu,)."""
        return torch.sum(self.weighted(x.conj()) * y, dim=(0, 1))

    def norm_sq(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.weighted(torch.abs(x) ** 2), dim=(0, 1))

    def gram(self, V: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """All basis dots at once: V (k, S, n, mu), y (S, n, mu) -> (k, mu).
        The CGS single-reduction Gram step (HPDDM_iterative.hpp:489-522)."""
        return torch.einsum("ksnm,snm->km", V.conj(), self.weighted(y))
