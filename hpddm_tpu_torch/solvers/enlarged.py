"""Enlarged Krylov subspace methods (counterpart of
``hpddm_tpu/solvers/enlarged.py``).

Re-design of the reference's enlarged-Krylov preprocessing
(HPDDM_iterative.hpp:735-853 and HPDDM_subdomain.hpp:661-750): a single
right-hand side is split into ``k`` column-disjoint slices by subdomain
groups, the system is solved with a block method over the k slices, and the
partial solutions are summed. Each slice is made consistent with one scaled
exchange, slice_j = exchange(D * f * 1_{group j}), so that
sum_j slice_j = f for a consistent f.
"""

from __future__ import annotations

import torch

from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.parallel.ops import scaled_exchange


def preprocess(dec: Decomposition, f: torch.Tensor, k: int) -> torch.Tensor:
    """Split a consistent single RHS (S, n, 1) into k slices (S, n, k)."""
    S = f.shape[0]
    group = (torch.arange(S, device=f.device) * k) // S
    ind = group[:, None] == torch.arange(k, device=f.device)[None, :]
    return scaled_exchange(dec, f * ind[:, None, :].to(f.dtype))


def postprocess(x_slices: torch.Tensor) -> torch.Tensor:
    """Recombine: x = sum_j x_j -> (S, n, 1)."""
    return torch.sum(x_slices, dim=-1, keepdim=True)
