"""Runtime communication primitives (counterpart of ``hpddm_tpu/parallel/ops.py``).

The reference's halo exchange is an additive reduction over duplicated
unknowns (HPDDM_subdomain.hpp:115-130); dot products weight by the
partition of unity so overlapping dofs count once
(HPDDM_iterative.hpp:489-522). All subdomains live in one batch on one
device, so no collective is needed (the JAX package's ``axis_name=None``):

* ``exchange``: gather the interface values, add the partner copies, write
  the sums back. Fixed reduction order; bitwise equal to the JAX package's
  general path (``parallel/ops.py:184-237``). With a grid plan attached
  (``dec.grid``, ``Schwarz.set_grid_geometry``) every tensor takes the
  slab exchange (parallel/grid.py) first, as in the JAX package
  (``parallel/ops.py:198-200``). An interface-first decomposition
  (``dec.renumbered``) reduces the contiguous block x[:, :m_max] and keeps
  the rest (``parallel/ops.py:201-205``): no full-vector gather or
  scatter. Else, with a one-pass plan attached
  (``dec.pexch``, ELL operators) a CUDA tensor takes the one-pass kernel
  (parallel/pexchange.py), as the JAX package sends it to its Pallas
  exchange (``parallel/ops.py:224-230``); the result is the same to the
  bit.
* ``scaled_exchange``: multiply by the POU first (``Schwarz::exchange``).
* ``weighted_dot`` / ``weighted_norm_sq`` / ``weighted_gram``: the
  POU-weighted reductions of the Krylov loop.
"""

from __future__ import annotations

import torch

from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.parallel.grid import grid_exchange
from hpddm_tpu_torch.parallel.pexchange import pexchange


def _interface_reduce(dec: Decomposition, vals: torch.Tensor) -> torch.Tensor:
    """Sum interface contributions over all copies, scatter-free.

    vals: (S, m_max, mu) gathered interface values (zero on invalid slots).
    Each slot adds its k_max partner slots (sentinel = a zero row), one
    partner at a time in partner order, as the JAX package's reduction."""
    mu = vals.shape[-1]
    flat = torch.cat([vals.reshape(-1, mu), vals.new_zeros((1, mu))])
    pvals = flat[dec.partners]                       # (S, m_max, k_max, mu)
    acc = pvals[:, :, 0]
    for k in range(1, pvals.shape[2]):
        acc = acc + pvals[:, :, k]
    return vals + acc


def _scatter_rows(dec: Decomposition, x: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """out = x with out[s, if_idx[s, k], :] = vals[s, k, :] on valid slots."""
    S, n, mu = x.shape
    pos, slot = dec.scatter_index
    out = x.clone(memory_format=torch.contiguous_format)
    out.view(S * n, mu).index_copy_(0, pos, vals.reshape(-1, mu)[slot])
    return out


def exchange(dec: Decomposition, x: torch.Tensor) -> torch.Tensor:
    """Sum-reduce duplicated unknowns (``Subdomain::exchange``).

    x: (S, n_max, mu). Afterwards every copy of a shared dof holds the sum
    of all copies; interior dofs are untouched. Returns a new contiguous
    tensor."""
    if dec.grid is not None and not dec.renumbered:
        return grid_exchange(dec.grid, x)
    if dec.renumbered:
        # slots past a subdomain's interface count hold interior values
        # with no partners: they pass through unchanged
        m = dec.m_max
        return torch.cat([_interface_reduce(dec, x[:, :m]), x[:, m:]], dim=1)
    if dec.pexch is not None and x.is_cuda:
        return pexchange(dec.pexch, x.contiguous())
    mu = x.shape[-1]
    idx = dec.if_idx[:, :, None].expand(-1, -1, mu)
    vals = torch.gather(x, 1, idx)
    vals = torch.where(dec.if_mask[:, :, None], vals, vals.new_zeros(()))
    summed = _interface_reduce(dec, vals)
    return _scatter_rows(dec, x, summed)


def scaled_exchange(dec: Decomposition, x: torch.Tensor) -> torch.Tensor:
    """``Schwarz::exchange``: multiply by the POU then sum-reduce. For a
    consistent input this is the identity (sum_q R_q^T D_q R_q = I)."""
    return exchange(dec, dec.d[:, :, None] * x)


def weighted_dot(dec: Decomposition, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """POU-weighted global dot per RHS: sum_s sum_i d[s,i] conj(x) y -> (mu,)."""
    return torch.sum(dec.d[:, :, None] * x.conj() * y, dim=(0, 1))


def weighted_norm_sq(dec: Decomposition, x: torch.Tensor) -> torch.Tensor:
    """POU-weighted squared norm per RHS -> (mu,) real."""
    return torch.sum(dec.d[:, :, None] * x.abs() ** 2, dim=(0, 1))


def weighted_gram(dec: Decomposition, V: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Weighted dots against a basis: V (k, S, n, mu), y (S, n, mu) ->
    (k, mu). The CGS single-reduction Gram vector
    (HPDDM_iterative.hpp:489-522)."""
    return torch.einsum("ksnm,snm->km", V.conj(), dec.d[:, :, None] * y)
