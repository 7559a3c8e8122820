"""GenEO spectral coarse spaces, dense part (counterpart of ``hpddm_tpu/precond/geneo.py``).

* ``scale_into_overlap``: B = D A D restricted to the geometric overlap
  (``Schwarz::scaleIntoOverlap``, HPDDM_schwarz.hpp:622-657),
* ``solve_gevp_dense``: the local pencil A_neu v = lambda B v, smallest
  lambdas, by two dense symmetric eigensolves on the device (the
  reference uses shift-invert ARPACK, HPDDM_ARPACK.hpp:84-151),
* ``select_nu``: threshold cut and ``geneo_force_uniformity``
  (``Eigensolver::selectNu``, HPDDM_eigensolver.hpp:106-159).

The deflation operator Z E^-1 Z^T is invariant under per-subdomain
invertible column transforms of Z, so eigenvector signs and bases within a
degenerate eigenspace do not matter.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hpddm_tpu_torch.core.formats import batched_dense_from
from hpddm_tpu_torch.dtypes import is_low_precision
from hpddm_tpu_torch.parallel.decomposition import Decomposition


def scale_into_overlap(A, dec: Decomposition,
                       sub: slice = slice(None)) -> torch.Tensor:
    """B = (D A D) restricted to overlap rows/cols, dense (S', n, n) for the
    subdomains ``sub``."""
    Ad = batched_dense_from(A, sub)
    dd = dec.d[sub] * dec.ov_mask[sub].to(Ad.dtype)         # zero off-overlap
    return Ad * dd[:, :, None] * dd[:, None, :]


def solve_gevp_dense(A_neu: torch.Tensor, B: torch.Tensor, nu_max: int,
                     reg: float = 1.0e-10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched pencil solve: nu_max smallest-lambda eigenpairs of
    A_neu v = lambda B v with B PSD (possibly singular).

    Both inputs are symmetrized first (the reference's generator assembles
    nonsymmetric local matrices, see models/diffusion2d.py), then

        A^{-1/2} = U diag(1/sqrt(max(w, floor))) U^T      (eigh, no chol)
        C = A^{-1/2} B A^{-1/2};  eigh(C) -> mu descending; lambda = 1/mu

    one subdomain at a time. Below f64 the solve runs in f64 on the same
    device and the results are rounded once (sub-f64 eigensolves lose the
    small pencil eigenvalues GenEO needs; the JAX package goes through host
    f64, ``geneo.py:62-69``).

    Returns (eigenvalues (S, nu_max) ascending, vectors (S, n, nu_max)).
    """
    S, n, _ = A_neu.shape
    out_dtype = A_neu.dtype
    wd = torch.float64 if is_low_precision(out_dtype) else out_dtype
    lam_out = A_neu.new_empty((S, nu_max), dtype=wd)
    V_out = A_neu.new_empty((S, n, nu_max), dtype=wd)
    tiny = torch.finfo(wd).tiny
    eps = torch.finfo(wd).eps
    for s in range(S):
        As, Bs = A_neu[s].to(wd), B[s].to(wd)
        As = 0.5 * (As + As.T)
        Bs = 0.5 * (Bs + Bs.T)
        scale = torch.mean(torch.abs(torch.diagonal(As)))
        w, U = torch.linalg.eigh(As)
        floor = torch.clamp(reg * scale, min=10 * tiny)
        w_safe = torch.maximum(w, floor)
        inv_sqrt = U * (1.0 / torch.sqrt(w_safe))[None, :]
        del U, As
        C = inv_sqrt.T @ Bs @ inv_sqrt
        C = 0.5 * (C + C.T)
        mu, Y = torch.linalg.eigh(C)                              # ascending
        del C
        mu_top = torch.flip(mu, (0,))[:nu_max]                    # largest mu
        Y_top = torch.flip(Y, (1,))[:, :nu_max]
        V = inv_sqrt @ Y_top
        nrm = torch.linalg.norm(V, dim=0, keepdim=True)
        V_out[s] = V / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        lam_out[s] = torch.where(mu_top > 1e3 * eps, 1.0 / mu_top,
                                 torch.full_like(mu_top, float("inf")))
    return lam_out.to(out_dtype), V_out.to(out_dtype)


def select_nu(eigenvalues: np.ndarray, nu_req: np.ndarray,
              threshold: Optional[float] = None,
              force_uniformity: Optional[str] = None,
              rng: Optional[np.random.Generator] = None,
              vectors: Optional[np.ndarray] = None):
    """Per-subdomain count selection (Eigensolver::selectNu), on the host.

    eigenvalues: (S, nu_max) ascending pencil eigenvalues;
    nu_req: (S,) requested counts (geneo_nu, possibly nonuniform).
    With force_uniformity="max", deficient subdomains are padded with
    random vectors drawn from ``rng``, orthonormalized against the computed
    ones (HPDDM_eigensolver.hpp:124-148).
    Returns (nu_loc (S,), vectors possibly padded).
    """
    S, nu_max = eigenvalues.shape
    nu_loc = np.minimum(np.asarray(nu_req, dtype=np.int64), nu_max)
    if threshold is not None and threshold > 0:
        below = (eigenvalues < threshold).sum(axis=1)
        # the reference's upper_bound starts at +1: keep at least one vector
        nu_loc = np.minimum(nu_loc, np.maximum(below, 1))
    if force_uniformity == "min":
        nu_loc[:] = nu_loc.min()
    elif force_uniformity == "max":
        target = int(nu_loc.max())
        if vectors is not None and rng is not None:
            for s in range(S):
                for k in range(int(nu_loc[s]), target):
                    v = rng.uniform(0.0, 1.0, size=vectors.shape[1])
                    basis = vectors[s, :, :k]
                    v = v - basis @ (basis.T @ v)
                    nrm = np.linalg.norm(v)
                    vectors[s, :, k] = v / (nrm if nrm > 0 else 1.0)
        nu_loc[:] = target
    return nu_loc, vectors
