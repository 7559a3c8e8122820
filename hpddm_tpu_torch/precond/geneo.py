"""GenEO spectral coarse spaces (counterpart of ``hpddm_tpu/precond/geneo.py``).

* ``scale_into_overlap``: B = D A D restricted to the geometric overlap
  (``Schwarz::scaleIntoOverlap``, HPDDM_schwarz.hpp:622-657),
* ``solve_gevp_dense``: the local pencil A_neu v = lambda B v, smallest
  lambdas, by two dense symmetric eigensolves on the device (the
  reference uses shift-invert ARPACK, HPDDM_ARPACK.hpp:84-151),
* ``solve_gevp_lanczos``: the same pencil matrix-free, by shift-invert
  Lanczos batched over the subdomains, for subdomains where two dense
  eigensolves are too slow or too large,
* ``select_nu``: threshold cut and ``geneo_force_uniformity``
  (``Eigensolver::selectNu``, HPDDM_eigensolver.hpp:106-159).

The deflation operator Z E^-1 Z^T is invariant under per-subdomain
invertible column transforms of Z, so eigenvector signs and bases within a
degenerate eigenspace do not matter.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hpddm_tpu_torch.core.formats import batched_dense_from
from hpddm_tpu_torch.device import DEFAULT, as_device, synchronize
from hpddm_tpu_torch.dtypes import as_torch_dtype, is_low_precision
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


def solve_gevp_lanczos(apply_Ainv: Callable, apply_B: Callable, S: int,
                       n: int, nu_max: int, ncv: Optional[int] = None,
                       seed: int = 0, dtype=torch.float64, device=DEFAULT,
                       timings: Optional[Dict[str, float]] = None):
    """Shift-invert Lanczos for the pencil A v = lambda B v at sigma = 0,
    batched over subdomains: the matrix-free analogue of the reference's
    ARPACK mode-3 loop (HPDDM_ARPACK.hpp:84-151), and the port of the JAX
    package's ``solve_gevp_lanczos`` (``hpddm_tpu/precond/geneo.py:123``).

    apply_Ainv(x): (S, n, 1) -> A^-1 x (exact or inner-Krylov);
    apply_B(x):    (S, n, 1) -> B x (the overlap-masked D A D).

    B-orthonormal Lanczos with full reorthogonalization (twice a step,
    against the stored B v columns) on the operator A^-1 B, ncv steps
    (default max(2 nu_max + 1, 12), at most n) on preallocated (S, n, ncv)
    bases; the largest Ritz values theta give the smallest pencil
    eigenvalues lambda = 1/theta. The start is
    ``np.random.default_rng(seed).normal(size=(S, n, 1))``, as in the JAX
    package, purged once into range(A^-1 B). The projected matrix
    T = V^T B A^-1 B V is built on ``device``, symmetrized, and solved per
    subdomain by ``np.linalg.eigh`` on the host. No host read happens
    inside the steps.

    timings: when given, receives the seconds of the steps
    ("lanczos_steps") and of the projected eigenproblem with the Ritz
    vectors ("lanczos_eig"), each ending in a device synchronization.
    Returns (lam (S, nu_max) ascending, V (S, n, nu_max)) in dtype.
    """
    device = as_device(device)
    dtype = as_torch_dtype(dtype)
    if ncv is None:
        ncv = max(2 * nu_max + 1, 12)
    ncv = min(ncv, n)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.normal(size=(S, n, 1)), device=device).to(dtype)

    def b_norm(w):
        return torch.sqrt(torch.abs(torch.sum(w * apply_B(w), dim=(1, 2))))

    # purge the raw start into range(A^-1 B): the operators mask padded
    # rows and kernel directions, so one application removes the noise the
    # raw vector carries there, which full reorthogonalization would
    # otherwise carry into every basis column
    v = apply_Ainv(apply_B(v))
    v = v / torch.clamp(b_norm(v), min=1e-30)[:, None, None]
    V = torch.zeros((S, n, ncv), dtype=dtype, device=device)
    BV = torch.zeros_like(V)
    OpV = torch.zeros_like(V)
    for j in range(ncv):
        Bv = apply_B(v)
        w = apply_Ainv(Bv)                                  # Op v_j
        V[:, :, j] = v[:, :, 0]
        BV[:, :, j] = Bv[:, :, 0]
        OpV[:, :, j] = w[:, :, 0]
        # full B-reorthogonalization (twice) against columns 0..j; the
        # columns not yet filled are zero and contribute nothing
        for _ in range(2):
            c = torch.bmm(BV.transpose(1, 2), w)            # (S, ncv, 1)
            w = w - torch.bmm(V, c)
        v = w / torch.clamp(b_norm(w), min=1e-30)[:, None, None]
    if timings is not None:
        synchronize(device)
        timings["lanczos_steps"] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # the projected problem T = V^T B Op V, symmetric in the B-inner
    # product; built densely from the basis (full reorthogonalization makes
    # the tridiagonal form fragile)
    T = torch.bmm(BV.transpose(1, 2), OpV)
    T = 0.5 * (T + T.transpose(1, 2))
    T_np = T.cpu().numpy()
    lam_out = np.full((S, nu_max), np.inf)
    Y_out = np.zeros((S, ncv, nu_max))
    for s in range(S):
        w_s, y_s = np.linalg.eigh(T_np[s])
        order = np.argsort(-w_s)[:nu_max]
        theta = w_s[order]
        good = theta > 1e-12
        lam_out[s, : len(order)] = np.where(good, 1.0 / np.where(
            good, theta, 1.0), np.inf)
        Y_out[s, :, : len(order)] = y_s[:, order]
    Vec = torch.bmm(V, torch.as_tensor(Y_out, device=device).to(dtype))
    nrm = torch.linalg.norm(Vec, dim=1, keepdim=True)
    Vec = Vec / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    if timings is not None:
        synchronize(device)
        timings["lanczos_eig"] = time.perf_counter() - t0
    return torch.as_tensor(lam_out, device=device).to(dtype), Vec


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
