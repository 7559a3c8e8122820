"""Preconditioned sparse least-squares solves: CGLS with a domain
decomposition preconditioner (counterpart of
``hpddm_tpu/solvers/leastsquares.py``; the reference's least-squares CI
capability, .github/workflows/aldaas2021robust.sh:28-56: KSPLSQR + PCHPDDM
on the normal equations, Al Daas, Jolivet, Scott 2021, "A robust
algebraic domain decomposition preconditioner for sparse normal
equations"):

    min_x ||A x - b||_2,   A sparse m x n (m >= n),

solved by CG on the normal equations N = A^T A, preconditioned by the
one- or two-level overlapping Schwarz preconditioner built algebraically
on N.

* N = A^T A is assembled on the host (scipy) and decomposed by
  ``models/fromfile.decompose`` (k-way partition, overlap growth by powers
  of |N|).
* The GenEO coarse space takes the SPSD splitting of the paper's Section
  3 (``_spsd_splitting``): every row of A goes to each subdomain whose
  column set contains the row's support, weighted by 1/multiplicity, so
  the local Neumann analogues Ntilde_s = A[rows_s, J_s]^T W_s A[rows_s,
  J_s] are SPSD and sum (prolongated) to N exactly.
* The outer CGLS is a CG, so the preconditioner must be symmetric: the
  solver coerces RAS to ASM and the deflated and balanced corrections to
  the additive one, with a notice (the reference falls back from CG to
  GMRES instead, HPDDM_CG.hpp:40-42).
* The CGLS recurrence runs on the host with scipy's products by A and
  A^T, as the JAX package runs it; the Schwarz preconditioner apply runs
  on the solver's device, one apply per iteration, with one copy of the
  vector each way. Convergence is monitored on ||A^T r|| / ||A^T b||, the
  LSQR stopping quantity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.device import DEFAULT, as_device
from hpddm_tpu_torch.options import Options


class LeastSquaresResult(NamedTuple):
    x: np.ndarray            # (n,) solution, global numbering
    iterations: int
    rel_res: float           # ||A^T (b - A x)|| / ||A^T b||


def _spsd_splitting(A: sp.csr_matrix, gids) -> list:
    """Multiplicity-weighted contained-row SPSD splitting of A^T A.

    Row i contributes (1/mult_i) a_i a_i^T to every subdomain whose column
    set contains supp(a_i); mult_i is the number of such subdomains. With
    overlap >= 1 every row is contained somewhere, so the weighted local
    matrices sum (prolongated) exactly to A^T A. Returns the local
    Neumann-analogue matrices, one per subdomain; warns where a row falls
    in no subdomain.
    """
    S = len(gids)
    m, n = A.shape
    member = np.zeros((S, n), dtype=np.int64)
    for s in range(S):
        member[s, gids[s]] = 1
    pattern = A.copy()
    pattern.data = np.ones_like(pattern.data)
    counts = np.asarray(pattern @ member.T)            # (m, S)
    contained = counts == np.diff(A.indptr)[:, None]
    n_dropped = int((~contained.any(axis=1)).sum())
    if n_dropped:
        # a row contained in no subdomain's column set falls out of every
        # Neumann matrix and the identity sum_s R^T Ntilde_s R == N breaks
        # (overlap 0, or duplicates in a non-canonical CSR)
        import warnings
        warnings.warn(
            f"SPSD splitting dropped {n_dropped} row(s) of A contained in "
            "no subdomain; the GenEO pencil no longer sums exactly to A^T A"
            " — increase the overlap", stacklevel=2)
    mult = np.maximum(contained.sum(axis=1), 1)
    w = np.sqrt(1.0 / mult)
    out = []
    for s in range(S):
        rows = np.nonzero(contained[:, s])[0]
        Asub = sp.diags(w[rows]) @ A[rows][:, gids[s]]
        Nt = sp.csr_matrix(Asub.T @ Asub)
        Nt.sum_duplicates()
        out.append(MatrixCSR(Nt))
    return out


class LeastSquaresSolver:
    """Host CGLS around the Schwarz preconditioner apply on ``device``."""

    def __init__(self, A: sp.spmatrix, n_subdomains: int = 4,
                 overlap: int = 2, options: Optional[Options] = None,
                 device=DEFAULT):
        from hpddm_tpu_torch.models import fromfile
        from hpddm_tpu_torch.precond import schwarz as sz

        self.opt = options if options is not None else Options()
        self.device = as_device(device)
        # the fixed CG outer needs a symmetric preconditioner (docstring)
        coerced = []
        if self.opt.val("schwarz_method") in ("ras", "oras"):
            coerced.append("schwarz_method -> asm")
            self.opt["schwarz_method"] = "asm"
        if self.opt.val("schwarz_coarse_correction") in ("deflated",
                                                         "balanced"):
            coerced.append("schwarz_coarse_correction -> additive")
            self.opt["schwarz_coarse_correction"] = "additive"
        if coerced:
            print("[hpddm_tpu] least-squares CGLS needs a symmetric "
                  "preconditioner: " + ", ".join(coerced))
        self.A = sp.csr_matrix(A)
        m, n = self.A.shape
        N = sp.csr_matrix(self.A.T @ self.A)
        N.sum_duplicates()
        gen = fromfile.decompose(MatrixCSR(N), n_subdomains, overlap=overlap)
        self.gen = gen
        self.S = n_subdomains
        self.n = n
        sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=self.opt, device=self.device)
        if self.opt.val("schwarz_coarse_correction") is not None:
            sch.solve_gevp(_spsd_splitting(self.A, gen.gids))
        self.sch = sch
        self.state = sch.build()
        self._own = [np.asarray(gen.owner[gen.gids[s]] == s)
                     for s in range(n_subdomains)]

    # -- global <-> decomposed (consistent-copy) maps ---------------------
    def _to_local(self, x_global: np.ndarray) -> torch.Tensor:
        out = np.zeros((self.S, self.sch.n_max, 1), dtype=x_global.dtype)
        for s in range(self.S):
            out[s, : self.gen.n_loc[s], 0] = x_global[self.gen.gids[s]]
        return torch.as_tensor(out, device=self.device)

    def _to_global(self, x_loc: torch.Tensor) -> np.ndarray:
        x_np = x_loc.cpu().numpy()
        out = np.zeros(self.n, dtype=x_np.dtype)
        for s in range(self.S):
            vals = x_np[s, : self.gen.n_loc[s], 0]
            out[self.gen.gids[s][self._own[s]]] = vals[self._own[s]]
        return out

    def _m_inv(self, s_global: np.ndarray) -> np.ndarray:
        from hpddm_tpu_torch.precond import schwarz as sz

        st = self.state
        v = self._to_local(s_global)
        return self._to_global(st.dec.unpermute(sz.apply(
            st, st.dec.permute(v))))

    # -- preconditioned CGLS ---------------------------------------------
    def solve(self, b: np.ndarray, tol: float = 1.0e-8,
              max_it: int = 500) -> LeastSquaresResult:
        A = self.A
        x = np.zeros(self.n, dtype=b.dtype)
        r = np.asarray(b, dtype=b.dtype).copy()      # data-space residual
        s = A.T @ r                                  # normal-eq residual
        nrm0 = float(np.linalg.norm(s))
        nrm0 = nrm0 if nrm0 > 0 else 1.0
        z = self._m_inv(s)
        p = z.copy()
        gamma = float(s @ z)
        it, rel = 0, 1.0
        while it < max_it:
            q = A @ p
            denom = float(q @ q)
            if denom <= 0.0:
                break
            alpha = gamma / denom
            x += alpha * p
            r -= alpha * q
            s = A.T @ r
            rel = float(np.linalg.norm(s)) / nrm0
            it += 1
            if rel <= tol:
                break
            z = self._m_inv(s)
            gamma_new = float(s @ z)
            p = z + (gamma_new / gamma) * p
            gamma = gamma_new
        return LeastSquaresResult(x=x, iterations=it, rel_res=rel)
