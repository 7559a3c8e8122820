"""2D MAC Stokes: the saddle-point workload for Schur-complement
preconditioning (counterpart of ``hpddm_tpu/models/stokes2d.py``; host
numpy/scipy, the JAX package's arithmetic, so both packages assemble
byte-equal arrays).

Lid-driven-cavity Stokes on a marker-and-cell (staggered) grid,

    [[A, B^T], [B, 0]] [u; p] = [f; g]

* A: two 5-point Laplacians (u on vertical interior faces, v on
  horizontal interior faces), Dirichlet walls, lid u = 1 on top,
* B: the discrete divergence cell by cell; boundary-face velocities are
  eliminated into g,
* pressure nullspace: the constants (enclosed flow).

The velocity block is decomposed algebraically through the port's
``models/fromfile.decompose``, so every Schwarz feature applies to the
inner solves of ``precond/saddle.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.models import fromfile


def assemble(N: int) -> Tuple[sp.csr_matrix, sp.csr_matrix, np.ndarray,
                              np.ndarray, float]:
    """Assemble (A, B, f, g, h) for the N x N cell lid-driven cavity.

    Unknowns: u on interior vertical faces (N-1 x N, fastest index i),
    v on interior horizontal faces (N x N-1), p in cells (N x N).
    Returns A ((nu+nv) x (nu+nv)), B (N^2 x (nu+nv)), velocity RHS f,
    divergence RHS g (boundary-face fluxes moved right), grid spacing h.
    """
    h = 1.0 / N
    nu_x, nu_y = N - 1, N           # u grid
    nv_x, nv_y = N, N - 1           # v grid
    n_u = nu_x * nu_y
    n_v = nv_x * nv_y
    uid = lambda i, j: j * nu_x + i             # noqa: E731  i in [0,N-2]
    vid = lambda i, j: n_u + j * nv_x + i       # noqa: E731  j in [0,N-2]
    pid = lambda i, j: j * N + i                # noqa: E731

    idh2 = 1.0 / (h * h)
    rows, cols, vals = [], [], []
    f = np.zeros(n_u + n_v)

    def lap(row, nbrs, bc_terms):
        """5-point row: 4/h^2 diagonal, -1/h^2 to neighbors; Dirichlet
        ghosts add their value * 1/h^2 to f (bc_terms)."""
        rows.append(row)
        cols.append(row)
        vals.append(4.0 * idh2)
        for c in nbrs:
            rows.append(row)
            cols.append(c)
            vals.append(-idh2)
        f[row] += idh2 * sum(bc_terms)

    u_lid = 1.0
    for j in range(nu_y):
        for i in range(nu_x):
            r = uid(i, j)
            nbrs, bc = [], []
            nbrs.append(uid(i - 1, j)) if i > 0 else bc.append(0.0)
            nbrs.append(uid(i + 1, j)) if i < nu_x - 1 else bc.append(0.0)
            # tangential walls: ghost reflection u_ghost = 2*u_wall - u
            if j > 0:
                nbrs.append(uid(i, j - 1))
            else:
                bc.append(0.0)
                rows.append(r); cols.append(r); vals.append(idh2)  # noqa: E702
            if j < nu_y - 1:
                nbrs.append(uid(i, j + 1))
            else:
                bc.append(2.0 * u_lid)
                rows.append(r); cols.append(r); vals.append(idh2)  # noqa: E702
            lap(r, nbrs, bc)
    for j in range(nv_y):
        for i in range(nv_x):
            r = vid(i, j)
            nbrs, bc = [], []
            if i > 0:
                nbrs.append(vid(i - 1, j))
            else:
                bc.append(0.0)
                rows.append(r); cols.append(r); vals.append(idh2)  # noqa: E702
            if i < nv_x - 1:
                nbrs.append(vid(i + 1, j))
            else:
                bc.append(0.0)
                rows.append(r); cols.append(r); vals.append(idh2)  # noqa: E702
            nbrs.append(vid(i, j - 1)) if j > 0 else bc.append(0.0)
            nbrs.append(vid(i, j + 1)) if j < nv_y - 1 else bc.append(0.0)
            lap(r, nbrs, bc)
    n_vel = n_u + n_v
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n_vel, n_vel)).tocsr()

    # divergence B and its boundary contribution g
    br, bc_, bv = [], [], []
    g = np.zeros(N * N)
    ih = 1.0 / h
    for j in range(N):
        for i in range(N):
            r = pid(i, j)
            # u faces at x-edges i and i+1 of cell (i, j)
            if i > 0:
                br.append(r); bc_.append(uid(i - 1, j)); bv.append(-ih)  # noqa: E702
            if i < N - 1:
                br.append(r); bc_.append(uid(i, j)); bv.append(ih)  # noqa: E702
            # v faces at y-edges j and j+1
            if j > 0:
                br.append(r); bc_.append(vid(i, j - 1)); bv.append(-ih)  # noqa: E702
            if j < N - 1:
                br.append(r); bc_.append(vid(i, j)); bv.append(ih)  # noqa: E702
            # boundary faces have zero normal velocity -> no g terms
    B = sp.coo_matrix((bv, (br, bc_)), shape=(N * N, n_vel)).tocsr()
    return A, B, f, g, h


def generate(n_subdomains: int, N: int = 32, overlap: int = 2,
             with_neumann: bool = False):
    """Assemble + decompose the velocity block.

    Returns (gen, B, f, g, h[, neumann]) where gen is the
    FromFileGenerated decomposition of A (drive Schwarz/GenEO on it as
    usual). ``with_neumann`` also builds genuine per-subdomain Neumann
    matrices for GenEO: A is an edge Laplacian (uniform edge weight
    1/h^2 plus boundary diagonal terms), so the unassembled restriction
    is the local block with the *cut-edge* degrees removed from the
    diagonal — SPSD as solve_gevp requires."""
    A, B, f, g, h = assemble(N)
    gen = fromfile.decompose(MatrixCSR(A), n_subdomains, overlap=overlap,
                             f_global=f)
    if not with_neumann:
        return gen, B, f, g, h
    w = 1.0 / (h * h)
    neumann = []
    offdiag_global = np.asarray(-(A - sp.diags(A.diagonal()))
                                .sum(axis=1)).ravel() / w
    for s in range(n_subdomains):
        ids = gen.gids[s]
        blk = sp.csr_matrix(A[ids][:, ids])
        offdiag_inside = np.asarray(-(blk - sp.diags(blk.diagonal()))
                                    .sum(axis=1)).ravel() / w
        cut = offdiag_global[ids] - offdiag_inside
        neumann.append(MatrixCSR(sp.csr_matrix(
            blk - sp.diags(w * cut))))
    return gen, B, f, g, h, neumann
