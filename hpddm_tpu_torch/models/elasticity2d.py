"""2D linear elasticity with heterogeneous coefficients (counterpart of
``hpddm_tpu/models/elasticity2d.py``, kept byte-equal to it).

The reference's headline GenEO workloads are heterogeneous elasticity
problems (README.md:42-45 papers; BASELINE config 4: "linear elasticity
with two-level RAS + Block GMRES; heterogeneous coefficients"). This model
assembles plane-stress Q1 elasticity on an Nx x Ny node grid (2 dofs per
node, clamped at x = 0) with a checkerboard Young's modulus of given
contrast, then decomposes algebraically (models/fromfile) — the same
pipeline an HPDDM user drives through generateFromFile + METIS.

Also provides the per-subdomain *unassembled Neumann* matrices (element
sums restricted to each subdomain) needed by GenEO, and rigid-body modes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.models import fromfile


def q1_stiffness(E: float, nu: float, h: float) -> np.ndarray:
    """8x8 plane-stress Q1 element stiffness (2x2 Gauss)."""
    D = E / (1.0 - nu * nu) * np.array([[1.0, nu, 0.0],
                                        [nu, 1.0, 0.0],
                                        [0.0, 0.0, (1.0 - nu) / 2.0]])
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    Ke = np.zeros((8, 8))
    for xi in gp:
        for eta in gp:
            dN = 0.25 * np.array([
                [-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)],
                [-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)]])
            J = h / 2.0
            dNxy = dN / J
            B = np.zeros((3, 8))
            B[0, 0::2] = dNxy[0]
            B[1, 1::2] = dNxy[1]
            B[2, 0::2] = dNxy[1]
            B[2, 1::2] = dNxy[0]
            Ke += B.T @ D @ B * (J * J)
    return Ke


def generate(n_subdomains: int, Nx: int = 40, Ny: int = 40,
             contrast: float = 1.0e3, nu: float = 0.3,
             overlap: int = 1, checker: int = 4,
             rng: Optional[np.random.Generator] = None,
             owner_fn=None, pen_scale: float = 1.0e8):
    """Assemble + decompose. Returns (FromFileGenerated, neumann_mats,
    rigid_body_modes).

    ``owner_fn(node_x_index, node_y_index) -> subdomain`` overrides the
    default RCM partition with a geometric one (boxes/slabs keep the
    local node sets rectangular, enabling -hpddm_local_solver banded
    with dense coupling blocks)."""
    if rng is None:
        rng = np.random.default_rng(11)
    h = 1.0 / max(Nx - 1, 1)
    n_nodes = Nx * Ny
    ndof = 2 * n_nodes
    nid = lambda i, j: j * Nx + i  # noqa: E731

    # vectorized assembly: the element stiffness is E-linear for fixed
    # Poisson ratio, so one unit Ke scales across the heterogeneous mesh
    ii, jj = np.meshgrid(np.arange(Nx - 1), np.arange(Ny - 1),
                         indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    nodes4 = np.stack([nid(ii, jj), nid(ii + 1, jj),
                       nid(ii + 1, jj + 1), nid(ii, jj + 1)], axis=1)
    dofs = (2 * nodes4[:, :, None]
            + np.arange(2)[None, None, :]).reshape(-1, 8)    # (ne, 8)
    hard = ((ii * checker // max(Nx - 1, 1))
            + (jj * checker // max(Ny - 1, 1))) % 2 == 0
    E_e = np.where(hard, contrast, 1.0)
    Ke1 = q1_stiffness(1.0, nu, h)
    vals = E_e[:, None, None] * Ke1[None]
    r = np.repeat(dofs, 8, axis=1).ravel()
    c = np.tile(dofs, (1, 8)).ravel()
    A = sp.coo_matrix((vals.ravel(), (r, c)), shape=(ndof, ndof)).tocsr()

    # clamp x = 0: penalization (the reference's HPDDM_PEN style) or —
    # for f32 hardware, where a 1e8 penalty burns ~8 of the 7 significant
    # digits — proper Dirichlet *elimination* (pen_scale=None)
    clamped = np.zeros(ndof, dtype=bool)
    for j in range(Ny):
        clamped[2 * nid(0, j)] = clamped[2 * nid(0, j) + 1] = True
    f_global = np.zeros(ndof)
    f_global[1::2] = -1.0          # downward load
    f_global[clamped] = 0.0
    eliminate = pen_scale is None
    if eliminate:
        keep_dof = ~clamped
        old_of_new = np.nonzero(keep_dof)[0]
        A = sp.csr_matrix(sp.csr_matrix(A)[old_of_new][:, old_of_new])
        f_global = f_global[keep_dof]
        pen = 0.0
    else:
        pen = pen_scale * abs(A).max()
        A = sp.csr_matrix(A + sp.diags(pen * clamped.astype(np.float64)))
        keep_dof = np.ones(ndof, dtype=bool)
        old_of_new = np.arange(ndof)

    owner = None
    if owner_fn is not None:
        node_i = np.arange(n_nodes) % Nx
        node_j = np.arange(n_nodes) // Nx
        owner = np.asarray([owner_fn(int(xi), int(yj)) for xi, yj
                            in zip(node_i, node_j)]).repeat(2)[keep_dof]
    gen = fromfile.decompose(MatrixCSR(A), n_subdomains, overlap=overlap,
                             f_global=f_global, owner=owner)

    # unassembled Neumann matrices: sum of element matrices whose (kept)
    # dofs all live in the subdomain (GenEO's MatNeumann analogue);
    # eliminated dofs drop their element rows/columns — vectorized
    neumann = []
    for s in range(n_subdomains):
        old_gids = old_of_new[gen.gids[s]]
        in_set = np.zeros(ndof, dtype=bool)
        in_set[old_gids] = True
        l_of = np.full(ndof, -1, dtype=np.int64)
        l_of[old_gids] = np.arange(gen.n_loc[s])
        ok = (in_set[dofs] | ~keep_dof[dofs]).all(axis=1) \
            & in_set[dofs].any(axis=1)
        n_s = gen.n_loc[s]
        if ok.any():
            ld = l_of[dofs[ok]]                             # (ke, 8), -1 out
            vs = E_e[ok][:, None, None] * Ke1[None]
            rl = np.repeat(ld, 8, axis=1).ravel()
            cl = np.tile(ld, (1, 8)).ravel()
            m_ = (rl >= 0) & (cl >= 0)
            Ns = sp.coo_matrix((vs.ravel()[m_], (rl[m_], cl[m_])),
                               shape=(n_s, n_s)).tocsr()
        else:
            Ns = sp.identity(n_s, format="csr")
        if not eliminate:
            # keep the clamping consistent on subdomains with the edge
            loc_clamped = clamped[old_gids]
            Ns = sp.csr_matrix(Ns
                               + sp.diags(pen * loc_clamped.astype(float)))
        neumann.append(MatrixCSR(Ns))

    # rigid-body modes per subdomain (for FETI / coarse spaces)
    rbm = []
    for s in range(n_subdomains):
        g = old_of_new[gen.gids[s]]
        node = g // 2
        comp = g % 2
        x = (node % Nx) * h
        y = (node // Nx) * h
        m = np.zeros((gen.n_loc[s], 3))
        m[comp == 0, 0] = 1.0
        m[comp == 1, 1] = 1.0
        m[comp == 0, 2] = -y[comp == 0]
        m[comp == 1, 2] = x[comp == 1]
        rbm.append(m)

    return gen, neumann, rbm
