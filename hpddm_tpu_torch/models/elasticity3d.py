"""3D linear elasticity with heterogeneous coefficients (counterpart of
``hpddm_tpu/models/elasticity3d.py``, kept byte-equal to it).

The reference's headline GenEO results (README.md:42-45, Jolivet-Hecht-
Nataf-Prud'homme SC13) are three-dimensional heterogeneous elasticity
runs.  This model assembles isotropic H8 (trilinear hexahedral)
elasticity on an Nx x Ny x Nz node grid (3 dofs per node, clamped at the
x = 0 face) with a 3D checkerboard Young's modulus of given contrast,
then decomposes algebraically (models/fromfile) — the same pipeline an
HPDDM user drives through generateFromFile + METIS.

Everything is vectorized for assembly speed: the element stiffness is
linear in E for fixed Poisson ratio, so a single unit stiffness Ke(E=1)
scaled per element covers the whole heterogeneous mesh.

Also provides the per-subdomain *unassembled Neumann* matrices (element
sums restricted to each subdomain) needed by GenEO, and the 6 rigid-body
modes per subdomain (3 translations + 3 rotations) used by FETI/BDD
coarse spaces.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.models import fromfile


def h8_stiffness(E: float, nu: float, h: float) -> np.ndarray:
    """24x24 isotropic H8 element stiffness (2x2x2 Gauss) on an h-cube."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] = lam + 2.0 * mu
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    # node order: the 8 corners of the cube in (x, y, z) binary order
    corners = np.array([[i, j, kk] for kk in (0, 1) for j in (0, 1)
                        for i in (0, 1)], dtype=np.float64) * 2.0 - 1.0
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    J = h / 2.0
    Ke = np.zeros((24, 24))
    for xi in gp:
        for eta in gp:
            for zeta in gp:
                # dN/dxi_k for the 8 trilinear shape functions
                s = np.array([xi, eta, zeta])
                dN = np.empty((3, 8))
                for a in range(8):
                    c = corners[a]
                    dN[0, a] = 0.125 * c[0] * (1 + c[1] * s[1]) * (1 + c[2] * s[2])
                    dN[1, a] = 0.125 * c[1] * (1 + c[0] * s[0]) * (1 + c[2] * s[2])
                    dN[2, a] = 0.125 * c[2] * (1 + c[0] * s[0]) * (1 + c[1] * s[1])
                dNxy = dN / J
                B = np.zeros((6, 24))
                B[0, 0::3] = dNxy[0]
                B[1, 1::3] = dNxy[1]
                B[2, 2::3] = dNxy[2]
                B[3, 0::3] = dNxy[1]
                B[3, 1::3] = dNxy[0]
                B[4, 1::3] = dNxy[2]
                B[4, 2::3] = dNxy[1]
                B[5, 0::3] = dNxy[2]
                B[5, 2::3] = dNxy[0]
                Ke += B.T @ D @ B * (J ** 3)
    return Ke


def generate(n_subdomains: int, Nx: int = 12, Ny: int = 12, Nz: int = 12,
             contrast: float = 1.0e3, nu: float = 0.3,
             overlap: int = 1, checker: int = 2,
             rng: Optional[np.random.Generator] = None,
             owner_fn=None):
    """Assemble + decompose. Returns (FromFileGenerated, neumann_mats,
    rigid_body_modes); rigid_body_modes[s] is (n_loc[s], 6).

    ``owner_fn(node_x_index) -> subdomain`` overrides the default RCM
    partition with a geometric one (e.g. x-slabs)."""
    if rng is None:
        rng = np.random.default_rng(11)
    h = 1.0 / max(Nx - 1, 1)
    n_nodes = Nx * Ny * Nz
    ndof = 3 * n_nodes

    def nid(i, j, kk):
        return (kk * Ny + j) * Nx + i

    # element -> 24 dof ids, vectorized over the (Nx-1)(Ny-1)(Nz-1) cells
    ii, jj, kk = np.meshgrid(np.arange(Nx - 1), np.arange(Ny - 1),
                             np.arange(Nz - 1), indexing="ij")
    ii, jj, kk = ii.ravel(), jj.ravel(), kk.ravel()
    corner_off = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                  (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    nodes = np.stack([nid(ii + a, jj + b, kk + c)
                      for (a, b, c) in corner_off], axis=1)   # (ne, 8)
    dofs = (3 * nodes[:, :, None]
            + np.arange(3)[None, None, :]).reshape(-1, 24)    # (ne, 24)
    hard = ((ii * checker // max(Nx - 1, 1))
            + (jj * checker // max(Ny - 1, 1))
            + (kk * checker // max(Nz - 1, 1))) % 2 == 0
    E_e = np.where(hard, contrast, 1.0)                       # (ne,)

    Ke1 = h8_stiffness(1.0, nu, h)                            # E-linear
    vals = E_e[:, None, None] * Ke1[None]                     # (ne, 24, 24)
    r = np.repeat(dofs, 24, axis=1).ravel()
    c = np.tile(dofs, (1, 24)).ravel()
    A = sp.coo_matrix((vals.ravel(), (r, c)), shape=(ndof, ndof)).tocsr()

    # clamp the x = 0 face by penalization (HPDDM_PEN analogue)
    node_i = np.arange(n_nodes) % Nx
    clamped = np.zeros(ndof, dtype=bool)
    face = np.nonzero(node_i == 0)[0]
    for comp in range(3):
        clamped[3 * face + comp] = True
    pen = 1.0e8 * abs(A).max()
    A = sp.csr_matrix(A + sp.diags(pen * clamped.astype(np.float64)))

    f_global = np.zeros(ndof)
    f_global[2::3] = -1.0          # downward (z) load
    f_global[clamped] = 0.0

    owner = None
    if owner_fn is not None:
        owner = np.asarray([owner_fn(int(xi)) for xi in node_i]).repeat(3)
    gen = fromfile.decompose(MatrixCSR(A), n_subdomains, overlap=overlap,
                             f_global=f_global, owner=owner)

    # unassembled Neumann matrices: sum of element matrices fully inside
    # each subdomain (GenEO's MatNeumann analogue) — vectorized masks
    neumann = []
    for s in range(n_subdomains):
        in_set = np.zeros(ndof, dtype=bool)
        in_set[gen.gids[s]] = True
        l_of = np.full(ndof, -1, dtype=np.int64)
        l_of[gen.gids[s]] = np.arange(gen.n_loc[s])
        keep = in_set[dofs].all(axis=1)
        n_s = gen.n_loc[s]
        if keep.any():
            ld = l_of[dofs[keep]]                             # (ke, 24)
            vs = E_e[keep][:, None, None] * Ke1[None]
            rl = np.repeat(ld, 24, axis=1).ravel()
            cl = np.tile(ld, (1, 24)).ravel()
            Ns = sp.coo_matrix((vs.ravel(), (rl, cl)),
                               shape=(n_s, n_s)).tocsr()
        else:
            Ns = sp.identity(n_s, format="csr")
        loc_clamped = clamped[gen.gids[s]]
        Ns = sp.csr_matrix(Ns + sp.diags(pen * loc_clamped.astype(float)))
        neumann.append(MatrixCSR(Ns))

    # 6 rigid-body modes per subdomain: translations + rotations about
    # x/y/z through the subdomain's first node
    rbm = []
    for s in range(n_subdomains):
        g = gen.gids[s]
        node = g // 3
        comp = g % 3
        x = (node % Nx) * h
        y = ((node // Nx) % Ny) * h
        z = (node // (Nx * Ny)) * h
        m = np.zeros((gen.n_loc[s], 6))
        for t in range(3):
            m[comp == t, t] = 1.0
        # rot z: (-y, x, 0); rot x: (0, -z, y); rot y: (z, 0, -x)
        m[comp == 0, 3] = -y[comp == 0]
        m[comp == 1, 3] = x[comp == 1]
        m[comp == 1, 4] = -z[comp == 1]
        m[comp == 2, 4] = y[comp == 2]
        m[comp == 0, 5] = z[comp == 0]
        m[comp == 2, 5] = -x[comp == 2]
        rbm.append(m)

    return gen, neumann, rbm
