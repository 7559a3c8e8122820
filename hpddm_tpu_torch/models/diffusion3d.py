"""3D diffusion: 7-point finite-volume stencil decomposed over a 3D grid
of uniform boxes (counterpart of ``hpddm_tpu/models/diffusion3d.py``, kept
byte-equal to it).

The reference's example surface is 2D only (examples/generate.cpp); this
extends the same conventions to 3D — production domain-decomposition
workloads are mostly 3D. Mirrors diffusion2d.generate_uniform:

* uniform boxes, edge boxes extended *inward* (static shapes, so the
  batched subdomain axis stays rectangular),
* exact-GMV partition of unity: the seed is zero on the incomplete-
  stencil outer layer, made exact by Decomposition.from_subdomains'
  "normalized" scaling,
* optional heterogeneous ``kappa(x, y, z)`` with harmonic-mean face
  coefficients,
* optional SPSD local Neumann matrices for GenEO (faces crossing the
  artificial boundary contribute nothing to the diagonal; true-boundary
  faces keep their Dirichlet contribution — the
  PCHPDDMSetAuxiliaryMat requirement, cf. examples/generate.cpp:249-301).

Domain [0, 10]^3, homogeneous Dirichlet on the whole boundary
(eliminated).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from hpddm_tpu_torch.core.csr import MatrixCSR

PI = 3.141592653589793238463


@dataclasses.dataclass
class Generated:
    """Per-subdomain host data for a decomposed 3D problem."""
    mats: List[MatrixCSR]
    neumann: Optional[List[MatrixCSR]]
    neighbors: List[List[int]]
    mappings: List[List[np.ndarray]]
    d: List[np.ndarray]
    f: List[np.ndarray]
    n_loc: List[int]
    grid: tuple                  # (xGrid, yGrid, zGrid, Nx, Ny, Nz, overlap)
    boxes: List[tuple]           # (i0, i1, j0, j1, k0, k1)
    gids: List[np.ndarray]       # local -> global node ids (validation)


def _grid3_of(size_world: int) -> tuple:
    """Near-cubic factorization px*py*pz = S."""
    best = (size_world, 1, 1)
    for pz in range(1, size_world + 1):
        if size_world % pz:
            continue
        rest = size_world // pz
        px = int(np.sqrt(rest))
        while rest % px:
            px -= 1
        py = rest // px
        cand = tuple(sorted((px, py, pz)))
        if max(cand) - min(cand) < max(best) - min(best):
            best = cand
    return best[1], best[2], best[0]  # px, py, pz (middle/large/small mix)


def rhs_values(ii, jj, kk, Nx, Ny, Nz):
    """Smooth 3D source: the 2D bumps of generate.cpp:72-88 extended with
    a spherical support in z."""
    dx, dy, dz = 10.0 / Nx, 10.0 / Ny, 10.0 / Nz
    xx = dx * (ii + 0.5)
    yy = dy * (jj + 0.5)
    zz = dz * (kk + 0.5)
    frs = np.ones_like(xx, dtype=np.float64)
    for xsc, ysc, zsc, rsc, asc in ((6.5, 8.0, 5.0, 0.6, 0.3),
                                    (2.0, 7.0, 3.0, 0.6, 0.2),
                                    (7.0, 3.0, 7.0, 0.8, -0.1)):
        xd, yd, zd = xx - xsc, yy - ysc, zz - zsc
        inside = np.sqrt(xd ** 2 + yd ** 2 + zd ** 2) <= rsc
        contrib = (asc * np.cos(0.5 * PI * xd / rsc)
                   * np.cos(0.5 * PI * yd / rsc)
                   * np.cos(0.5 * PI * zd / rsc))
        frs = frs - np.where(inside, contrib, 0.0)
    return frs


def generate_uniform(size_world: int, Nx: int = 24, Ny: int = 24,
                     Nz: int = 24, overlap: int = 1, mu: int = 0,
                     rng: Optional[np.random.Generator] = None,
                     kappa=None, with_neumann: bool = False,
                     dtype=np.float64) -> Generated:
    x_grid, y_grid, z_grid = _grid3_of(size_world)
    if Nx % x_grid or Ny % y_grid or Nz % z_grid:
        raise ValueError("generate_uniform needs N divisible by the "
                         f"process grid {(x_grid, y_grid, z_grid)}")
    wsx, wsy, wsz = Nx // x_grid, Ny // y_grid, Nz // z_grid
    Wb = wsx + 2 * overlap
    Hb = wsy + 2 * overlap
    Db = wsz + 2 * overlap
    for p, w in ((x_grid, wsx), (y_grid, wsy), (z_grid, wsz)):
        if p > 1 and w < 3 * overlap:
            raise ValueError("subdomains too small for the inward extension")
    dx, dy, dz = 10.0 / Nx, 10.0 / Ny, 10.0 / Nz
    idx2, idy2, idz2 = 1.0 / dx ** 2, 1.0 / dy ** 2, 1.0 / dz ** 2
    if rng is None:
        rng = np.random.default_rng(0)

    out = Generated([], [] if with_neumann else None, [], [], [], [], [],
                    (x_grid, y_grid, z_grid, Nx, Ny, Nz, overlap), [], [])

    def origin(c, w, n, width, grid_n):
        if grid_n == 1:
            return 0
        return min(max(c * w - overlap, 0), n - width)

    def box_of(rank):
        z, rem = divmod(rank, y_grid * x_grid)
        y, x = divmod(rem, x_grid)
        i0 = origin(x, wsx, Nx, Wb, x_grid)
        j0 = origin(y, wsy, Ny, Hb, y_grid)
        k0 = origin(z, wsz, Nz, Db, z_grid)
        wx = Wb if x_grid > 1 else Nx
        wy = Hb if y_grid > 1 else Ny
        wz = Db if z_grid > 1 else Nz
        return (x, y, z), (i0, j0, k0), (wx, wy, wz)

    for rank in range(size_world):
        (x, y, z), (i0, j0, k0), (wx, wy, wz) = box_of(rank)
        i1, j1, k1 = i0 + wx, j0 + wy, k0 + wz
        ndof = wx * wy * wz
        out.boxes.append((i0, i1, j0, j1, k0, k1))
        out.n_loc.append(ndof)

        kk3, jj3, ii3 = np.meshgrid(np.arange(k0, k1), np.arange(j0, j1),
                                    np.arange(i0, i1), indexing="ij")
        ii, jj, zz = ii3.ravel(), jj3.ravel(), kk3.ravel()
        out.gids.append(((zz * Ny + jj) * Nx + ii).astype(np.int64))

        if mu == 0:
            f = rhs_values(ii, jj, zz, Nx, Ny, Nz).reshape(ndof, 1)
            f = f.astype(dtype)
        else:
            f = rng.uniform(0.0, 1.0, size=(ndof, mu)).astype(dtype)
        out.f.append(f)

        d = np.ones((wz, wy, wx))
        if k0 > 0:
            d[0, :, :] = 0.0
        if k1 < Nz:
            d[-1, :, :] = 0.0
        if j0 > 0:
            d[:, 0, :] = 0.0
        if j1 < Ny:
            d[:, -1, :] = 0.0
        if i0 > 0:
            d[:, :, 0] = 0.0
        if i1 < Nx:
            d[:, :, -1] = 0.0
        out.d.append(d.ravel())

        o, maps = [], []
        for q in range(size_world):
            if q == rank:
                continue
            (qx, qy, qz), (qi0, qj0, qk0), (qwx, qwy, qwz) = box_of(q)
            if max(abs(qx - x), abs(qy - y), abs(qz - z)) > 1:
                continue
            a0, a1 = max(i0, qi0), min(i1, qi0 + qwx)
            b0, b1 = max(j0, qj0), min(j1, qj0 + qwy)
            c0, c1 = max(k0, qk0), min(k1, qk0 + qwz)
            if a1 <= a0 or b1 <= b0 or c1 <= c0:
                continue
            gk, gj, gi = np.meshgrid(np.arange(c0, c1), np.arange(b0, b1),
                                     np.arange(a0, a1), indexing="ij")
            loc = (((gk - k0) * wy + (gj - j0)) * wx + (gi - i0)).ravel()
            o.append(q)
            maps.append(loc)
        out.neighbors.append(o)
        out.mappings.append(maps)

        k = np.arange(ndof)
        if kappa is None:
            kW = kE = kS = kN = kD = kU = np.ones(ndof)
        else:
            def kc(i, j, l):
                return np.asarray(
                    kappa(dx * (np.clip(i, 0, Nx - 1) + 0.5),
                          dy * (np.clip(j, 0, Ny - 1) + 0.5),
                          dz * (np.clip(l, 0, Nz - 1) + 0.5)),
                    dtype=np.float64)
            c = kc(ii, jj, zz)

            def face(other):
                return 2.0 * c * other / (c + other)
            kW = np.where(ii > 0, face(kc(ii - 1, jj, zz)), c)
            kE = np.where(ii < Nx - 1, face(kc(ii + 1, jj, zz)), c)
            kS = np.where(jj > 0, face(kc(ii, jj - 1, zz)), c)
            kN = np.where(jj < Ny - 1, face(kc(ii, jj + 1, zz)), c)
            kD = np.where(zz > 0, face(kc(ii, jj, zz - 1)), c)
            kU = np.where(zz < Nz - 1, face(kc(ii, jj, zz + 1)), c)

        rows, cols, vals = [], [], []

        def add(mask, col, val):
            rows.append(k[mask])
            cols.append(col[mask])
            vals.append(val[mask] if isinstance(val, np.ndarray)
                        else np.full(int(mask.sum()), val))

        diag_val = ((kW + kE) * idx2 + (kS + kN) * idy2 + (kD + kU) * idz2)
        add(zz > k0, k - wx * wy, -kD * idz2)
        add(jj > j0, k - wx, -kS * idy2)
        add(ii > i0, k - 1, -kW * idx2)
        add(np.ones(ndof, dtype=bool), k, diag_val)
        add(ii < i1 - 1, k + 1, -kE * idx2)
        add(jj < j1 - 1, k + wx, -kN * idy2)
        add(zz < k1 - 1, k + wx * wy, -kU * idz2)
        out.mats.append(MatrixCSR.from_coo(
            ndof, ndof, np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(dtype)))

        if with_neumann:
            dW = np.where((ii > i0) | (ii == 0), kW, 0.0)
            dE = np.where((ii < i1 - 1) | (ii == Nx - 1), kE, 0.0)
            dS = np.where((jj > j0) | (jj == 0), kS, 0.0)
            dN = np.where((jj < j1 - 1) | (jj == Ny - 1), kN, 0.0)
            dD = np.where((zz > k0) | (zz == 0), kD, 0.0)
            dU = np.where((zz < k1 - 1) | (zz == Nz - 1), kU, 0.0)
            diag_neu = ((dW + dE) * idx2 + (dS + dN) * idy2
                        + (dD + dU) * idz2)
            nrows, ncols, nvals = [], [], []

            def addn(mask, col, val):
                nrows.append(k[mask])
                ncols.append(col[mask])
                nvals.append(val[mask] if isinstance(val, np.ndarray)
                             else np.full(int(mask.sum()), val))

            addn(zz > k0, k - wx * wy, -kD * idz2)
            addn(jj > j0, k - wx, -kS * idy2)
            addn(ii > i0, k - 1, -kW * idx2)
            addn(np.ones(ndof, dtype=bool), k, diag_neu)
            addn(ii < i1 - 1, k + 1, -kE * idx2)
            addn(jj < j1 - 1, k + wx, -kN * idy2)
            addn(zz < k1 - 1, k + wx * wy, -kU * idz2)
            out.neumann.append(MatrixCSR.from_coo(
                ndof, ndof, np.concatenate(nrows), np.concatenate(ncols),
                np.concatenate(nvals).astype(dtype)))

    return out


def assemble_global(Nx: int, Ny: int, Nz: int, kappa=None,
                    dtype=np.float64):
    """Assembled global 7-point operator + RHS (validation)."""
    import scipy.sparse as sp
    N = Nx * Ny * Nz
    kk3, jj3, ii3 = np.meshgrid(np.arange(Nz), np.arange(Ny),
                                np.arange(Nx), indexing="ij")
    ii, jj, zz = ii3.ravel(), jj3.ravel(), kk3.ravel()
    dx, dy, dz = 10.0 / Nx, 10.0 / Ny, 10.0 / Nz
    idx2, idy2, idz2 = 1.0 / dx ** 2, 1.0 / dy ** 2, 1.0 / dz ** 2
    if kappa is None:
        kW = kE = kS = kN = kD = kU = np.ones(N)
    else:
        def kc(i, j, l):
            return np.asarray(
                kappa(dx * (np.clip(i, 0, Nx - 1) + 0.5),
                      dy * (np.clip(j, 0, Ny - 1) + 0.5),
                      dz * (np.clip(l, 0, Nz - 1) + 0.5)),
                dtype=np.float64)
        c = kc(ii, jj, zz)

        def face(other):
            return 2.0 * c * other / (c + other)
        kW = np.where(ii > 0, face(kc(ii - 1, jj, zz)), c)
        kE = np.where(ii < Nx - 1, face(kc(ii + 1, jj, zz)), c)
        kS = np.where(jj > 0, face(kc(ii, jj - 1, zz)), c)
        kN = np.where(jj < Ny - 1, face(kc(ii, jj + 1, zz)), c)
        kD = np.where(zz > 0, face(kc(ii, jj, zz - 1)), c)
        kU = np.where(zz < Nz - 1, face(kc(ii, jj, zz + 1)), c)
    g = np.arange(N)
    rows, cols, vals = [], [], []

    def add(mask, col, val):
        rows.append(g[mask])
        cols.append(col[mask])
        vals.append(val[mask])

    diag = (kW + kE) * idx2 + (kS + kN) * idy2 + (kD + kU) * idz2
    add(np.ones(N, bool), g, diag)
    add(ii > 0, g - 1, -kW * idx2)
    add(ii < Nx - 1, g + 1, -kE * idx2)
    add(jj > 0, g - Nx, -kS * idy2)
    add(jj < Ny - 1, g + Nx, -kN * idy2)
    add(zz > 0, g - Nx * Ny, -kD * idz2)
    add(zz < Nz - 1, g + Nx * Ny, -kU * idz2)
    A = sp.coo_matrix((np.concatenate(vals).astype(dtype),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N)).tocsr()
    f = rhs_values(ii, jj, zz, Nx, Ny, Nz).astype(dtype)
    return A, f
