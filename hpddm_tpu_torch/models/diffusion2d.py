"""2D diffusion test problem (counterpart of ``hpddm_tpu/models/diffusion2d.py``).

``generate``, ``generate_single`` and ``generate_uniform``, kept
bit-faithful to the JAX package so that both packages see byte-equal
problems: a 5-point finite-difference diffusion operator on an Nx x Ny grid of [0,10]^2, decomposed into an xGrid x yGrid
process grid of overlapping subdomains with the reference's partition of
unity, neighbor lists and elementwise-aligned mapping lists
(examples/generate.cpp:43-311 of the reference).

Quirks kept on purpose (iteration-count parity with the in-tree oracles
depends on them):

* the vertical stencil offset is ``Nx // xGrid`` even when the local row
  width ``iEnd - iStart`` differs because of overlap clamping, which makes
  some local matrices nonsymmetric (generate.cpp:201),
* the Neumann matrices used by GenEO get the reference's boundary
  adjustments (generate.cpp:249-301),
* the right-hand side is the three-bump closed form (generate.cpp:72-88).

Returns host-side numpy/MatrixCSR data; ``precond.schwarz.Schwarz`` moves
it onto the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from hpddm_tpu_torch.core.csr import MatrixCSR

PI = 3.141592653589793238463


@dataclasses.dataclass
class Generated:
    """Per-subdomain host data for a decomposed problem."""
    mats: List[MatrixCSR]                  # local matrices
    neumann: Optional[List[MatrixCSR]]     # local Neumann matrices (or None)
    neighbors: List[List[int]]             # neighbor subdomain ids
    mappings: List[List[np.ndarray]]       # aligned shared-dof lists
    d: List[np.ndarray]                    # partition of unity
    f: List[np.ndarray]                    # right-hand side(s), (ndof, mu)
    n_loc: List[int]
    grid: tuple                            # (xGrid, yGrid, Nx, Ny, overlap)
    boxes: List[tuple]                     # (iStart, iEnd, jStart, jEnd)


def _grid_of(size_world: int) -> tuple:
    x_grid = int(np.sqrt(size_world))
    while size_world % x_grid != 0:
        x_grid -= 1
    return x_grid, size_world // x_grid


def padded_rhs(f_list, n_max: int, dtype=np.float64) -> np.ndarray:
    """The per-subdomain right-hand sides ``f_list`` (n_loc[s] rows of mu
    columns, or vectors for mu=1) as one (S, n_max, mu) array, zero in the
    pad rows."""
    mu = np.reshape(f_list[0], (len(f_list[0]), -1)).shape[1]
    f = np.zeros((len(f_list), n_max, mu), dtype=dtype)
    for s, fs in enumerate(f_list):
        f[s, : len(fs)] = np.reshape(fs, (len(fs), mu))
    return f


def rhs_values(ii: np.ndarray, jj: np.ndarray, Nx: int, Ny: int) -> np.ndarray:
    """Closed-form RHS (generate.cpp:72-88) at grid indices (ii, jj)."""
    dx, dy = 10.0 / Nx, 10.0 / Ny
    xx = dx * (ii + 0.5)
    yy = dy * (jj + 0.5)
    frs = np.ones_like(xx, dtype=np.float64)
    for xsc, ysc, rsc, asc in ((6.5, 8.0, 0.3, 0.3),
                               (2.0, 7.0, 0.3, 0.2),
                               (7.0, 3.0, 0.4, -0.1)):
        xdist, ydist = xx - xsc, yy - ysc
        inside = np.sqrt(xdist ** 2 + ydist ** 2) <= rsc
        contrib = asc * np.cos(0.5 * PI * xdist / rsc) * np.cos(0.5 * PI * ydist / rsc)
        frs = frs - np.where(inside, contrib, 0.0)
    return frs


def generate(size_world: int, Nx: int = 100, Ny: int = 100, overlap: int = 1,
             sym: bool = False, mu: int = 0, with_neumann: bool = False,
             rng: Optional[np.random.Generator] = None,
             dtype=np.float64) -> Generated:
    """Generate the decomposed 2D diffusion problem for `size_world` subdomains.

    mu = 0: single closed-form RHS (returned as (ndof, 1));
    mu > 0: mu random RHS (generate_random_rhs).
    """
    x_grid, y_grid = _grid_of(size_world)
    dx, dy = 10.0 / Nx, 10.0 / Ny
    idy2, idx2 = 1.0 / (dy * dy), 1.0 / (dx * dx)
    if rng is None:
        rng = np.random.default_rng(0)

    out = Generated([], [] if with_neumann else None, [], [], [], [], [],
                    (x_grid, y_grid, Nx, Ny, overlap), [])

    for rank in range(size_world):
        y, x = divmod(rank, x_grid)
        i_start = max(x * (Nx // x_grid) - overlap, 0)
        i_end = min((x + 1) * (Nx // x_grid) + overlap, Nx)
        j_start = max(y * (Ny // y_grid) - overlap, 0)
        j_end = min((y + 1) * (Ny // y_grid) + overlap, Ny)
        wx, wy = i_end - i_start, j_end - j_start
        ndof = wx * wy
        out.boxes.append((i_start, i_end, j_start, j_end))
        out.n_loc.append(ndof)

        # -- RHS ---------------------------------------------------------
        if mu == 0:
            jj, ii = np.meshgrid(np.arange(j_start, j_end),
                                 np.arange(i_start, i_end), indexing="ij")
            f = rhs_values(ii, jj, Nx, Ny).reshape(ndof, 1).astype(dtype)
        else:
            f = rng.uniform(0.0, 1.0, size=(ndof, mu)).astype(dtype)
        out.f.append(f)

        # -- partition of unity & neighbor lists --------------------------
        d = np.ones(ndof, dtype=np.float64)
        o: List[int] = []
        maps: List[np.ndarray] = []
        ov = overlap

        def block(rows, cols):
            """Local indices for (local-row, local-col) index arrays, row-major."""
            r, c = np.meshgrid(rows, cols, indexing="ij")
            return (c + wx * r).ravel()

        if j_start != 0:
            if i_start != 0:
                o.append(rank - x_grid - 1)
                maps.append(block(np.arange(2 * ov), np.arange(2 * ov)))
                for j in range(ov):
                    for i in range(ov - j):
                        d[i + j + j * wx] = j / ov
                    for i in range(j):
                        d[i + j * wx] = i / ov
            else:
                for j in range(ov):
                    d[j * wx: j * wx + ov] = j / ov
            o.append(rank - x_grid)
            maps.append(block(np.arange(2 * ov), np.arange(wx)))
            for j in range(ov):
                d[ov + j * wx: wx - ov + j * wx] = j / ov
            if i_end != Nx:
                o.append(rank - x_grid + 1)
                # bottom-right corner: enumerated row-outer like the reference
                idx = np.array([wx * (i + 1) - 2 * ov + j
                                for i in range(2 * ov) for j in range(2 * ov)])
                maps.append(idx)
                for j in range(ov):
                    for i in range(ov - j):
                        d[wx * (j + 1) - ov + i] = j / ov
                    for i in range(j):
                        d[wx * (j + 1) - i - 1] = i / ov
            else:
                for j in range(ov):
                    d[wx * (j + 1) - ov: wx * (j + 1)] = j / ov
        if i_start != 0:
            o.append(rank - 1)
            maps.append(block(np.arange(wy), np.arange(2 * ov)))
            for i in range(j_start + (j_start != 0) * ov,
                           j_end - (j_end != Ny) * ov):
                for j in range(ov):
                    d[j + (i - j_start) * wx] = j / ov
        if i_end != Nx:
            o.append(rank + 1)
            maps.append(block(np.arange(wy), np.arange(wx - 2 * ov, wx)))
            for i in range(j_start + (j_start != 0) * ov,
                           j_end - (j_end != Ny) * ov):
                for j in range(ov):
                    d[wx * (i + 1 - j_start) - j - 1] = j / ov
        if j_end != Ny:
            base = ndof - 2 * ov * wx
            top = ndof - ov * wx
            if i_start != 0:
                o.append(rank + x_grid - 1)
                maps.append(base + block(np.arange(2 * ov), np.arange(2 * ov)))
                for j in range(ov):
                    for i in range(ov - j):
                        d[top + i + wx * j] = i / ov
                    for i in range(ov - j, ov):
                        d[top + i + wx * j] = (ov - 1 - j) / ov
            else:
                for j in range(ov):
                    d[top + wx * j: top + wx * j + ov] = (ov - j - 1) / ov
            o.append(rank + x_grid)
            maps.append(base + block(np.arange(2 * ov), np.arange(wx)))
            for j in range(ov):
                d[top + ov + wx * j: top + wx - ov + wx * j] = (ov - 1 - j) / ov
            if i_end != Nx:
                o.append(rank + x_grid + 1)
                maps.append(base + (wx - 2 * ov)
                            + block(np.arange(2 * ov), np.arange(2 * ov)))
                for j in range(ov):
                    for i in range(j, ov):
                        d[top + i + wx * (j + 1) - ov] = (ov - 1 - i) / ov
                    for i in range(j):
                        d[top + i + wx * (j + 1) - ov] = (ov - 1 - j) / ov
            else:
                for j in range(ov):
                    d[top + wx * (j + 1) - ov: top + wx * (j + 1)] = (ov - j - 1) / ov
        out.neighbors.append(o)
        out.mappings.append(maps)
        out.d.append(d)

        # -- matrix --------------------------------------------------------
        voff = Nx // x_grid  # reference quirk: vertical offset, not wx
        jj, ii = np.meshgrid(np.arange(j_start, j_end),
                             np.arange(i_start, i_end), indexing="ij")
        jj, ii = jj.ravel(), ii.ravel()
        k = np.arange(ndof)
        diag_val = 2.0 * idx2 + 2.0 * idy2

        rows, cols, vals = [], [], []

        def add(mask, col, val):
            rows.append(k[mask])
            cols.append(col[mask])
            vals.append(np.full(mask.sum(), val))

        add(jj > j_start, k - voff, -idy2)
        add(ii > i_start, k - 1, -idx2)
        add(np.ones(ndof, dtype=bool), k, diag_val)
        if not sym:
            add(ii < i_end - 1, k + 1, -idx2)
            add(jj < j_end - 1, k + voff, -idy2)
        rows_c = np.concatenate(rows)
        cols_c = np.concatenate(cols)
        vals_c = np.concatenate(vals).astype(dtype)
        # guard the quirky vertical offset against out-of-range columns
        keep = (cols_c >= 0) & (cols_c < ndof)
        mat = MatrixCSR.from_coo(ndof, ndof, rows_c[keep], cols_c[keep],
                                 vals_c[keep], sym=sym)
        out.mats.append(mat)

        # -- Neumann matrix (GenEO) ---------------------------------------
        if with_neumann:
            nrows, ncols, nvals = [], [], []

            def addn(mask, col, val):
                nrows.append(k[mask])
                ncols.append(col[mask])
                nvals.append(val[mask] if isinstance(val, np.ndarray)
                             else np.full(mask.sum(), val))

            # generate.cpp:249-301 (non-sym variant, applied for both since we
            # expand symmetric storage anyway)
            v_down = np.where(ii == i_start, -idy2 - idx2, -idy2)
            v_left = np.where(jj == j_start, -idx2 - idy2, -idx2)
            v_right = np.where(jj == j_end - 1, -idx2 - idy2, -idx2)
            v_up = np.where(ii == i_end - 1, -idy2 - idx2, -idy2)
            addn(jj > j_start, k - voff, v_down)
            addn(ii > i_start, k - 1, v_left)
            addn(np.ones(ndof, dtype=bool), k, diag_val)
            addn(ii < i_end - 1, k + 1, v_right)
            addn(jj < j_end - 1, k + voff, v_up)
            nrows_c = np.concatenate(nrows)
            ncols_c = np.concatenate(ncols)
            nvals_c = np.concatenate(nvals).astype(dtype)
            keep = (ncols_c >= 0) & (ncols_c < ndof)
            out.neumann.append(MatrixCSR.from_coo(
                ndof, ndof, nrows_c[keep], ncols_c[keep], nvals_c[keep]))

    return out


def generate_single(Nx: int = 100, Ny: int = 100, sym: bool = False,
                    mu: int = 0, dtype=np.float64) -> Generated:
    """Single-domain problem (the sizeWorld == 1 path of schwarz.cpp)."""
    return generate(1, Nx, Ny, overlap=1, sym=sym, mu=mu, dtype=dtype)


def generate_uniform(size_world: int, Nx: int = 100, Ny: int = 100,
                     overlap: int = 1, mu: int = 0,
                     rng: Optional[np.random.Generator] = None,
                     kappa=None, with_neumann: bool = False,
                     dtype=np.float64) -> Generated:
    """Uniform-box variant of :func:`generate`: the problem of the
    structured-grid slab exchange (``parallel/grid.py``) and of banded
    local solves on grid boxes.

    Boxes at the domain edge are extended *inward* instead of clipped, so
    every subdomain is exactly (w + 2*overlap) per side — uniform static
    shapes, reshapeable to the (H, W) canvas the slab exchange needs.
    Edge pairs then share 3*overlap cells instead of 2*overlap, which the
    corner-loop POU of the reference cannot express; the partition of
    unity here is the exact-GMV one (zero on the incomplete-stencil outer
    layer, then the multiplicityScaling fixed point applied by
    Decomposition.from_subdomains' "normalized" scaling). Same stencil,
    RHS, and global operator as `generate`; the local vertical offset is
    the true row width (no Nx//xGrid quirk — this decomposition is not
    bit-matched to the reference).

    kappa: optional ``kappa(xx, yy) -> array`` scalar diffusion coefficient
    on [0,10]^2 (cell centers). Face coefficients are harmonic means, so
    the operator is the standard heterogeneous 5-point FV stencil;
    kappa=None reproduces the constant-coefficient operator exactly.

    with_neumann: also assemble the local *Neumann* matrices for GenEO
    (the PCHPDDMSetAuxiliaryMat requirement: the SPSD local energy —
    faces crossing the artificial subdomain boundary contribute nothing
    to the diagonal, faces on the true domain boundary keep their
    Dirichlet contribution; cf. examples/generate.cpp:249-301)."""
    x_grid, y_grid = _grid_of(size_world)
    if Nx % x_grid or Ny % y_grid:
        raise ValueError("generate_uniform needs Nx % xGrid == 0 and "
                         "Ny % yGrid == 0")
    wsub_x, wsub_y = Nx // x_grid, Ny // y_grid
    Wb, Hb = wsub_x + 2 * overlap, wsub_y + 2 * overlap
    if x_grid > 1 and wsub_x < 3 * overlap:
        raise ValueError("subdomains too small for the inward extension")
    dx, dy = 10.0 / Nx, 10.0 / Ny
    idy2, idx2 = 1.0 / (dy * dy), 1.0 / (dx * dx)
    if rng is None:
        rng = np.random.default_rng(0)

    out = Generated([], [] if with_neumann else None, [], [], [], [], [],
                    (x_grid, y_grid, Nx, Ny, overlap), [])

    def origin(c, w, n, width, grid_n):
        if grid_n == 1:
            return 0
        return min(max(c * w - overlap, 0), n - width)

    for rank in range(size_world):
        y, x = divmod(rank, x_grid)
        i_start = origin(x, wsub_x, Nx, Wb, x_grid)
        j_start = origin(y, wsub_y, Ny, Hb, y_grid)
        wx = Wb if x_grid > 1 else Nx
        wy = Hb if y_grid > 1 else Ny
        i_end, j_end = i_start + wx, j_start + wy
        ndof = wx * wy
        out.boxes.append((i_start, i_end, j_start, j_end))
        out.n_loc.append(ndof)

        if mu == 0:
            jj, ii = np.meshgrid(np.arange(j_start, j_end),
                                 np.arange(i_start, i_end), indexing="ij")
            f = rhs_values(ii, jj, Nx, Ny).reshape(ndof, 1).astype(dtype)
        else:
            f = rng.uniform(0.0, 1.0, size=(ndof, mu)).astype(dtype)
        out.f.append(f)

        # POU seed: zero on the incomplete-stencil outer layer (box edges
        # interior to the domain), one elsewhere; "normalized" scaling
        # turns this into an exact partition of unity.
        d = np.ones((wy, wx))
        if j_start > 0:
            d[0, :] = 0.0
        if j_end < Ny:
            d[-1, :] = 0.0
        if i_start > 0:
            d[:, 0] = 0.0
        if i_end < Nx:
            d[:, -1] = 0.0
        out.d.append(d.ravel())

        # neighbors + aligned mappings from global rectangle intersections
        o, maps = [], []
        for q in range(size_world):
            if q == rank:
                continue
            qy, qx = divmod(q, x_grid)
            if abs(qy - y) > 1 or abs(qx - x) > 1:
                continue
            qi0 = origin(qx, wsub_x, Nx, Wb, x_grid)
            qj0 = origin(qy, wsub_y, Ny, Hb, y_grid)
            a0, a1 = max(i_start, qi0), min(i_end, qi0 + wx)
            b0, b1 = max(j_start, qj0), min(j_end, qj0 + wy)
            if a1 <= a0 or b1 <= b0:
                continue
            gj, gi = np.meshgrid(np.arange(b0, b1), np.arange(a0, a1),
                                 indexing="ij")
            loc = ((gj - j_start) * wx + (gi - i_start)).ravel()
            o.append(q)
            maps.append(loc)
        out.neighbors.append(o)
        out.mappings.append(maps)

        # local matrix: true 5-point stencil of the box (voff = wx)
        jj, ii = np.meshgrid(np.arange(j_start, j_end),
                             np.arange(i_start, i_end), indexing="ij")
        jj, ii = jj.ravel(), ii.ravel()
        k = np.arange(ndof)
        rows, cols, vals = [], [], []

        def add(mask, col, val):
            rows.append(k[mask])
            cols.append(col[mask])
            vals.append(val[mask] if isinstance(val, np.ndarray)
                        else np.full(int(mask.sum()), val))

        if kappa is None:
            kw = ks = ke = kn = np.ones(ndof)
        else:
            # harmonic-mean face coefficients from cell-center kappa; at
            # the global boundary the face takes the cell's own value
            def kc(i, j):
                return np.asarray(kappa(dx * (np.clip(i, 0, Nx - 1) + 0.5),
                                        dy * (np.clip(j, 0, Ny - 1) + 0.5)),
                                  dtype=np.float64)
            c = kc(ii, jj)
            def face(other):
                return 2.0 * c * other / (c + other)
            kw = np.where(ii > 0, face(kc(ii - 1, jj)), c)
            ke = np.where(ii < Nx - 1, face(kc(ii + 1, jj)), c)
            ks = np.where(jj > 0, face(kc(ii, jj - 1)), c)
            kn = np.where(jj < Ny - 1, face(kc(ii, jj + 1)), c)
        diag_val = (kw + ke) * idx2 + (ks + kn) * idy2
        add(jj > j_start, k - wx, -ks * idy2)
        add(ii > i_start, k - 1, -kw * idx2)
        add(np.ones(ndof, dtype=bool), k, diag_val)
        add(ii < i_end - 1, k + 1, -ke * idx2)
        add(jj < j_end - 1, k + wx, -kn * idy2)
        mat = MatrixCSR.from_coo(ndof, ndof, np.concatenate(rows),
                                 np.concatenate(cols),
                                 np.concatenate(vals).astype(dtype))
        out.mats.append(mat)

        if with_neumann:
            # SPSD local energy: a face contributes to the diagonal only
            # when it is interior to the box or lies on the true domain
            # boundary (Dirichlet); faces crossing the artificial boundary
            # contribute nothing (free/Neumann)
            dW = np.where((ii > i_start) | (ii == 0), kw, 0.0)
            dE = np.where((ii < i_end - 1) | (ii == Nx - 1), ke, 0.0)
            dS = np.where((jj > j_start) | (jj == 0), ks, 0.0)
            dN = np.where((jj < j_end - 1) | (jj == Ny - 1), kn, 0.0)
            diag_neu = (dW + dE) * idx2 + (dS + dN) * idy2
            nrows, ncols, nvals = [], [], []

            def addn(mask, col, val):
                nrows.append(k[mask])
                ncols.append(col[mask])
                nvals.append(val[mask] if isinstance(val, np.ndarray)
                             else np.full(int(mask.sum()), val))

            addn(jj > j_start, k - wx, -ks * idy2)
            addn(ii > i_start, k - 1, -kw * idx2)
            addn(np.ones(ndof, dtype=bool), k, diag_neu)
            addn(ii < i_end - 1, k + 1, -ke * idx2)
            addn(jj < j_end - 1, k + wx, -kn * idy2)
            out.neumann.append(MatrixCSR.from_coo(
                ndof, ndof, np.concatenate(nrows), np.concatenate(ncols),
                np.concatenate(nvals).astype(dtype)))

    return out
