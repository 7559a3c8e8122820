"""Non-overlapping decompositions for substructuring (counterpart of
``hpddm_tpu/models/nonoverlap.py``).

The reference's FETI/BDD layer (include/HPDDM_schur.hpp / _FETI.hpp /
_BDD.hpp) consumes non-overlapping decompositions with duplicated interface
unknowns and local *Neumann* matrices K_s such that A = sum_s R_s^T K_s R_s
(unsigned subdomain assembly). This model is that workload: the 2D 5-point
Dirichlet Laplacian on an Nx x Ny grid, with *edges* (the "elements" of
the grid graph) partitioned into boxes, so the subdomain matrices are exact
element-wise splittings of A.

Each edge (u, v) contributes [[w, -w], [-w, w]]; edges to eliminated
Dirichlet boundary nodes contribute w to the diagonal of their interior
endpoint. Subdomain node sets are the endpoints of their edges; nodes
reached by edges of several subdomains are the interface (duplicated, with
aligned mapping lists sorted by global id, the pairing property
HPDDM_subdomain.hpp relies on).

The output is element-for-element the JAX package's. Two loops of the JAX
package are vectorized: the triplets come from numpy index arithmetic
(every coefficient is 1 or ``contrast``, so each summed entry is exact in
any order), and the neighbour lists come from the global multiplicity
array, one pass over the shared nodes, instead of the intersection of every
pair of node sets (O(S^2) set operations, about a million at S=1024). The
lists come out in the JAX package's order: neighbours ascending, shared
nodes sorted by global id.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sp

from hpddm_tpu_torch.core.csr import MatrixCSR


@dataclasses.dataclass
class NonOverlapGenerated:
    mats: List[MatrixCSR]            # local Neumann matrices K_s
    neighbors: List[List[int]]
    mappings: List[List[np.ndarray]]
    f: List[np.ndarray]              # split RHS: sum_s R_s^T f_s = f_global
    n_loc: List[int]
    gids: List[np.ndarray]           # local -> global node ids (validation)
    A_global: sp.csr_matrix          # assembled global matrix (validation)
    f_global: np.ndarray
    interface_mask: List[np.ndarray]  # bool per local dof
    # banded local mode (-hpddm_substructuring_local banded): row-major
    # local grid shapes and analytic kernels (constants on floating
    # subdomains, None on those pinned by the global Dirichlet boundary)
    grid_shapes: List[tuple] = None
    kernels: List = None
    slot_maps: List = None           # local row -> iy*wx+ix box slot


def _triplets(size_world, Nx, Ny, contrast, checker):
    """(subdomain, row, col, value) of every edge and boundary term, as
    ``generate``'s loop over the nodes adds them."""
    j, i = np.divmod(np.arange(Nx * Ny, dtype=np.int64), Nx)
    x_grid = int(np.sqrt(size_world))
    while size_world % x_grid != 0:
        x_grid -= 1
    y_grid = size_world // x_grid
    box = (np.minimum(j * y_grid // Ny, y_grid - 1) * x_grid
           + np.minimum(i * x_grid // Nx, x_grid - 1))
    if contrast == 1.0:
        w = np.ones(Nx * Ny)
    else:
        hard = ((i * checker // Nx) + (j * checker // Ny)) % 2 == 0
        w = np.where(hard, float(contrast), 1.0)
    u = j * Nx + i
    sub, rows, cols, vals = [], [], [], []

    def edge(m, v):
        a, b, ww, s = u[m], v, w[m], box[m]
        sub.append(np.tile(s, 4))
        rows.append(np.concatenate([a, b, a, b]))
        cols.append(np.concatenate([a, b, b, a]))
        vals.append(np.concatenate([ww, ww, -ww, -ww]))

    def diag(m):
        sub.append(box[m])
        rows.append(u[m])
        cols.append(u[m])
        vals.append(w[m])

    edge(i + 1 < Nx, u[i + 1 < Nx] + 1)
    diag(i + 1 == Nx)
    diag(i == 0)
    edge(j + 1 < Ny, u[j + 1 < Ny] + Nx)
    diag(j + 1 == Ny)
    diag(j == 0)
    return (np.concatenate(sub), np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals))


def _neighbours(size_world, gids, count):
    """Neighbour lists (ascending) and aligned mappings (local indices of
    the shared nodes, sorted by global id) from the multiplicity array."""
    sub = np.concatenate([np.full(len(g), s, dtype=np.int64)
                          for s, g in enumerate(gids)])
    node = np.concatenate(gids)
    loc = np.concatenate([np.arange(len(g), dtype=np.int64) for g in gids])
    keep = count[node] > 1
    sub, node, loc = sub[keep], node[keep], loc[keep]
    order = np.lexsort((sub, node))
    sub, node, loc = sub[order], node[order], loc[order]
    ps, pq, pg, pl = [], [], [], []
    for shift in range(1, int(count.max(initial=1))):
        same = node[:-shift] == node[shift:]
        a, b = np.nonzero(same)[0], np.nonzero(same)[0] + shift
        for x, y in ((a, b), (b, a)):
            ps.append(sub[x])
            pq.append(sub[y])
            pg.append(node[x])
            pl.append(loc[x])
    neighbors = [[] for _ in range(size_world)]
    mappings = [[] for _ in range(size_world)]
    if not ps:
        return neighbors, mappings
    ps, pq, pg, pl = (np.concatenate(v) for v in (ps, pq, pg, pl))
    order = np.lexsort((pg, pq, ps))
    ps, pq, pl = ps[order], pq[order], pl[order]
    starts = np.flatnonzero(np.concatenate(
        [[True], (ps[1:] != ps[:-1]) | (pq[1:] != pq[:-1])]))
    ends = np.concatenate([starts[1:], [len(ps)]])
    for a, b in zip(starts.tolist(), ends.tolist()):
        s = int(ps[a])
        neighbors[s].append(int(pq[a]))
        mappings[s].append(pl[a:b].copy())
    return neighbors, mappings


def generate(size_world: int, Nx: int = 30, Ny: int = 30,
             contrast: float = 1.0, checker: int = 4,
             dtype=np.float64) -> NonOverlapGenerated:
    """Edge-partitioned 2D Dirichlet diffusion over size_world boxes.

    contrast > 1 gives a checkerboard coefficient field (the heterogeneous
    regime GenEO coarse spaces are built for)."""
    N = Nx * Ny
    sub, rows, cols, vals = _triplets(size_world, Nx, Ny, contrast, checker)
    A_global = sp.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsr()

    order = np.argsort(sub, kind="stable")
    bounds = np.searchsorted(sub[order], np.arange(size_world + 1))
    mats, gids, n_loc = [], [], []
    for s in range(size_world):
        sel = order[bounds[s]: bounds[s + 1]]
        r, c = rows[sel], cols[sel]
        nodes = np.unique(r)
        gids.append(nodes)
        n_loc.append(len(nodes))
        K = sp.coo_matrix((vals[sel].astype(dtype),
                           (np.searchsorted(nodes, r),
                            np.searchsorted(nodes, c))),
                          shape=(len(nodes), len(nodes))).tocsr()
        mats.append(MatrixCSR(K))

    count = np.zeros(N, dtype=np.int64)
    for s in range(size_world):
        count[gids[s]] += 1
    neighbors, mappings = _neighbours(size_world, gids, count)

    # split RHS: interface entries divided by multiplicity
    rng = np.random.default_rng(7)
    f_global = np.asarray(rng.normal(size=N), dtype=dtype)
    f = [(f_global[g] / count[g]).astype(dtype) for g in gids]
    interface_mask = [count[g] > 1 for g in gids]

    # banded local mode metadata: local grids are rectangles in row-major
    # order (gids ascending = row-major over the bounding box); kernels are
    # the constants exactly when K_s annihilates them (floating subdomains)
    grid_shapes, kernels, slot_maps = [], [], []
    for s in range(size_world):
        iy, ix = gids[s] // Nx, gids[s] % Nx
        wy = int(iy.max() - iy.min() + 1)
        wx = int(ix.max() - ix.min() + 1)
        grid_shapes.append((wy, wx))
        slot_maps.append((iy - iy.min()) * wx + (ix - ix.min()))
        K = mats[s].scipy(expand=True)
        ones = np.ones(n_loc[s])
        if np.abs(K @ ones).max() <= 1e-10 * np.abs(K.diagonal()).max():
            kernels.append(ones[:, None] / np.sqrt(n_loc[s]))
        else:
            kernels.append(None)

    return NonOverlapGenerated(mats=mats, neighbors=neighbors,
                               mappings=mappings, f=f, n_loc=n_loc,
                               gids=gids, A_global=A_global,
                               f_global=f_global,
                               interface_mask=interface_mask,
                               grid_shapes=grid_shapes, kernels=kernels,
                               slot_maps=slot_maps)
