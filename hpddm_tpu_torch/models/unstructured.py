"""Unstructured P1 FEM diffusion model (counterpart of ``hpddm_tpu/models/unstructured.py``).

Host numpy/scipy, kept bit-faithful to the JAX package: a jittered
lattice of points, optionally graded toward a corner, Delaunay-
triangulated (scipy) and randomly renumbered, so that no row has a grid
stencil; P1 stiffness assembly with Dirichlet boundary conditions by
symmetric elimination (identity rows and columns, so the matrix stays
SPD); decomposed algebraically by ``models/fromfile.decompose`` (k-way
graph partition or coordinate-quantile boxes), the reference's
schwarzFromFile path (examples/generateFromFile.cpp:63-141).

GenEO needs genuine Neumann local matrices: each is assembled from the
triangles whose three vertices lie in the subdomain's overlapping node
set. Each subdomain's local numbering is then put in reverse Cuthill-McKee
order (``rcm_local``), which bands the local matrices.

Kept as the JAX package has it: ``partition_geometric`` splits on x and y
only, so 3-D parts are columns (ROADMAP queue C, C3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import scipy.sparse as sp

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.models.fromfile import (FromFileGenerated, decompose,
                                             partition_kway, rcm_localize)


@dataclasses.dataclass
class UnstructuredGenerated(FromFileGenerated):
    neumann: Optional[List[MatrixCSR]] = None
    points: Optional[np.ndarray] = None      # (N, 2) vertex coordinates
    triangles: Optional[np.ndarray] = None   # (M, 3) vertex ids
    boundary: Optional[np.ndarray] = None    # (N,) bool physical boundary


def delaunay_mesh(nx: int, ny: int, jitter: float = 0.42,
                  grading: float = 0.0, seed: int = 0, nz: int = 0):
    """Jittered, optionally graded lattice + Delaunay triangulation.

    Returns (points (N, dim), simplices (M, dim+1), boundary (N,) bool);
    dim = 3 when ``nz`` > 0 (tetrahedra).  Border points stay on the
    unit-cube boundary (jittered tangentially) so the Dirichlet boundary
    is well defined.  ``grading`` > 0 compresses the mesh toward the
    origin corner (x -> x**(1+grading)), producing the graded-mesh
    row-length variety of real FEM workloads."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    ns = [nx, ny] + ([nz] if nz else [])
    axes = [np.linspace(0.0, 1.0, n) for n in ns]
    grids = list(np.meshgrid(*axes, indexing="ij"))
    for d, n in enumerate(ns):
        h = 1.0 / (n - 1)
        jd = rng.uniform(-jitter, jitter, size=grids[d].shape) * h
        on_edge = (grids[d] == 0.0) | (grids[d] == 1.0)
        grids[d] = np.clip(grids[d] + np.where(on_edge, 0.0, jd), 0.0, 1.0)
        if grading > 0.0:
            grids[d] = grids[d] ** (1.0 + grading)
    pts = np.stack([g.ravel() for g in grids], axis=1)
    # destroy the lattice numbering entirely
    perm = rng.permutation(len(pts))
    pts = pts[perm]
    tri = Delaunay(pts)
    simplices = np.asarray(tri.simplices, dtype=np.int64)
    # drop degenerate slivers (collinear/coplanar jittered points)
    p = pts[simplices]
    J = np.stack([p[:, e + 1] - p[:, 0] for e in range(pts.shape[1])],
                 axis=2)
    simplices = simplices[np.abs(np.linalg.det(J)) > 1e-12]
    boundary = np.zeros(len(pts), dtype=bool)
    for d in range(pts.shape[1]):
        boundary |= (pts[:, d] == 0.0) | (pts[:, d] == 1.0)
    return pts, simplices, boundary


def assemble_p1(pts: np.ndarray, tris: np.ndarray,
                kappa: Optional[Callable] = None,
                rows_mask: Optional[np.ndarray] = None):
    """Vectorized P1 stiffness assembly: K = sum_T |T| kappa_T g g^T.

    Works for triangles (pts (N, 2), tris (M, 3)) and tetrahedra
    (pts (N, 3), tris (M, 4)) — the barycentric gradients come from the
    element Jacobian in either dimension.  rows_mask: optional (M,) bool
    selecting which elements to assemble (used for the per-subdomain
    Neumann matrices).  Returns COO triplets (rows, cols, vals)."""
    if rows_mask is not None:
        tris = tris[rows_mask]
    dim = pts.shape[1]
    nv = tris.shape[1]
    p = pts[tris]                                   # (M, nv, dim)
    # Jacobian J[:, d, e] = p[e+1, d] - p[0, d]; grads of barycentric
    # basis 1..nv-1 are rows of J^-T, basis 0 is minus their sum
    J = np.stack([p[:, e + 1] - p[:, 0] for e in range(dim)], axis=2)
    det = np.linalg.det(J)
    vol = np.abs(det) / (2.0 if dim == 2 else 6.0)
    Jinv = np.linalg.inv(J)
    g_rest = Jinv                 # (M, e, d): grad of basis e+1 = row e
    g0 = -g_rest.sum(axis=1, keepdims=True)
    g = np.concatenate([g0, g_rest], axis=1)        # (M, nv, dim)
    if kappa is not None:
        c = p.mean(axis=1)
        k = np.asarray(kappa(*(c[:, d] for d in range(dim))),
                       dtype=np.float64)
    else:
        k = 1.0
    Kloc = (vol * k)[:, None, None] * np.einsum("mid,mjd->mij", g, g)
    rows = np.repeat(tris, nv, axis=1).ravel()
    cols = np.tile(tris, (1, nv)).ravel()
    return rows, cols, Kloc.ravel()


def _apply_dirichlet(K: sp.csr_matrix, boundary: np.ndarray,
                     f: np.ndarray) -> sp.csr_matrix:
    """Symmetric elimination: identity rows/cols on boundary nodes."""
    N = K.shape[0]
    free = ~boundary
    D = sp.diags(free.astype(np.float64))
    K2 = D @ K @ D + sp.diags(boundary.astype(np.float64))
    f2 = np.where(boundary, 0.0, f)
    return sp.csr_matrix(K2), f2


def partition_geometric(pts: np.ndarray, S: int) -> np.ndarray:
    """Coordinate-quantile box partition: near-perfectly balanced parts in
    O(N log N), the fast-path stand-in for graph partitioning when vertex
    coordinates exist (partition_kway's BFS seeding is O(N * diameter * k)
    — minutes at production N).  Splits x into gx quantile
    columns, each column into gy quantile cells (gx * gy = S)."""
    N = len(pts)
    gx = int(np.sqrt(S))
    while S % gx:
        gx -= 1
    gy = S // gx
    owner = np.zeros(N, dtype=np.int64)
    order_x = np.argsort(pts[:, 0], kind="stable")
    col_bounds = np.linspace(0, N, gx + 1).astype(np.int64)
    for cx in range(gx):
        col = order_x[col_bounds[cx]: col_bounds[cx + 1]]
        order_y = col[np.argsort(pts[col, 1], kind="stable")]
        row_bounds = np.linspace(0, len(col), gy + 1).astype(np.int64)
        for cy in range(gy):
            owner[order_y[row_bounds[cy]: row_bounds[cy + 1]]] = cx * gy + cy
    return owner


def generate(S: int, nx: int, ny: Optional[int] = None, overlap: int = 1,
             kappa: Optional[Callable] = None, with_neumann: bool = True,
             jitter: float = 0.42, grading: float = 0.0, seed: int = 0,
             partition: str = "kway", rcm_local: bool = True, nz: int = 0,
             dtype=np.float64) -> UnstructuredGenerated:
    """Unstructured P1 FEM diffusion decomposed into S subdomains.

    The decomposition path is the algebraic one (models/fromfile.decompose
    with partition_kway) — exactly what the reference does to an arbitrary
    assembled matrix in schwarzFromFile (generateFromFile.cpp:63-141).
    partition: "kway" (graph-based, best cuts), "geometric" (coordinate
    quantile boxes — O(N log N), for production sizes).

    rcm_local (default True): reverse Cuthill-McKee order each subdomain's
    local dofs.  Neighbor mapping alignment is unaffected (lists stay
    sorted by global id); the banded local numbering keeps the ELL SpMV's
    gathers of x local (ops/ell_spmv.py)."""
    ny = ny or nx
    pts, tris, boundary = delaunay_mesh(nx, ny, jitter=jitter,
                                        grading=grading, seed=seed, nz=nz)
    N = len(pts)
    rows, cols, vals = assemble_p1(pts, tris, kappa=kappa)
    K_raw = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
    K_raw.sum_duplicates()
    f_glob = np.full(N, 1.0)
    K, f_glob = _apply_dirichlet(K_raw, boundary, f_glob)
    K.eliminate_zeros()
    K_m = MatrixCSR(sp.csr_matrix(K.astype(dtype)))

    if partition == "geometric":
        owner = partition_geometric(pts, S)
    else:
        # partition the *pre-elimination* mesh graph: the eliminated
        # matrix has edgeless boundary rows (49% of a 14^3 lattice!) and
        # graph growing then starves every part but one
        owner = partition_kway(K_raw, S)
    base = decompose(K_m, S, overlap=overlap, f_global=f_glob,
                     owner=owner)
    out = UnstructuredGenerated(
        **{fld.name: getattr(base, fld.name)
           for fld in dataclasses.fields(FromFileGenerated)})
    out.points, out.triangles, out.boundary = pts, tris, boundary

    if with_neumann:
        out.neumann = []
        for s in range(S):
            nodes = base.gids[s]
            in_set = np.zeros(N, dtype=bool)
            in_set[nodes] = True
            mask = in_set[tris].all(axis=1)
            r, c, v = assemble_p1(pts, tris, kappa=kappa, rows_mask=mask)
            Ks = sp.csr_matrix((v, (r, c)), shape=(N, N))
            Ks.sum_duplicates()
            # physical Dirichlet also applies to the Neumann operator
            # (identity rows keep it SPSD); artificial boundary stays free
            Ks, _ = _apply_dirichlet(Ks, boundary, np.zeros(N))
            sub = sp.csr_matrix(Ks[nodes][:, nodes].astype(dtype))
            sub.eliminate_zeros()
            out.neumann.append(MatrixCSR(sub))

    if rcm_local:
        rcm_localize(out)
    return out
