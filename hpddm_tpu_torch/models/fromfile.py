"""Algebraic decomposition of an assembled matrix (counterpart of ``hpddm_tpu/models/fromfile.py``).

Host numpy/scipy, kept bit-faithful to the JAX package so that both
packages decompose a matrix into byte-equal subdomains: ``partition_kway``
(balanced BFS growth from farthest-point seeds plus vectorized boundary
Kernighan-Lin refinement, the stand-in for METIS_PartGraphKway of the
reference's examples/generateFromFile.cpp:63-141), overlap growth by
powers of |A| with the ramp partition of unity (``decompose``) and the
reverse Cuthill-McKee local numbering (``rcm_localize``).

Returns the same structures as models/diffusion2d.generate: local matrices,
neighbor lists with elementwise-aligned mappings (sorted by global id on
both sides), and the partition of unity. ``spsd_neumann`` is the
algebraic SPSD splitting for GenEO without user Neumann matrices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from hpddm_tpu_torch.core.csr import MatrixCSR


@dataclasses.dataclass
class FromFileGenerated:
    mats: List[MatrixCSR]
    neighbors: List[List[int]]
    mappings: List[List[np.ndarray]]
    d: List[np.ndarray]            # ramp POU (0 on the outermost layer)
    n_loc: List[int]
    gids: List[np.ndarray]
    owner: np.ndarray              # (N,) owning subdomain per global dof
    A_global: sp.csr_matrix
    f: List[np.ndarray]            # restriction of the global RHS


def _sym_pattern(A: sp.spmatrix) -> sp.csr_matrix:
    pattern = sp.csr_matrix(A, copy=True)
    pattern.data = np.ones_like(pattern.data)
    pattern = sp.csr_matrix(pattern + pattern.T)
    pattern.setdiag(0)
    pattern.eliminate_zeros()
    pattern.data = np.ones_like(pattern.data)
    return pattern


def _refine_kl(pattern: sp.csr_matrix, owner: np.ndarray, k: int,
               passes: int, cap: int) -> np.ndarray:
    """Greedy boundary (Kernighan-Lin / FM flavored) refinement.

    Vectorized per pass: the per-part connectivity of every vertex is one
    sparse matmul ``pattern @ onehot(owner)``; boundary vertices with a
    positive cut gain move to their best-connected neighbor part, best
    gains first, under the balance cap. This is the refinement loop of
    the multilevel k-way recipe (what METIS runs per uncoarsening level,
    cf. generateFromFile.cpp:63-141 METIS_PartGraphKway)."""
    N = pattern.shape[0]
    owner = owner.copy()
    for _ in range(passes):
        oh = sp.csr_matrix(
            (np.ones(N), (np.arange(N), owner)), shape=(N, k))
        conn = np.asarray((pattern @ oh).todense())         # (N, k)
        own_conn = conn[np.arange(N), owner]
        # best foreign part, masked to parts the vertex actually touches
        conn_f = conn.copy()
        conn_f[np.arange(N), owner] = -1
        best_p = np.argmax(conn_f, axis=1)
        touches = conn_f[np.arange(N), best_p] > 0
        gain = conn_f[np.arange(N), best_p] - own_conn
        sizes = np.bincount(owner, minlength=k)
        moved = 0
        # (a) forced drain: oversized parts shed boundary vertices to
        # their best-connected neighbor part even at negative gain
        # (the balance phase of the FM pass)
        over = np.nonzero(sizes > cap)[0]
        for p in over:
            verts = np.nonzero((owner == p) & touches)[0]
            verts = verts[np.argsort(-gain[verts], kind="stable")]
            for v in verts:
                if sizes[p] <= cap:
                    break
                dst = best_p[v]
                if sizes[dst] >= cap:
                    continue
                owner[v] = dst
                sizes[p] -= 1
                sizes[dst] += 1
                moved += 1
        # (b) positive-gain boundary moves, best first, under the cap
        cand = np.nonzero((gain > 0) & touches)[0]
        order = cand[np.argsort(-gain[cand], kind="stable")]
        for v in order:
            src, dst = owner[v], best_p[v]
            if src == dst or sizes[dst] >= cap or sizes[src] <= 1:
                continue
            owner[v] = dst
            sizes[src] -= 1
            sizes[dst] += 1
            moved += 1
        # (c) zero-gain rebalance: shift boundary vertices from
        # above-average parts into clearly smaller neighbors (classic KL
        # admits gain-0 moves for balance; essential on path/grid graphs
        # where every boundary move is gain-0)
        target = -(-N // k)
        cand0 = np.nonzero((gain == 0) & touches)[0]
        for v in cand0:
            src, dst = owner[v], best_p[v]
            if src == dst or sizes[src] <= sizes[dst] + 1 \
                    or sizes[src] <= target:
                continue
            owner[v] = dst
            sizes[src] -= 1
            sizes[dst] += 1
            moved += 1
        if not moved:
            break
    return owner


def partition_kway(A: sp.spmatrix, k: int, method: str = "gg",
                   refine_passes: int = 24,
                   imbalance: float = 1.05) -> np.ndarray:
    """k-way node partition of the adjacency graph.

    method "gg" (default): greedy graph growing — BFS-grow each part
    from a peripheral seed to the target size — followed by vectorized
    boundary KL refinement; the multilevel-METIS recipe without the
    coarsening phase, standing in for the reference's
    METIS_PartGraphKway (generateFromFile.cpp:63-141). It cuts fewer
    interface dofs than the strip partitioner. method "rcm": RCM
    ordering split into contiguous strips (fully deterministic,
    bandwidth-shaped parts)."""
    N = A.shape[0]
    pattern = _sym_pattern(A)
    if method == "rcm" or k <= 1 or N <= k:
        perm = reverse_cuthill_mckee(pattern, symmetric_mode=True)
        owner = np.empty(N, dtype=np.int64)
        bounds = np.linspace(0, N, k + 1).astype(np.int64)
        for s in range(k):
            owner[perm[bounds[s]: bounds[s + 1]]] = s
        return owner

    from collections import deque

    from scipy.sparse.csgraph import breadth_first_order
    indptr, indices = pattern.indptr, pattern.indices
    # k seeds by farthest-point sampling on BFS hop distances
    seeds = [int(breadth_first_order(pattern, 0, directed=False,
                                     return_predecessors=False)[-1])]
    dist = np.full(N, N, dtype=np.int64)
    for _ in range(k - 1):
        # hop distances from the newest seed via a layered frontier sweep
        d = np.full(N, N, dtype=np.int64)
        d[seeds[-1]] = 0
        frontier = np.zeros(N, dtype=bool)
        frontier[seeds[-1]] = True
        lvl = 0
        while frontier.any():
            lvl += 1
            reach = (pattern @ frontier.astype(np.float64)) > 0
            new = reach & (d == N)
            d[new] = lvl
            frontier = new
        dist = np.minimum(dist, d)
        seeds.append(int(np.argmax(np.where(dist == N, -1, dist))))

    # simultaneous balanced BFS growth: the smallest part with a live
    # frontier claims the next layer vertex — contiguous, near-balanced
    # parts by construction (pockets can't form the way sequential
    # growth leaves them)
    owner = np.full(N, -1, dtype=np.int64)
    fronts = [deque() for _ in range(k)]
    sizes = np.zeros(k, dtype=np.int64)
    for s, v in enumerate(seeds):
        if owner[v] < 0:
            owner[v] = s
            sizes[s] += 1
            fronts[s].append(v)
    assigned = int(sizes.sum())
    while assigned < N:
        live = [s for s in range(k) if fronts[s]]
        if not live:
            # disconnected component: seed it into the smallest part
            s = int(np.argmin(sizes))
            v = int(np.nonzero(owner < 0)[0][0])
            owner[v] = s
            sizes[s] += 1
            fronts[s].append(v)
            assigned += 1
            continue
        s = min(live, key=lambda p: sizes[p])
        v = fronts[s].popleft()
        for u in indices[indptr[v]: indptr[v + 1]]:
            if owner[u] < 0:
                owner[u] = s
                sizes[s] += 1
                fronts[s].append(u)
                assigned += 1
    target = -(-N // k)
    cap = int(np.ceil(imbalance * target))
    return _refine_kl(pattern, owner, k, refine_passes, cap)


def rcm_localize(out: "FromFileGenerated") -> None:
    """Permute every subdomain's local numbering to reverse Cuthill-McKee
    order, in place.  Mapping lists keep their (global-id-sorted) order —
    only the local index values change — so neighbor alignment holds.
    The banded local numbering keeps each row's columns near its own
    index, so the ELL SpMV (ops/ell_spmv.py) gathers x from a narrow,
    cache-resident window."""
    S = len(out.mats)
    neumann = getattr(out, "neumann", None)
    for s in range(S):
        K = out.mats[s].scipy(expand=True)
        perm = np.asarray(reverse_cuthill_mckee(K, symmetric_mode=True))
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(len(perm))
        out.mats[s] = MatrixCSR(sp.csr_matrix(K[perm][:, perm]))
        out.gids[s] = out.gids[s][perm]
        out.d[s] = out.d[s][perm]
        out.f[s] = out.f[s][perm]
        if neumann is not None and neumann[s] is not None:
            Kn = neumann[s].scipy(expand=True)
            neumann[s] = MatrixCSR(sp.csr_matrix(Kn[perm][:, perm]))
        for q in range(len(out.mappings[s])):
            out.mappings[s][q] = iperm[out.mappings[s][q]]


def decompose(A: MatrixCSR, n_subdomains: int, overlap: int = 1,
              f_global: Optional[np.ndarray] = None,
              owner: Optional[np.ndarray] = None,
              rcm_local: bool = False) -> FromFileGenerated:
    """Build overlapping subdomains from an assembled matrix.

    Overlap growth (generateFromFile.cpp:63-141): sets grow by
    ``overlap`` rounds of the |A| adjacency.  rcm_local: band-order each
    subdomain's local numbering (see :func:`rcm_localize`).
    """
    csr = A.scipy(expand=True)
    N = csr.shape[0]
    if owner is None:
        owner = partition_kway(csr, n_subdomains)
    adj = csr.copy()
    adj.data = np.abs(adj.data)

    # overlap growth with join-round tracking: the POU ramps from 1 on the
    # owned set down to 0 on the outermost layer (generateFromFile.cpp:
    # 112-118), which is what makes GMV exact on restricted local rows.
    sets: List[np.ndarray] = []
    d_all: List[np.ndarray] = []
    for s in range(n_subdomains):
        joined = np.where(owner == s, 0, -1)
        for r in range(1, overlap + 1):
            reach = adj @ (joined >= 0).astype(np.float64)
            new = (reach > 0) & (joined < 0)
            joined[new] = r
        nodes = np.nonzero(joined >= 0)[0]
        sets.append(nodes)
        if overlap > 0:
            dv = np.where(joined[nodes] == overlap, 0.0,
                          1.0 - joined[nodes] / overlap)
        else:
            dv = np.ones(len(nodes))
        d_all.append(dv)

    mats, gids, n_loc = [], [], []
    node_sets = []
    for s in range(n_subdomains):
        nodes = sets[s]
        node_sets.append(set(nodes.tolist()))
        gids.append(nodes)
        n_loc.append(len(nodes))
        # row-then-column slicing: np.ix_ on scipy CSR densifies the
        # sampling (O(len(nodes)^2) points)
        sub = csr[nodes][:, nodes]
        mats.append(MatrixCSR(sp.csr_matrix(sub)))

    neighbors: List[List[int]] = [[] for _ in range(n_subdomains)]
    mappings: List[List[np.ndarray]] = [[] for _ in range(n_subdomains)]
    for s in range(n_subdomains):
        l_of = {g: i for i, g in enumerate(gids[s])}
        for q in range(n_subdomains):
            if q == s:
                continue
            shared = sorted(node_sets[s] & node_sets[q])
            if shared:
                neighbors[s].append(q)
                mappings[s].append(np.array([l_of[g] for g in shared],
                                            dtype=np.int64))

    f = []
    if f_global is None:
        f_global = np.ones(N)
    for s in range(n_subdomains):
        f.append(np.asarray(f_global)[gids[s]].reshape(-1, 1))

    out = FromFileGenerated(mats=mats, neighbors=neighbors,
                            mappings=mappings, d=d_all, n_loc=n_loc,
                            gids=gids, owner=owner, A_global=csr, f=f)
    if rcm_local:
        rcm_localize(out)
    return out


def spsd_neumann(gen: FromFileGenerated) -> List[MatrixCSR]:
    """Algebraic SPSD splitting of an assembled symmetric matrix: local
    Neumann-analogue matrices for GenEO with no user auxiliary matrices.

    This is the fully-algebraic front-end the reference gets through
    PCHPDDM + aldaas2021robust: write K = sum_s R_s^T Ntilde_s R_s with
    every Ntilde_s SPSD, by splitting each off-diagonal edge (i, j) into
    the PSD block [[|a|, a], [a, |a|]] shared 1/mult_e between the
    subdomains containing both endpoints, and distributing each row's
    nonnegative diagonal remainder a_ii - sum_j |a_ij| by vertex
    multiplicity.  Exact (prolongated sums reproduce K) whenever K is
    weakly diagonally dominant; otherwise the remainder is clamped at 0
    (still SPSD, loudly warned).  Companion of the A^T A splitting in
    solvers/leastsquares.py (rectangular case)."""
    A = sp.csr_matrix(gen.A_global)
    A = sp.csr_matrix((A + A.T) * 0.5)
    N = A.shape[0]
    S = len(gen.gids)
    member = np.zeros((S, N), dtype=bool)
    for s in range(S):
        member[s, gen.gids[s]] = True
    coo = A.tocoo()
    off = coo.row != coo.col
    ei, ej, ev = coo.row[off], coo.col[off], coo.data[off]
    upper = ei < ej
    ei, ej, ev = ei[upper], ej[upper], ev[upper]
    # edge multiplicity: subdomains containing both endpoints
    both = member[:, ei] & member[:, ej]               # (S, E)
    mult_e = np.maximum(both.sum(axis=0), 1)
    lost = int((both.sum(axis=0) == 0).sum())
    # diagonal remainder
    absA = A.copy()
    absA.data = np.abs(absA.data)
    offsum = np.asarray(absA.sum(axis=1)).ravel() - np.abs(A.diagonal())
    rem = A.diagonal() - offsum
    clamped = int((rem < -1e-12 * np.abs(A.diagonal() + 1e-300)).sum())
    if lost or clamped:
        import warnings
        warnings.warn(
            f"spsd_neumann: {lost} edge(s) contained in no subdomain, "
            f"{clamped} row(s) with negative diagonal remainder clamped "
            "— the splitting no longer sums exactly to K (increase the "
            "overlap / matrix is far from diagonally dominant)",
            stacklevel=2)
    rem = np.maximum(rem, 0.0)
    mult_v = np.maximum(member.sum(axis=0), 1)

    out = []
    for s in range(S):
        g = gen.gids[s]
        l_of = np.full(N, -1, dtype=np.int64)
        l_of[g] = np.arange(len(g))
        sel = both[s]
        i_l, j_l = l_of[ei[sel]], l_of[ej[sel]]
        w = ev[sel] / mult_e[sel]
        aw = np.abs(ev[sel]) / mult_e[sel]
        d_l = l_of[g]
        rows = np.concatenate([i_l, j_l, i_l, j_l, d_l])
        cols = np.concatenate([j_l, i_l, i_l, j_l, d_l])
        vals = np.concatenate([w, w, aw, aw,
                               rem[g] / mult_v[g]])
        Nt = sp.csr_matrix((vals, (rows, cols)),
                           shape=(len(g), len(g)))
        Nt.sum_duplicates()
        out.append(MatrixCSR(Nt))
    return out
