"""Substructuring preconditioners: FETI and BDD (counterpart of
``hpddm_tpu/precond/substructure.py``).

The reference's Schur-complement layer (include/HPDDM_schur.hpp:40-812,
HPDDM_FETI.hpp:40-475, HPDDM_BDD.hpp:40-334), batched over the subdomain
axis S on one device:

* local factors are dense (``-hpddm_substructuring_local dense``, the
  default) or banded (``banded``). Dense: the local Neumann matrices get
  pseudo-inverses from a batched ``eigh`` (the kernel, the rigid-body
  modes, from the same eigenpairs), in chunks of subdomains so that the
  setup peak stays bounded; the interior blocks K_ii are inverted batched
  on the device (Cholesky, two triangular solves) and the local Schur
  complements S_s = K_bb - K_bi K_ii^-1 K_ib are batched products.
  Banded, for grid subdomains whose dense factors do not fit: K + eps I
  and K_ii get block-tridiagonal factors (``ops/banded_solve``), K^+ is
  the projected regularized solve with ``k_refine`` refinements, S_b is
  applied implicitly (two local SpMVs, B1/B2 on the card, and one interior
  solve) and S_b^+ is a fixed-degree Chebyshev polynomial; no O(n^2)
  local block is formed;
* FETI's dual space is the fully redundant multiplier space: one
  multiplier per (unordered subdomain pair, shared dof), numbered as the
  JAX package numbers it. B and B^T are gathers from slot lists built at
  setup: B u reads the two signed copies of each multiplier, B^T lambda
  reads, at each interface dof, its (up to three) multipliers in slot
  order. No scatter-add, so the result is the same in every run;
* the coarse projection P = I - G (G^T G)^-1 G^T with G = B R is dense
  (``dense``), matrix-free and exact (``mfree``: G and G^T through B and
  the kernel basis, G^H G assembled from the slots on the host, the BDD
  balancing basis W never formed) or matrix-free with fixed-degree
  Chebyshev solves of G^T G and W^T S W (``cheby``);
* BDD runs the balanced Neumann-Neumann preconditioner on consistent
  interface vectors, exchanged through an interface-only decomposition;
* GenEO-substructuring (``Substructure.solve_gevp``) enriches BDD's
  balancing space and, with ``feti_deflation=True``, deflates FETI's
  projected operator; in the banded mode its pencil is solved by
  shift-invert Lanczos on the implicit Schur applies.

Both solvers are projected CG as Python loops with one host read per
iteration (the JAX package's ``lax.while_loop``): the loop runs while
``it <= max_it`` and some column's residual is above ``tol``, ``it``
starting at 1 and the residual at inf, and reports ``it - 1``.

The Chebyshev bounds are host floats, estimated at setup by power
iterations from a seeded ``torch.Generator`` start (the JAX package draws
``jax.random.normal``; the bounds, and so the counts where they enter,
follow the start: ROADMAP queue C, C21). A Chebyshev solve computes its
coefficients on the host and reads nothing from the device in its loop.

Pseudo-inverse cutoffs are passed explicitly, as each library's default
differs: the BDD coarse matrix takes the JAX package's ``jnp.linalg.pinv``
cutoff (10 max(m, n) eps relative), the FETI deflation matrix numpy's
(1e-15 relative); G^H G keeps its 1e-14 shift. Complex matrices raise
``TypeError``: the JAX package's GenEO enrichment drops imaginary parts
(ROADMAP queue C, C19).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from hpddm_tpu_torch.core.formats import pack_local_matrices
from hpddm_tpu_torch.device import DEFAULT, as_device, synchronize
from hpddm_tpu_torch.dtypes import as_torch_dtype, underlying
from hpddm_tpu_torch.ops.banded_solve import BandedSolver, build_banded_solver
from hpddm_tpu_torch.ops.spmv import spmm
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.parallel.ops import exchange

# bytes of one chunk of dense local matrices in the setup (K, its
# symmetric part and its eigenvectors are alive together)
CHUNK_BYTES = 2 << 30


# ----------------------------------------------------------------------
# state
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """Gather lists of B, B^T and the coarse columns, derived from the
    multiplier slots (``plan_of``). Flat positions index a batch viewed as
    (S * rows, mu) with one zero row appended at the end.

    lam_pos : (N_l, 2) positions s * n_max + loc of the + and - copy of
        each multiplier (B on full local vectors).
    lam_bpos : (N_l, 2) the same as interface positions s * nb_max + k.
    bt_idx : (S, nb_max, P) the multipliers of each interface dof in slot
        order, as rows of [lambda; -lambda; 0]: lid for sign +1, N_l + lid
        for -1, 2 N_l for a pad.
    kern_col : (nc,) row s * r_max + k of each coarse column in the
        (S * r_max) kernel dots (the zero row when there is none).
    kern_src : (S, r_max) coarse column of each kernel slot, nc when the
        slot is inactive.
    b_dst, i_dst : (S * nb_max,), (S * ni_max,) flat position s * n_max +
        local dof of each interface and interior slot, S * n_max (a drop
        row) for a pad: the index writes of ``_full``.
    """
    lam_pos: torch.Tensor
    lam_bpos: torch.Tensor
    bt_idx: torch.Tensor
    kern_col: torch.Tensor
    kern_src: torch.Tensor
    b_dst: torch.Tensor
    i_dst: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SubstructureState:
    """Batched substructuring state (leading axis = subdomains). The fields
    of the JAX package's ``SubstructureState``; those of the Chebyshev
    coarse mode and of the banded local mode stay None outside them.
    Index tensors are int64; the Chebyshev bounds are host floats. In the
    banded mode K_pinv, S_b, S_b_pinv, K_bi and Kii_inv are (S, 1, 1)
    zeros."""
    K_pinv: torch.Tensor       # (S, n, n) pseudo-inverse of local Neumann K_s
    kernels: torch.Tensor      # (S, n, r_max) kernel basis of K_s (padded)
    r_loc: torch.Tensor        # (S,) kernel dimensions
    S_b: torch.Tensor          # (S, nb, nb) local boundary Schur complements
    S_b_pinv: torch.Tensor     # (S, nb, nb)
    Sb_kernels: torch.Tensor   # (S, nb, r_max) kernel of S_b (padded)
    sb_r_loc: torch.Tensor     # (S,)
    K_bi: torch.Tensor         # (S, nb, ni) boundary-interior coupling
    K_bb: torch.Tensor         # (S, nb, nb) boundary block (lumped precond)
    bidx: torch.Tensor         # (S, nb) local indices of interface dofs
    b_mask: torch.Tensor       # (S, nb) validity
    scaling: torch.Tensor      # (S, nb) multiplicity/stiffness scaling
    Kii_inv: torch.Tensor      # (S, ni, ni) interior-block inverse
    iidx: torch.Tensor         # (S, ni) interior dof indices
    i_mask: torch.Tensor       # (S, ni)
    lam_id: torch.Tensor       # (S, L) multiplier id of each slot (pad N_l)
    lam_loc: torch.Tensor      # (S, L) local dof of the slot
    lam_sign: torch.Tensor     # (S, L) +1 / -1 / 0 (pad)
    kern_off: torch.Tensor     # (S,) first coarse column of each subdomain
    sub_gid: torch.Tensor      # (S,) subdomain index
    G: Optional[torch.Tensor]  # (N_l, nc) = B * kernels; None in mfree mode
    GtG_inv: Optional[torch.Tensor]  # (nc, nc)
    dec_b: Decomposition       # interface-only decomposition (BDD exchange)
    N_l: int
    nc: int
    n_max: int
    S_total: int
    plan: SlotPlan
    # GenEO deflation space (solve_gevp): multiplier directions deflated
    # F-orthogonally during the projected CG
    G_def: Optional[torch.Tensor] = None      # (N_l, nd)
    FG_def: Optional[torch.Tensor] = None     # (N_l, nd) = F G_def
    GFG_inv: Optional[torch.Tensor] = None    # (nd, nd) = (G^T F G)^+
    coarse_mode: str = "dense"
    local_mode: str = "dense"
    # the Chebyshev coarse mode: degrees and spectral bounds of G^T G
    # (FETI) and W^T S W (BDD)
    coarse_degree: int = 0
    bdd_coarse_degree: int = 0
    gtg_lo: Optional[float] = None
    gtg_hi: Optional[float] = None
    wsw_lo: Optional[float] = None
    wsw_hi: Optional[float] = None
    # the banded local mode: refinements of K^+, the BandedSolver of
    # K + eps I (full box) and of K_ii (interior box), the packed local
    # matrices (BatchedDIA or BatchedELL) and the Chebyshev S_b^+ (bounds
    # of the kernel-deflated S_b, degree)
    k_refine: int = 2
    Kb: Optional[BandedSolver] = None
    Kiib: Optional[BandedSolver] = None
    A_loc: Optional[object] = None
    sb_lo: Optional[float] = None
    sb_hi: Optional[float] = None
    sb_degree: int = 0

    @property
    def device(self) -> torch.device:
        return self.scaling.device


def plan_of(lam_id, lam_loc, lam_sign, bidx, b_mask, iidx, i_mask, r_loc,
            kern_off, r_max: int, N_l: int, nc: int, n_max: int,
            device) -> SlotPlan:
    """The gather lists of ``SlotPlan`` from the slot arrays (host numpy)."""
    lam_id, lam_loc, lam_sign, bidx, b_mask, iidx, i_mask, kern_off = (
        np.asarray(a) for a in (lam_id, lam_loc, lam_sign, bidx, b_mask,
                                iidx, i_mask, kern_off))
    r_loc = np.asarray(r_loc, dtype=np.int64)
    S, L = lam_id.shape
    nb = bidx.shape[1]

    valid = lam_id < N_l
    s_of = np.broadcast_to(np.arange(S)[:, None], (S, L))
    lid, loc, sgn, ss = (lam_id[valid].astype(np.int64),
                         lam_loc[valid].astype(np.int64), lam_sign[valid],
                         s_of[valid])
    # interface slot of each local dof
    b_of = np.full((S, n_max), -1, dtype=np.int64)
    for s in range(S):
        b_of[s, bidx[s][b_mask[s]]] = np.nonzero(b_mask[s])[0]
    k_of = b_of[ss, loc]
    if np.any(k_of < 0):
        raise ValueError("a multiplier slot lies off the interface")
    plus = sgn > 0
    lam_pos = np.zeros((N_l, 2), dtype=np.int64)
    lam_bpos = np.zeros((N_l, 2), dtype=np.int64)
    for col, m in ((0, plus), (1, ~plus)):
        lam_pos[lid[m], col] = ss[m] * n_max + loc[m]
        lam_bpos[lid[m], col] = ss[m] * nb + k_of[m]

    # B^T: the multipliers of each interface dof, in slot order
    key = ss * nb + k_of
    order = np.argsort(key, kind="stable")       # slot order within a key
    ks = key[order]
    first = np.concatenate([[True], ks[1:] != ks[:-1]]) if len(ks) else \
        np.zeros(0, bool)
    start = np.maximum.accumulate(np.where(first, np.arange(len(ks)), 0))
    rank = np.arange(len(ks)) - start
    P = int(rank.max(initial=0)) + 1
    bt_idx = np.full((S * nb, P), 2 * N_l, dtype=np.int64)
    signed = np.where(sgn > 0, lid, N_l + lid)[order]
    bt_idx[ks, rank] = signed

    active = np.arange(r_max)[None, :] < r_loc[:, None]
    kern_src = np.where(active, kern_off[:, None] + np.arange(r_max)[None, :],
                        nc).astype(np.int64)
    kern_col = np.full(nc, S * r_max, dtype=np.int64)
    flat = (np.arange(S)[:, None] * r_max + np.arange(r_max)[None, :])
    kern_col[kern_src[active]] = flat[active]

    base = np.arange(S)[:, None] * n_max
    b_dst = np.where(b_mask, base + bidx, S * n_max).reshape(-1)
    i_dst = np.where(i_mask, base + iidx, S * n_max).reshape(-1)

    def dev(a):
        return torch.as_tensor(a, device=device)
    return SlotPlan(lam_pos=dev(lam_pos), lam_bpos=dev(lam_bpos),
                    bt_idx=dev(bt_idx.reshape(S, nb, P)),
                    kern_col=dev(kern_col),
                    kern_src=dev(kern_src), b_dst=dev(b_dst.astype(np.int64)),
                    i_dst=dev(i_dst.astype(np.int64)))


def _orthonormal(k: np.ndarray) -> np.ndarray:
    """An orthonormal basis of the columns of k by QR, the columns whose
    R diagonal is below 1e-10 of the largest dropped."""
    if not k.shape[1]:
        return k
    q, r = np.linalg.qr(k)
    d = np.abs(np.diag(r))
    return q[:, d > 1e-10 * max(d.max(), 1e-300)]


def _eigh_pinv(w, V, kernel_tol):
    """(pseudo-inverse, null mask) of a batch of symmetric matrices from
    their eigenpairs: eigenvalues at most kernel_tol * max |w| are the
    kernel."""
    wmax = torch.amax(torch.abs(w), dim=1, keepdim=True)
    null = torch.abs(w) <= kernel_tol * wmax
    inv_w = torch.where(null, torch.zeros_like(w),
                        1.0 / torch.where(null, torch.ones_like(w), w))
    pinv = (V * inv_w[:, None, :]) @ V.mT
    return pinv, null


def _kernel_columns(V, null, n_loc, r_max):
    """(S', n, r_max) kernel bases: the null eigenvectors in ascending
    eigenvalue order, zero below each subdomain's size, normalized."""
    Sp, n, _ = V.shape
    order = torch.argsort((~null).to(torch.int8), dim=1, stable=True)
    idx = order[:, :r_max]
    cols = torch.gather(V, 2, idx[:, None, :].expand(-1, n, -1))
    r = null.sum(dim=1)
    keep = (torch.arange(n, device=V.device)[None, :, None]
            < n_loc[:, None, None]) & \
        (torch.arange(r_max, device=V.device)[None, None, :] < r[:, None, None])
    cols = torch.where(keep, cols, torch.zeros_like(cols))
    nrm = torch.linalg.norm(cols, dim=1, keepdim=True)
    return cols / torch.where(nrm > 0, nrm, torch.ones_like(nrm))


class Substructure:
    """Host-side setup from a non-overlapping decomposition (the JAX
    package's signature without its unused ``r_max``). The banded local
    mode (``-hpddm_substructuring_local banded``) needs ``grid_shapes``
    [(wy, wx), ...], the row-major local grid of each subdomain, with
    ``slot_maps`` (local row -> box slot iy * wx + ix) where a node set
    does not fill its box, and takes the analytic ``kernels`` (per
    subdomain an (n, r) array or None) in place of an eigh.

    ``timings`` holds the wall seconds of each setup phase (each ends in a
    synchronize): ``interface`` (interface, multipliers, scaling), then
    dense: ``eigh_K`` (the chunked eigh, K^+ and kernels), ``schur`` (the
    blocks, K_ii^-1 and S_b), ``eigh_Sb``; banded: ``kernels`` (the kernel
    bases and their boundary traces), ``factor_K`` (the banded factor of
    K + eps I on the host), ``factor_Kii``, ``pack`` (the local matrices
    and K_bb); then ``coarse``, ``dec_b``, ``plan`` (the gather lists) and,
    where they run, ``calibrate_sb`` and ``calibrate_coarse`` (the
    Chebyshev bounds)."""

    def __init__(self, mats, neighbors: Sequence[Sequence[int]],
                 mappings: Sequence[Sequence[np.ndarray]],
                 options: Optional[Options] = None,
                 kernel_tol: float = 1.0e-8, device=DEFAULT,
                 kernels: Optional[Sequence] = None,
                 grid_shapes: Optional[Sequence] = None,
                 slot_maps: Optional[Sequence] = None):
        self.opt = options if options is not None else Options()
        self.device = as_device(device)
        self.timings: Dict[str, float] = {}
        dev = self.device
        dtype = np.result_type(*[m.dtype for m in mats])
        if np.issubdtype(dtype, np.complexfloating):
            raise TypeError(
                "Substructure takes real matrices only: the JAX package's "
                "GenEO enrichment builds real traces and transposes without "
                "a conjugate (ROADMAP queue C, C19)")
        local_mode = self.opt.val("substructuring_local") or "dense"
        co_mode = self.opt.val("substructuring_coarse") or "dense"
        tdt = as_torch_dtype(dtype)
        S = len(mats)
        n_loc = np.array([m.n for m in mats])
        n_max = int(n_loc.max())
        self.n_max = n_max

        t0 = time.perf_counter()
        # -- interface structure ------------------------------------------
        is_interface = [np.zeros(m.n, dtype=bool) for m in mats]
        for s in range(S):
            for idx in mappings[s]:
                is_interface[s][np.asarray(idx)] = True
        nb_loc = np.array([int(m.sum()) for m in is_interface])
        nb_max = int(nb_loc.max())
        ni_loc = n_loc - nb_loc
        ni_max = int(ni_loc.max())
        bidx = np.zeros((S, nb_max), dtype=np.int64)
        b_mask = np.zeros((S, nb_max), dtype=bool)
        iidx = np.zeros((S, ni_max), dtype=np.int64)
        i_mask = np.zeros((S, ni_max), dtype=bool)
        for s in range(S):
            b = np.nonzero(is_interface[s])[0]
            i = np.nonzero(~is_interface[s])[0]
            bidx[s, : len(b)] = b
            b_mask[s, : len(b)] = True
            iidx[s, : len(i)] = i
            i_mask[s, : len(i)] = True

        # -- multiplier space (fully redundant, pair-owned): the lower
        # subdomain numbers each pair's multipliers in its neighbour order;
        # each subdomain lists its slots in the order they were made ------
        pair_of = {}
        next_lam = 0
        for s in range(S):
            for q, idx in zip(neighbors[s], mappings[s]):
                if q < s:
                    continue
                pos = list(neighbors[q]).index(s)
                pair_of[(s, q)] = (next_lam, np.asarray(idx, np.int64),
                                   np.asarray(mappings[q][pos], np.int64))
                next_lam += len(idx)
        N_l = next_lam
        slots: List[List[tuple]] = [[] for _ in range(S)]
        for (s, q), (l0, a, bq) in pair_of.items():   # made in this order
            ids = np.arange(l0, l0 + len(a))
            slots[s].append((ids, a, 1.0))
            slots[q].append((ids, bq, -1.0))
        L_max = max([sum(len(x[0]) for x in sl) for sl in slots] + [0])
        lam_id = np.full((S, L_max), N_l, dtype=np.int64)
        lam_loc = np.zeros((S, L_max), dtype=np.int64)
        lam_sign = np.zeros((S, L_max))
        for s, sl in enumerate(slots):
            k = 0
            for ids, loc, sgn in sl:
                lam_id[s, k: k + len(ids)] = ids
                lam_loc[s, k: k + len(ids)] = loc
                lam_sign[s, k: k + len(ids)] = sgn
                k += len(ids)

        # -- interface scaling (Feti/Bdd::buildScaling): multiplicity
        # (1/mult) or stiffness (rho_s / sum_sharers rho_q, rho = local
        # diagonal), -hpddm_substructuring_scaling ---------------------
        sc_kind = self.opt.val("substructuring_scaling")
        diags = [np.asarray(m.scipy().diagonal()).real for m in mats]
        denom = [d.copy() for d in diags]
        mult = [np.ones(m.n) for m in mats]
        for s in range(S):
            for q, idx in zip(neighbors[s], mappings[s]):
                pos = list(neighbors[q]).index(s)
                idx_q = np.asarray(mappings[q][pos])
                denom[s][np.asarray(idx)] += diags[q][idx_q]
                mult[s][np.asarray(idx)] += 1.0
        scaling = np.zeros((S, nb_max))
        for s in range(S):
            b = bidx[s, : nb_loc[s]]
            if sc_kind in ("stiffness", "coefficient"):
                scaling[s, : nb_loc[s]] = diags[s][b] / denom[s][b]
            else:
                scaling[s, : nb_loc[s]] = 1.0 / mult[s][b]

        def t(a, dt=None):
            return torch.as_tensor(a, dtype=dt, device=dev)
        bidx_t, b_mask_t = t(bidx), t(b_mask)
        iidx_t, i_mask_t = t(iidx), t(i_mask)
        self._timed("interface", t0)

        # -- local factors: dense, chunked over subdomains, or banded -------
        if local_mode == "banded":
            loc = self._build_banded(mats, n_loc, nb_loc, ni_loc, bidx, iidx,
                                     tdt, kernels, grid_shapes, slot_maps)
        else:
            loc = self._build_dense(mats, n_loc, nb_loc, tdt, kernel_tol,
                                    bidx_t, b_mask_t, iidx_t, i_mask_t)
        kernels, r_loc, sb_r_loc = loc["kernels"], loc["r_loc"], \
            loc["sb_r_loc"]
        r_max_eff = kernels.shape[2]

        # -- coarse projection G = B * kernels ----------------------------
        t0 = time.perf_counter()
        n_cols = int(r_loc.sum())
        nc = max(n_cols, 1)
        if not n_cols:
            co_mode = "dense"        # nothing to invert; keep the eye path
        kern_off = np.concatenate([[0], np.cumsum(r_loc)[:-1]]).astype(
            np.int64)
        lam_id_t, lam_loc_t = t(lam_id), t(lam_loc)
        lam_sign_t = t(lam_sign, tdt)
        G, GtG_inv = coarse_projection(kernels, t(r_loc), t(kern_off),
                                       lam_id_t, lam_loc_t, lam_sign_t, N_l,
                                       nc, co_mode)
        self._timed("coarse", t0)

        # -- interface-only decomposition (for BDD exchange) ---------------
        t0 = time.perf_counter()
        b_of = np.full((S, n_max), -1, dtype=np.int64)
        for s in range(S):
            b_of[s, bidx[s, : nb_loc[s]]] = np.arange(nb_loc[s])
        b_mappings = [[b_of[s][np.asarray(idx, dtype=np.int64)]
                       for idx in mappings[s]] for s in range(S)]
        dec_b = Decomposition.from_subdomains(
            neighbors, b_mappings, nb_loc.tolist(), d=None, n_max=nb_max,
            scaling="multiplicity", renumber=False, dtype=dtype, device=dev)
        self._timed("dec_b", t0)

        t0 = time.perf_counter()
        plan = plan_of(lam_id, lam_loc, lam_sign, bidx, b_mask, iidx, i_mask,
                       r_loc, kern_off, r_max_eff, N_l, nc, n_max, dev)
        self._timed("plan", t0)
        self.state = SubstructureState(
            K_pinv=loc["K_pinv"], kernels=kernels, r_loc=t(r_loc),
            S_b=loc["S_b"], S_b_pinv=loc["S_b_pinv"],
            Sb_kernels=loc["Sb_kernels"], sb_r_loc=t(sb_r_loc),
            K_bi=loc["K_bi"], K_bb=loc["K_bb"],
            bidx=bidx_t, b_mask=b_mask_t, scaling=t(scaling, tdt),
            Kii_inv=loc["Kii_inv"], iidx=iidx_t, i_mask=i_mask_t,
            lam_id=lam_id_t, lam_loc=lam_loc_t, lam_sign=lam_sign_t,
            kern_off=t(kern_off), sub_gid=torch.arange(S, device=dev),
            G=G, GtG_inv=GtG_inv, dec_b=dec_b, N_l=N_l, nc=nc,
            n_max=n_max, S_total=S, plan=plan, coarse_mode=co_mode,
            local_mode=local_mode,
            k_refine=int(self.opt.val("substructuring_refine", 2)),
            Kb=loc.get("Kb"), Kiib=loc.get("Kiib"), A_loc=loc.get("A_loc"))
        if local_mode == "banded":
            t0 = time.perf_counter()
            self.state = _calibrate_sb(self.state, self.opt)
            self._timed("calibrate_sb", t0)
        if co_mode == "cheby":
            t0 = time.perf_counter()
            self.state = _calibrate_coarse(self.state, self.opt)
            self._timed("calibrate_coarse", t0)

    def _build_dense(self, mats, n_loc, nb_loc, tdt, kernel_tol, bidx_t,
                     b_mask_t, iidx_t, i_mask_t):
        """The dense local factors, chunked over subdomains: K^+ and the
        kernels from a batched eigh, the Schur blocks, S_b^+ and the Schur
        kernels from a second eigh."""
        dev = self.device
        S, n_max = len(mats), self.n_max
        nb_max, ni_max = bidx_t.shape[1], iidx_t.shape[1]
        n_loc_t = torch.as_tensor(n_loc, device=dev)
        coo = [m.scipy(expand=True).tocoo() for m in mats]
        chunk = max(1, int(CHUNK_BYTES // (n_max * n_max * tdt.itemsize)))
        K_pinv = torch.empty((S, n_max, n_max), dtype=tdt, device=dev)
        S_b = torch.empty((S, nb_max, nb_max), dtype=tdt, device=dev)
        K_bb = torch.empty((S, nb_max, nb_max), dtype=tdt, device=dev)
        K_bi = torch.empty((S, nb_max, ni_max), dtype=tdt, device=dev)
        Kii_inv = torch.empty((S, ni_max, ni_max), dtype=tdt, device=dev)
        null_parts, ker_parts = [], []
        t_eigh = t_schur = 0.0
        for s0 in range(0, S, chunk):
            s1 = min(S, s0 + chunk)
            ta = time.perf_counter()
            K = self._dense_chunk(coo[s0:s1], n_loc[s0:s1], n_max, tdt)
            w, V = torch.linalg.eigh(0.5 * (K + K.mT))
            K_pinv[s0:s1], null = _eigh_pinv(w, V, kernel_tol)
            r_c = max(int(null.sum(dim=1).max()), 1)
            ker_parts.append(_kernel_columns(V, null, n_loc_t[s0:s1], r_c))
            null_parts.append(null.sum(dim=1))
            del w, V, null
            synchronize(dev)
            tb = time.perf_counter()
            t_eigh += tb - ta
            (S_b[s0:s1], K_bb[s0:s1], K_bi[s0:s1],
             Kii_inv[s0:s1]) = self._schur_chunk(
                K, bidx_t[s0:s1], b_mask_t[s0:s1], iidx_t[s0:s1],
                i_mask_t[s0:s1])
            del K
            synchronize(dev)
            t_schur += time.perf_counter() - tb
        r_loc = torch.cat(null_parts).cpu().numpy().astype(np.int64)
        r_max_eff = max(int(r_loc.max(initial=0)), 1)
        kernels = torch.zeros((S, n_max, r_max_eff), dtype=tdt, device=dev)
        s0 = 0
        for part in ker_parts:
            kernels[s0: s0 + part.shape[0], :, : part.shape[2]] = \
                part[:, :, :r_max_eff]
            s0 += part.shape[0]
        del ker_parts
        self.timings["eigh_K"] = t_eigh
        self.timings["schur"] = t_schur

        t0 = time.perf_counter()
        wS, VS = torch.linalg.eigh(0.5 * (S_b + S_b.mT))
        S_b_pinv, nullS = _eigh_pinv(wS, VS, kernel_tol)
        sb_r_loc = nullS.sum(dim=1).cpu().numpy().astype(np.int64)
        sb_r_max = max(int(sb_r_loc.max(initial=0)), 1)
        Sb_kernels = _kernel_columns(VS, nullS, torch.as_tensor(
            nb_loc, device=dev), sb_r_max)
        del wS, VS, nullS
        self._timed("eigh_Sb", t0)
        return dict(kernels=kernels, r_loc=r_loc, sb_r_loc=sb_r_loc,
                    K_pinv=K_pinv, S_b=S_b, S_b_pinv=S_b_pinv,
                    Sb_kernels=Sb_kernels, K_bi=K_bi, K_bb=K_bb,
                    Kii_inv=Kii_inv)

    def _build_banded(self, mats, n_loc, nb_loc, ni_loc, bidx, iidx, tdt,
                      kernels_in, grid_shapes, slot_maps):
        """Matrix-free local factors for grid subdomains (the JAX package's
        ``_build_banded``): the analytic kernels orthonormalized by QR, the
        banded factor of K + eps I (eps relative to the mean diagonal, on
        floating subdomains only: 1e-8 in f64, 1e-4 below) on the host in
        f64, that of the interior block K_ii on its sub-rectangle, the
        packed local matrices for the SpMVs, dense K_bb (the lumped
        preconditioner) and the kernels' boundary traces. K^+, S_b, S_b^+,
        K_bi and K_ii^-1 stay (S, 1, 1) zeros."""
        dev = self.device
        S, n_max = len(mats), self.n_max
        nb_max, ni_max = bidx.shape[1], iidx.shape[1]
        npdt = torch.empty(0, dtype=tdt).numpy().dtype
        if grid_shapes is None:
            raise ValueError("substructuring_local=banded needs "
                             "grid_shapes=[(wy, wx), ...] describing the "
                             "row-major local grid ordering")
        t0 = time.perf_counter()
        # analytic kernels (constants / rigid-body modes) and their
        # boundary traces (the Schur kernels), each orthonormalized
        cols, sb_cols = [], []
        for s in range(S):
            ker = None if kernels_in is None else kernels_in[s]
            k2 = np.zeros((int(n_loc[s]), 0)) if ker is None or \
                np.size(ker) == 0 else np.asarray(ker, dtype=np.float64)
            cols.append(_orthonormal(k2[:, None] if k2.ndim == 1 else k2))
            sb_cols.append(_orthonormal(cols[s][bidx[s, : int(nb_loc[s])]]))
        r_loc = np.array([c.shape[1] for c in cols], dtype=np.int64)
        sb_r_loc = np.array([c.shape[1] for c in sb_cols], dtype=np.int64)
        kernels = np.zeros((S, n_max, max(int(r_loc.max(initial=0)), 1)),
                           dtype=npdt)
        Sb_kernels = np.zeros((S, nb_max, max(int(sb_r_loc.max(initial=0)),
                                              1)), dtype=npdt)
        for s in range(S):
            kernels[s, : cols[s].shape[0], : r_loc[s]] = cols[s]
            Sb_kernels[s, : sb_cols[s].shape[0], : sb_r_loc[s]] = sb_cols[s]
        self.timings["kernels"] = time.perf_counter() - t0

        # banded factor of K (+ eps I on floating subdomains; the eps error
        # is removed by the refinement passes and the kernel projection),
        # on the host in f64: K + eps I is near-singular, and a device f32
        # recursion would perturb the near-null modes K^+ must resolve
        t0 = time.perf_counter()
        eps_rel = 1e-8 if npdt.itemsize >= 8 else 1e-4
        csrs = [sp.csr_matrix(m.scipy(expand=True)) for m in mats]
        K_regs, boxes = [], []
        for s, Ks in enumerate(csrs):
            Ks = sp.csr_matrix(Ks, dtype=np.float64)
            if r_loc[s]:
                scale = float(np.abs(Ks.diagonal()).mean())
                Ks = sp.csr_matrix(Ks + (eps_rel * scale)
                                   * sp.identity(Ks.shape[0]))
            K_regs.append(Ks)
            wy, wx = grid_shapes[s]
            if slot_maps is None and wy * wx != int(n_loc[s]):
                raise ValueError(f"subdomain {s}: grid shape {wy}x{wx} "
                                 f"does not match n={n_loc[s]} (pass "
                                 "slot_maps for unfilled boxes)")
            boxes.append((0, wx, 0, wy))
        Kb = build_banded_solver(K_regs, boxes, n_max, dtype=tdt,
                                 slot_maps=slot_maps, method="host",
                                 device=dev)
        del K_regs
        self._timed("factor_K", t0)

        # interior sub-rectangles -> banded factor of K_ii (holes embedded
        # through slot maps, like the full-box factor)
        t0 = time.perf_counter()
        Kii_list, i_boxes, i_slots = [], [], []
        for s, Ks in enumerate(csrs):
            wy, wx = grid_shapes[s]
            ni = int(ni_loc[s])
            ii = np.asarray(iidx[s, :ni], dtype=np.int64)
            sl = (np.arange(int(n_loc[s])) if slot_maps is None
                  else np.asarray(slot_maps[s], dtype=np.int64))
            pos = sl[ii]
            iy, ix = pos // wx, pos % wx
            wyi = int(iy.max() - iy.min() + 1) if ni else 1
            wxi = int(ix.max() - ix.min() + 1) if ni else 1
            islot = ((iy - (iy.min() if ni else 0)) * wxi
                     + (ix - (ix.min() if ni else 0)))
            if len(np.unique(islot)) != ni:
                raise ValueError(f"subdomain {s}: interior dof set does "
                                 "not embed in a rectangle")
            Kii_list.append(sp.csr_matrix(Ks[ii][:, ii]))
            i_boxes.append((0, wxi, 0, wyi))
            i_slots.append(islot)
        Kiib = build_banded_solver(Kii_list, i_boxes, ni_max, dtype=tdt,
                                   slot_maps=i_slots, device=dev)
        del Kii_list
        self._timed("factor_Kii", t0)

        # packed local matrices (SpMV) and K_bb (lumped preconditioner)
        t0 = time.perf_counter()
        A_loc = pack_local_matrices(list(mats), n_max=n_max, fmt="auto",
                                    dtype=npdt, pad_identity=True, device=dev)
        K_bb = np.zeros((S, nb_max, nb_max), dtype=npdt)
        for s, Ks in enumerate(csrs):
            nb = int(nb_loc[s])
            b = np.asarray(bidx[s, :nb], dtype=np.int64)
            K_bb[s, :nb, :nb] = Ks[b][:, b].toarray()
            pad = np.arange(nb, nb_max)
            K_bb[s, pad, pad] = 1.0
        self._timed("pack", t0)

        def t(a):
            return torch.as_tensor(a, device=dev)
        dummy = torch.zeros((S, 1, 1), dtype=tdt, device=dev)
        return dict(kernels=t(kernels), r_loc=r_loc, sb_r_loc=sb_r_loc,
                    K_pinv=dummy, S_b=dummy, S_b_pinv=dummy,
                    Sb_kernels=t(Sb_kernels), K_bi=dummy, K_bb=t(K_bb),
                    Kii_inv=dummy, Kb=Kb, Kiib=Kiib, A_loc=A_loc)

    def _timed(self, phase: str, t0: float) -> None:
        synchronize(self.device)
        self.timings[phase] = time.perf_counter() - t0

    def _dense_chunk(self, coo, n_loc, n_max, tdt) -> torch.Tensor:
        """(S', n_max, n_max) dense local matrices on the device, identity
        on the padding."""
        dev = self.device
        Sp = len(coo)
        s_ix = np.concatenate([np.full(c.nnz, k, dtype=np.int64)
                               for k, c in enumerate(coo)])
        r = np.concatenate([c.row for c in coo]).astype(np.int64)
        c_ = np.concatenate([c.col for c in coo]).astype(np.int64)
        v = np.concatenate([c.data for c in coo])
        pad_s = np.concatenate([np.full(n_max - n, k, dtype=np.int64)
                                for k, n in enumerate(n_loc)])
        pad_i = np.concatenate([np.arange(n, n_max) for n in n_loc])
        K = torch.zeros((Sp, n_max, n_max), dtype=tdt, device=dev)
        idx = [torch.as_tensor(np.concatenate([a, b]), device=dev)
               for a, b in ((s_ix, pad_s), (r, pad_i), (c_, pad_i))]
        K.index_put_(tuple(idx), torch.as_tensor(
            np.concatenate([v, np.ones(len(pad_s))]), dtype=tdt, device=dev),
            accumulate=True)
        return K

    @staticmethod
    def _schur_chunk(K, bidx, b_mask, iidx, i_mask):
        """(S_b, K_bb, K_bi, K_ii^-1) of a chunk of dense local matrices:
        the blocks are gathered on the device, padded with identity
        diagonals (K_bb, S_b, K_ii^-1) and zeros (K_bi)."""
        Sp, n, _ = K.shape
        nb, ni = bidx.shape[1], iidx.shape[1]

        def block(ri, ci):
            rows = torch.gather(K, 1, ri[:, :, None].expand(-1, -1, n))
            return torch.gather(rows, 2, ci[:, None, :].expand(
                -1, ri.shape[1], -1))

        def padded(M, mask):
            keep = mask[:, :, None] & mask[:, None, :]
            M = torch.where(keep, M, torch.zeros_like(M))
            return M + torch.diag_embed((~mask).to(M.dtype))

        Kbb = padded(block(bidx, bidx), b_mask)
        Kbi = block(bidx, iidx)
        Kbi = torch.where(b_mask[:, :, None] & i_mask[:, None, :], Kbi,
                          torch.zeros_like(Kbi))
        Kii = padded(block(iidx, iidx), i_mask)
        L, info = torch.linalg.cholesky_ex(Kii)
        if bool((info == 0).all()):
            eye = torch.eye(ni, dtype=K.dtype, device=K.device).expand(
                Sp, ni, ni)
            Linv = torch.linalg.solve_triangular(L, eye, upper=False)
            Kii_inv = Linv.mT @ Linv
        else:
            Kii_inv = torch.linalg.inv(Kii)
        del L, Kii
        Sb = Kbb - Kbi @ Kii_inv @ Kbi.mT
        Sb = padded(Sb, b_mask)
        return Sb, Kbb, Kbi, Kii_inv

    # ------------------------------------------------------------------
    def solve_gevp(self, nu: int = 4, threshold: Optional[float] = None,
                   feti_deflation: bool = False,
                   pencil=None) -> SubstructureState:
        """GenEO-substructuring on this object's state (``solve_gevp``);
        the enriched state is stored on self and returned."""
        self.state = solve_gevp(self.state, nu, threshold, feti_deflation,
                                pencil, self.opt)
        return self.state


def solve_gevp(st: SubstructureState, nu: int = 4,
               threshold: Optional[float] = None,
               feti_deflation: bool = False,
               pencil: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               opt: Optional[Options] = None) -> SubstructureState:
    """GenEO-substructuring: the local Schur pencil S_b v = lambda (D S_b D)
    v (``Schur::solveGEVP``, HPDDM_schur.hpp:161-271), smallest-lambda
    traces. The selected vectors enrich BDD's balancing space (appended to
    the Schur kernels, orthonormalized per subdomain) and, with
    ``feti_deflation=True``, FETI's dual space: columns B D v, projected
    into the kernel-constraint complement and deflated F-orthogonally in
    the projected CG. The dense path's eigenvalue list includes the r
    kernel modes, which the enrichment QR discards; the banded path solves
    the pencil matrix-free (``_schur_gevp_lanczos``), its kernel directions
    deflated, so its list starts at the first non-zero eigenvalue (the same
    nu can give a slightly larger coarse space there). ``pencil``: the
    eigenpairs (lam (S, nu), V (S, nb, nu)) computed elsewhere, in place of
    the eigensolver; where the pencil has a degenerate eigenvalue at the
    nu-th place (C20) the selected traces are the eigensolver's choice,
    and a comparison across eigensolvers carries them. In the Chebyshev
    coarse mode the bounds of W^T S W are estimated again on the enriched
    balancing space (``opt`` gives the degree override). Returns the
    enriched state."""
    from hpddm_tpu_torch.precond.geneo import solve_gevp_dense
    dev = st.device
    S, nb = st.bidx.shape
    D = st.scaling
    if pencil is None and st.local_mode == "banded":
        lam, V = _schur_gevp_lanczos(st, nu)
        # zero the padded rows, so that the enrichment QR below builds a
        # basis orthonormal on the valid rows whatever the eigensolver
        # leaves there
        V = torch.where(st.b_mask[:, :, None], V, torch.zeros_like(V))
    elif pencil is None:
        DSD = st.S_b * D[:, :, None] * D[:, None, :]
        lam, V = solve_gevp_dense(st.S_b, DSD, nu)
    else:
        lam, V = (torch.as_tensor(a, dtype=st.S_b.dtype, device=dev)
                  for a in pencil)
    lam_np, V_np = lam.cpu().numpy(), V.cpu().numpy()

    counts = np.full(S, nu, dtype=np.int64)
    if threshold is not None and threshold > 0:
        counts = np.minimum(counts,
                            np.maximum((lam_np < threshold).sum(1), 1))
    # BDD: append to the balancing space, per-subdomain orthonormalized
    # (GenEO traces can be nearly dependent with the Schur kernels)
    old_k = st.sb_r_loc.cpu().numpy()
    new_rmax = max(int((old_k + counts).max()), 1)
    Sb_k = np.zeros((S, nb, new_rmax), dtype=V_np.dtype)
    rank = np.zeros(S, dtype=np.int64)
    Sbk_old = st.Sb_kernels.cpu().numpy()
    for s in range(S):
        M = np.concatenate([Sbk_old[s, :, : old_k[s]],
                            V_np[s, :, : counts[s]]], axis=1)
        if not M.shape[1]:
            continue
        q, r = np.linalg.qr(M)
        keep = np.abs(np.diag(r)) > 1e-8 * max(np.abs(np.diag(r)).max(),
                                               1e-30)
        q = q[:, keep]
        Sb_k[s, :, : q.shape[1]] = q
        rank[s] = q.shape[1]
    G_def = FG_def = GFG_inv = None
    if counts.sum() and feti_deflation:
        # columns B (D v): each lives on one subdomain, so B acts slot by
        # slot (the JAX package's (S, n, nd) block is never formed)
        DV = D[:, :, None] * V[:, :, :int(counts.max())]
        Gx = _traces_jump(st, DV, torch.as_tensor(counts, device=dev))
        # project into the kernel-constraint complement FIRST: the
        # deflation must be F-orthogonal w.r.t. the *projected* operator
        # P F P^T, not F itself
        Gx = feti_project(st, Gx)
        q, r = torch.linalg.qr(Gx)
        dr = torch.abs(torch.diagonal(r))
        keep = dr > 1e-10 * torch.clamp(torch.amax(dr), min=1e-30)
        Gx = q[:, keep]
        if Gx.shape[1]:
            FG = feti_project(st, feti_operator(st, Gx))
            GFG = Gx.mT @ FG
            G_def, FG_def = Gx, FG
            # numpy's pinv: by SVD, cutoff 1e-15 of the largest value
            GFG_inv = torch.linalg.pinv(0.5 * (GFG + GFG.mT), rtol=1e-15)
    st2 = dataclasses.replace(
        st, Sb_kernels=torch.as_tensor(Sb_k, device=dev),
        sb_r_loc=torch.as_tensor(rank, device=dev),
        G_def=G_def, FG_def=FG_def, GFG_inv=GFG_inv)
    if st.coarse_mode == "cheby":
        # the balancing space changed: estimate the W^T S W bounds again
        st2 = _calibrate_coarse(st2, opt if opt is not None else Options())
    return st2


def coarse_projection(kernels, r_loc, kern_off, lam_id, lam_loc, lam_sign,
                      N_l: int, nc: int, mode: str):
    """(G, (G^H G + 1e-14 I)^-1) of the kernel basis: G dense (N_l, nc) in
    ``dense`` mode; in ``mfree`` mode G is None and G^H G is assembled from
    the slots on the host (a sparse product: G itself, the replicated
    N_l x nc memory hog, is never formed); in ``cheby`` mode both are None
    (``_gtg_solve`` runs the Chebyshev solve). Without a floating subdomain
    (nc = 1, no column) G is zero and the inverse the identity."""
    dev, tdt = kernels.device, kernels.dtype
    r_max = kernels.shape[2]
    n_cols = int(r_loc.sum())
    if mode == "cheby" and n_cols:
        return None, None
    # nonzeros of G: (multiplier, column, value) of every slot and kernel
    # column; each (multiplier, column) pair occurs once
    k = torch.arange(r_max, device=dev)[None, None, :]
    valid = (lam_id < N_l)[:, :, None] & (k < r_loc[:, None, None])
    vals = lam_sign[:, :, None] * torch.gather(
        kernels, 1, lam_loc[:, :, None].expand(-1, -1, r_max))
    rows = lam_id[:, :, None].expand_as(vals)
    cols = (kern_off[:, None, None] + k).expand_as(vals)
    eye = torch.eye(nc, dtype=tdt, device=dev)
    if mode == "dense" or not n_cols:
        Gp = torch.zeros((N_l + 1, nc + 1), dtype=tdt, device=dev)
        Gp[torch.where(valid, rows, N_l), torch.where(valid, cols, nc)] = \
            torch.where(valid, vals, torch.zeros_like(vals))
        G = Gp[:N_l, :nc].contiguous()
        GtG = G.mT.conj() @ G + 1e-14 * eye
        return G, (torch.linalg.inv(GtG) if n_cols else eye)
    Gs = sp.csr_matrix((vals[valid].cpu().numpy(),
                        (rows[valid].cpu().numpy(),
                         cols[valid].cpu().numpy())), shape=(N_l, nc))
    GtG = np.asarray((Gs.conj().T @ Gs).todense()) + 1e-14 * np.eye(nc)
    return None, torch.as_tensor(np.linalg.inv(GtG), dtype=tdt, device=dev)


def with_coarse_mode(st: SubstructureState, mode: str,
                     opt: Optional[Options] = None) -> SubstructureState:
    """The state with its coarse projection rebuilt for another mode
    (``dense``, ``mfree`` or ``cheby``, whose bounds are estimated here;
    ``opt`` gives the degree override) on the same local factors."""
    if mode not in ("dense", "mfree", "cheby"):
        raise ValueError(f"unknown substructuring_coarse {mode!r}")
    if int(st.r_loc.sum()) == 0:
        mode = "dense"
    G, GtG_inv = coarse_projection(st.kernels, st.r_loc, st.kern_off,
                                   st.lam_id, st.lam_loc, st.lam_sign,
                                   st.N_l, st.nc, mode)
    st = dataclasses.replace(st, G=G, GtG_inv=GtG_inv, coarse_mode=mode)
    if mode == "cheby":
        st = _calibrate_coarse(st, opt if opt is not None else Options())
    return st


def _traces_jump(st: SubstructureState, X: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """B applied to the columns X[s, :, k] (k < counts[s]) of interface
    traces, each extended by zero to the other subdomains: (N_l, nd),
    columns ordered by subdomain then k. Each (multiplier, column) entry is
    one signed trace value."""
    S, nb, kmax = X.shape
    dev = X.device
    nd = int(counts.sum())
    off = torch.cumsum(counts, 0) - counts
    k = torch.arange(kmax, device=dev)
    col = torch.where(k[None, :] < counts[:, None], off[:, None] + k[None, :],
                      nd)                                           # (S, k)
    out = X.new_zeros((st.N_l + 1, nd + 1))
    # the two copies of each multiplier: (subdomain, interface slot, sign)
    for side, sign in ((0, 1.0), (1, -1.0)):
        pos = st.plan.lam_bpos[:, side]
        s_of = pos // nb
        vals = X.reshape(S * nb, kmax)[pos]                     # (N_l, kmax)
        rows = torch.arange(st.N_l, device=dev)[:, None].expand(-1, kmax)
        cols = col[s_of]
        ok = cols < nd
        out[torch.where(ok, rows, st.N_l), torch.where(ok, cols, nd)] = \
            torch.where(ok, sign * vals, torch.zeros_like(vals))
    return out[: st.N_l, :nd].contiguous()


# ----------------------------------------------------------------------
# Chebyshev solves and their spectral bounds
# ----------------------------------------------------------------------

def _cheb_coefficients(lo: float, hi: float, degree: int, rdt):
    """(1 / theta, [(a_k, b_k)]) of ``_cheb_inverse``, computed on the host
    in the real dtype rdt as the JAX package computes its scan's scalars:
    d_0 = b / theta, then d <- a_k d + b_k r."""
    T = np.dtype(rdt).type
    lo, hi = T(lo), T(hi)
    theta = (hi + lo) / T(2.0)
    delta = max((hi - lo) / T(2.0), T(1e-6) * theta)
    sigma1 = theta / delta
    rho = T(1.0) / sigma1
    steps = []
    for _ in range(int(degree)):
        rho_new = T(1.0) / (T(2.0) * sigma1 - rho)
        steps.append((float(rho_new * rho), float(T(2.0) * rho_new / delta)))
        rho = rho_new
    return float(theta), steps


def _cheb_inverse(matvec, b: torch.Tensor, lo: float, hi: float,
                  degree: int) -> torch.Tensor:
    """Fixed-degree Chebyshev approximation of A^-1 b, spec(A) in [lo, hi]
    (the JAX package's ``_cheb_inverse``). A polynomial in A with fixed
    coefficients is a linear operator, so projections and preconditioners
    built from it keep (projected) CG valid. The coefficients come from
    the host floats lo, hi; the loop reads nothing from the device."""
    theta, steps = _cheb_coefficients(lo, hi, degree,
                                      torch.empty(0, dtype=underlying(
                                          b.dtype)).numpy().dtype)
    x = torch.zeros_like(b)
    r = b
    d = b / theta
    for a_k, b_k in steps:
        x = x + d
        r = r - matvec(d)
        d = a_k * d + b_k * r
    return x + d


def _spd_bounds(matvec, v0: torch.Tensor, its: int = 48):
    """(lmax, lmin) of an SPD operator by power and shifted power iteration
    (device scalars; no host read inside the iterations)."""
    def normalize(v):
        nrm = torch.sqrt(torch.sum(torch.abs(v) ** 2))
        return v / torch.where(nrm > 0, nrm, torch.ones_like(nrm))

    v = normalize(v0)
    lam = None
    for _ in range(its):
        w = matvec(v)
        lam = torch.real(torch.sum(v.conj() * w))
        v = normalize(w)
    hi = lam
    shift = 1.05 * hi
    for _ in range(its):
        w = shift * v - matvec(v)
        lam = torch.real(torch.sum(v.conj() * w))
        v = normalize(w)
    return hi, shift - lam


def _cheb_degree(kappa: float, rdt, override) -> int:
    """Degree reaching about dtype accuracy: 2 rho^k <= 30 eps with
    rho = (sqrt(kappa) - 1) / (sqrt(kappa) + 1), in [8, 128]."""
    if override:
        return int(override)
    eps = 30.0 * float(np.finfo(np.dtype(rdt)).eps)
    if kappa <= 1.0 + 1e-12:
        return 8
    rho = (np.sqrt(kappa) - 1.0) / (np.sqrt(kappa) + 1.0)
    k = int(np.ceil(np.log(2.0 / eps) / -np.log(max(rho, 1e-12))))
    return int(np.clip(k, 8, 128))


def _start_vector(shape, seed: int, dtype, device) -> torch.Tensor:
    """Normal start of a bounds estimate from a seeded CPU generator (the
    same numbers on every device)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(
        device=device, dtype=dtype)


def _clipped_bounds(hi: torch.Tensor, lo: torch.Tensor,
                    fallback: Tuple[float, float]) -> Tuple[float, float]:
    """(lo, hi) host floats of a bounds estimate: hi widened by 5%, lo
    halved and kept in [1e-8 hi, 0.9 hi]; the fallback where hi is not
    positive."""
    h, l_ = float(hi), float(lo)
    if not h > 0:
        h, l_ = fallback
    h *= 1.05
    return float(np.clip(0.5 * l_, 1e-8 * h, 0.9 * h)), h


def _calibrate_sb(st: SubstructureState, opt: Options) -> SubstructureState:
    """Spectral bounds of the kernel-deflated local Schur operator (banded
    local mode): they set the Chebyshev S_b^+ of ``bdd_precond``."""
    rdt = underlying(st.scaling.dtype)
    S, nb = st.bidx.shape

    def P(x):
        return _sb_project(st, _mask_b(st, x))

    def mv0(x):
        return P(_sb_apply(st, P(x)))

    v0 = _start_vector((S, nb, 1), 41, st.scaling.dtype, st.device)
    hi, _ = _spd_bounds(mv0, v0)
    hi_f = float(hi) * 1.05
    if not hi_f > 0:
        hi_f = 1.0

    def mv1(x):
        # the complement (padding and kernel) mapped to hi, so that the
        # shifted power iteration sees only the deflated range's spectrum
        return mv0(x) + hi_f * (x - P(x))

    _, lo = _spd_bounds(mv1, v0)
    lo_f = float(np.clip(0.5 * float(lo), 1e-8 * hi_f, 0.9 * hi_f))
    deg = _cheb_degree(hi_f / lo_f, _np_real(rdt),
                       opt.val("substructuring_local_degree"))
    return dataclasses.replace(st, sb_lo=_rounded(lo_f, rdt),
                               sb_hi=_rounded(hi_f, rdt), sb_degree=deg)


def _calibrate_coarse(st: SubstructureState,
                      opt: Options) -> SubstructureState:
    """Spectral bounds of G^T G and W^T S W and the Chebyshev degrees of
    the coarse solves (at setup, and again after GenEO enrichment)."""
    dtype = st.scaling.dtype
    rdt = underlying(dtype)
    override = opt.val("substructuring_coarse_degree")
    v0 = _start_vector((st.nc, 1), 17, dtype, st.device)
    glo, ghi = _clipped_bounds(*_spd_bounds(
        lambda a: _Gt_apply(st, _G_apply(st, a)), v0), (1.0, 0.9))
    r_max = st.Sb_kernels.shape[2]
    active = _balancing_active(st)
    w0 = _start_vector((st.S_total * r_max, 1), 29, dtype, st.device)
    w0 = torch.where(active[:, None], w0, torch.zeros_like(w0))
    blo, bhi = _clipped_bounds(*_spd_bounds(
        lambda c: _wsw_matvec(st, c, active), w0), (1.0, 0.9))
    nr = _np_real(rdt)
    return dataclasses.replace(
        st, coarse_degree=_cheb_degree(ghi / glo, nr, override),
        bdd_coarse_degree=_cheb_degree(bhi / blo, nr, override),
        gtg_lo=_rounded(glo, rdt), gtg_hi=_rounded(ghi, rdt),
        wsw_lo=_rounded(blo, rdt), wsw_hi=_rounded(bhi, rdt))


def _np_real(rdt: torch.dtype):
    return torch.empty(0, dtype=rdt).numpy().dtype


def _rounded(x: float, rdt: torch.dtype) -> float:
    """x rounded to the real dtype (the JAX package stores its bounds as
    arrays of that dtype)."""
    return float(np.dtype(_np_real(rdt)).type(x))


# ----------------------------------------------------------------------
# local applies: dense factors or matrix-free banded
# ----------------------------------------------------------------------

def _mask_b(st: SubstructureState, x: torch.Tensor) -> torch.Tensor:
    return torch.where(st.b_mask[:, :, None], x, torch.zeros_like(x))


def _gather_b(st: SubstructureState, w: torch.Tensor) -> torch.Tensor:
    vb = torch.gather(w, 1, st.bidx[:, :, None].expand(-1, -1, w.shape[-1]))
    return _mask_b(st, vb)


def _gather_i(st: SubstructureState, w: torch.Tensor) -> torch.Tensor:
    vi = torch.gather(w, 1, st.iidx[:, :, None].expand(-1, -1, w.shape[-1]))
    return torch.where(st.i_mask[:, :, None], vi, torch.zeros_like(vi))


def _full(st: SubstructureState, vb: Optional[torch.Tensor],
          vi: Optional[torch.Tensor]) -> torch.Tensor:
    """(S, n_max, mu) local vectors with the interface values vb (S, nb,
    mu) and the interior values vi (S, ni, mu) written at their dofs
    (either may be None), zero elsewhere (the JAX package's masked
    scatters): index writes with the pads on a drop row, each dof written
    once, so the result is the same in every run."""
    parts = [(v, dst) for v, dst in ((vb, st.plan.b_dst), (vi, st.plan.i_dst))
             if v is not None]
    mu = parts[0][0].shape[-1]
    out = parts[0][0].new_zeros((st.S_total * st.n_max + 1, mu))
    for v, dst in parts:
        out[dst] = v.reshape(-1, mu)
    return out[:-1].view(st.S_total, st.n_max, mu)


def _kernel_project(st: SubstructureState, x: torch.Tensor) -> torch.Tensor:
    """P x = x - Q (Q^H x), Q the orthonormal kernel columns."""
    return x - st.kernels @ (st.kernels.mT.conj() @ x)


def _sb_project(st: SubstructureState, x: torch.Tensor) -> torch.Tensor:
    """x - Z (Z^H x), Z the orthonormal Schur kernels (balancing space)."""
    return x - st.Sb_kernels @ (st.Sb_kernels.mT.conj() @ x)


def _k_pinv_apply(st: SubstructureState, w: torch.Tensor) -> torch.Tensor:
    """K^+ w: the dense pseudo-inverse (one batched product), or in the
    banded mode the projected regularized solve with ``k_refine``
    residual refinements (each damps the regularization error by
    eps / (lambda + eps); the outer projection removes the kernel
    component exactly)."""
    if st.local_mode != "banded":
        return torch.bmm(st.K_pinv, w)
    b = _kernel_project(st, w)
    x = st.Kb.solve(b)
    for _ in range(st.k_refine):
        x = x + st.Kb.solve(b - spmm(st.A_loc, x))
    return _kernel_project(st, x)


def _kii_solve(st: SubstructureState, y: torch.Tensor) -> torch.Tensor:
    """K_ii^-1 y on interior vectors (iidx order)."""
    if st.local_mode != "banded":
        return torch.bmm(st.Kii_inv, y)
    return st.Kiib.solve(y)


def _kbi_apply(st: SubstructureState, ui: torch.Tensor) -> torch.Tensor:
    """K_bi u_i (banded: one local SpMV of the zero-extended u_i)."""
    if st.local_mode != "banded":
        return torch.bmm(st.K_bi, ui)
    return _gather_b(st, spmm(st.A_loc, _full(st, None, ui)))


def _kib_apply(st: SubstructureState, ub: torch.Tensor) -> torch.Tensor:
    """K_ib u_b = K_bi^T u_b (structurally symmetric local matrices)."""
    if st.local_mode != "banded":
        return torch.bmm(st.K_bi.mT, ub)
    return _gather_i(st, spmm(st.A_loc, _full(st, ub, None)))


def _sb_apply(st: SubstructureState, vb: torch.Tensor) -> torch.Tensor:
    """S_b v = K_bb v - K_bi K_ii^-1 K_ib v: the dense block, or in the
    banded mode two local SpMVs and one interior solve
    (``applyLocalSchurComplement``'s implicit variant,
    HPDDM_schur.hpp:600-643)."""
    if st.local_mode != "banded":
        return torch.bmm(st.S_b, vb)
    w = spmm(st.A_loc, _full(st, vb, None))
    z = st.Kiib.solve(_gather_i(st, w))
    v2 = spmm(st.A_loc, _full(st, None, z))
    return _gather_b(st, w) - _gather_b(st, v2)


def _sb_pinv_apply(st: SubstructureState, z: torch.Tensor) -> torch.Tensor:
    """S_b^+ z: the dense pseudo-inverse, or in the banded mode the
    fixed-degree Chebyshev polynomial of the kernel-deflated implicit
    S_b (a linear operator, so the BDD CG stays valid)."""
    if st.local_mode != "banded":
        return torch.bmm(st.S_b_pinv, z)

    def mv(x):
        return _sb_project(st, _sb_apply(st, _sb_project(st, x)))

    return _sb_project(st, _cheb_inverse(mv, _sb_project(st, z), st.sb_lo,
                                         st.sb_hi, st.sb_degree))


def _schur_gevp_lanczos(st: SubstructureState, nu: int,
                        ncv: Optional[int] = None, passes: int = 3,
                        seed: int = 0):
    """The GenEO-substructuring pencil S_b v = lambda (D S_b D) v solved
    matrix-free (the banded mode's ``Schur::solveGEVP``,
    HPDDM_schur.hpp:161-271): shift-invert Lanczos
    (``geneo.solve_gevp_lanczos``) on A^-1 B with B x = D S_b (D x) and
    A^-1 the kernel-projected Chebyshev S_b^+ polished by ``passes``
    preconditioned Richardson refinements. The kernel directions are
    projected out, so the eigenvalues start at the first non-zero one.
    Returns (lam (S, nu), V (S, nb, nu))."""
    from hpddm_tpu_torch.precond.geneo import solve_gevp_lanczos
    S, nb = st.bidx.shape
    sc = st.scaling[:, :, None]

    def proj(x):
        return _sb_project(st, _mask_b(st, x))

    def mv(x):
        return proj(_sb_apply(st, proj(x)))

    def prec(r):
        return proj(_cheb_inverse(mv, r, st.sb_lo, st.sb_hi, st.sb_degree))

    def apply_B(x):
        return sc * _sb_apply(st, sc * _mask_b(st, x))

    def apply_Ainv(z):
        b = proj(z)
        x = prec(b)
        for _ in range(passes):
            x = x + prec(b - mv(x))
        return proj(x)

    return solve_gevp_lanczos(apply_Ainv, apply_B, S, nb, nu, ncv=ncv,
                              seed=seed, dtype=st.scaling.dtype,
                              device=st.device)


# ----------------------------------------------------------------------
# FETI runtime (pure functions)
# ----------------------------------------------------------------------

def _bt_b(st: SubstructureState, lam: torch.Tensor) -> torch.Tensor:
    """B^T lambda on the interface: (N_l, mu) -> (S, nb, mu), each dof the
    sum of its signed multipliers in slot order (zero on padding)."""
    mu = lam.shape[-1]
    ext = torch.cat([lam, -lam, lam.new_zeros((1, mu))])
    vals = ext[st.plan.bt_idx]                               # (S, nb, P, mu)
    acc = vals[:, :, 0]
    for p in range(1, vals.shape[2]):
        acc = acc + vals[:, :, p]
    return acc


def bt_apply(st: SubstructureState, lam: torch.Tensor) -> torch.Tensor:
    """B^T lambda: expand multipliers to signed subdomain traces.
    lam: (N_l, mu) -> (S, n_max, mu)."""
    return _full(st, _bt_b(st, lam), None)


def b_apply(st: SubstructureState, u: torch.Tensor) -> torch.Tensor:
    """B u: signed jumps across interfaces. u: (S, n_max, mu) -> (N_l, mu);
    each multiplier reads its + copy and subtracts its - copy."""
    flat = u.reshape(-1, u.shape[-1])
    return flat[st.plan.lam_pos[:, 0]] - flat[st.plan.lam_pos[:, 1]]


def _b_apply_b(st: SubstructureState, ub: torch.Tensor) -> torch.Tensor:
    """B of a vector supported on the interface, given there (S, nb, mu)."""
    flat = ub.reshape(-1, ub.shape[-1])
    return flat[st.plan.lam_bpos[:, 0]] - flat[st.plan.lam_bpos[:, 1]]


def feti_operator(st: SubstructureState, lam: torch.Tensor) -> torch.Tensor:
    """F lambda = B K^+ B^T lambda (Feti::A, HPDDM_FETI.hpp:63-87)."""
    return b_apply(st, _k_pinv_apply(st, bt_apply(st, lam)))


def feti_precond(st: SubstructureState, lam: torch.Tensor,
                 variant: str = "dirichlet") -> torch.Tensor:
    """Scaled Dirichlet, lumped, superlumped or no preconditioner
    (Feti::applyLocalPreconditioner, HPDDM_FETI.hpp:271-312;
    FetiPrcndtnr, HPDDM_enum.hpp:39-44)."""
    if variant == "none":
        return lam
    sc = st.scaling[:, :, None]
    vb = sc * _bt_b(st, lam)
    if variant == "superlumped":
        yb = torch.diagonal(st.K_bb, dim1=1, dim2=2)[:, :, None] * vb
    elif variant == "lumped":
        yb = torch.bmm(st.K_bb, vb)
    else:
        yb = _sb_apply(st, vb)
    yb = sc * yb
    yb = torch.where(st.b_mask[:, :, None], yb, torch.zeros_like(yb))
    return _b_apply_b(st, yb)


def _kernel_dots(st: SubstructureState, f: torch.Tensor) -> torch.Tensor:
    """e[(s, k)] = kernels_s[:, k]^H f_s -> (nc, mu), ordered like the
    columns of G."""
    local = st.kernels.mT.conj() @ f                        # (S, r_max, mu)
    mu = f.shape[-1]
    ext = torch.cat([local.reshape(-1, mu), f.new_zeros((1, mu))])
    return ext[st.plan.kern_col]


def _kernel_expand(st: SubstructureState, alpha: torch.Tensor) -> torch.Tensor:
    """R alpha with the same (s, k) column ordering: (nc, mu) -> (S, n, mu)."""
    mu = alpha.shape[-1]
    ext = torch.cat([alpha, alpha.new_zeros((1, mu))])
    return torch.bmm(st.kernels, ext[st.plan.kern_src])


def _G_apply(st: SubstructureState, alpha: torch.Tensor) -> torch.Tensor:
    """G alpha = B (R alpha): dense when materialized, else matrix-free."""
    if st.G is not None:
        return st.G @ alpha
    return b_apply(st, _kernel_expand(st, alpha))


def _Gt_apply(st: SubstructureState, lam: torch.Tensor) -> torch.Tensor:
    """G^H lambda = R^H (B^T lambda)."""
    if st.G is not None:
        return st.G.mT.conj() @ lam
    return _kernel_dots(st, bt_apply(st, lam))


def _gtg_solve(st: SubstructureState, rhs: torch.Tensor) -> torch.Tensor:
    """(G^H G)^-1 rhs: the exact small inverse (dense and mfree modes) or
    the fixed-degree Chebyshev solve (cheby mode)."""
    if st.GtG_inv is not None:
        return st.GtG_inv @ rhs
    return _cheb_inverse(lambda a: _Gt_apply(st, _G_apply(st, a)), rhs,
                         st.gtg_lo, st.gtg_hi, st.coarse_degree)


def feti_project(st: SubstructureState, lam: torch.Tensor) -> torch.Tensor:
    """P lambda = lambda - G (G^T G)^-1 G^T lambda (Q = I)."""
    return lam - _G_apply(st, _gtg_solve(st, _Gt_apply(st, lam)))


class FetiResult(NamedTuple):
    u: torch.Tensor          # (S, n, mu) primal solution (consistent)
    lam: torch.Tensor
    iterations: int
    rel_res: torch.Tensor


def _colsum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.conj() * y, dim=0)


def feti_solve(st: SubstructureState, f: torch.Tensor, tol: float = 1.0e-8,
               max_it: int = 200, precond: str = "dirichlet") -> FetiResult:
    """Projected PCG on the dual interface problem
    (IterativeMethod::PCG, HPDDM_CG.hpp:486-580; Feti::start,
    HPDDM_FETI.hpp:142-184). f: (S, n_max, mu)."""
    mu = f.shape[-1]
    rdt = underlying(f.dtype)

    # dual RHS d = B K^+ f ; compatibility e = R^T f
    d = b_apply(st, _k_pinv_apply(st, f))
    e = _kernel_dots(st, f)
    lam = _G_apply(st, _gtg_solve(st, e))
    defl = st.G_def is not None
    if defl:
        # deflation initialization on the constraint-projected residual
        r_tmp = feti_project(st, d - feti_operator(st, lam))
        lam = lam + st.G_def @ (st.GFG_inv @ (st.G_def.mT.conj() @ r_tmp))
    r = feti_project(st, d - feti_operator(st, lam))
    norm = torch.sqrt(torch.sum(torch.abs(r) ** 2, dim=0)).to(rdt)
    norm = torch.where(norm > 0, norm, torch.ones_like(norm))

    def prec(r):
        z = feti_project(st, feti_precond(st, r, precond))
        if defl:
            # keep search directions F-orthogonal to the deflation space
            z = z - st.G_def @ (st.GFG_inv @ (st.FG_def.mT.conj() @ z))
        return z

    p = prec(r)
    rz = _colsum(r, p)
    res = torch.full((mu,), float("inf"), dtype=rdt, device=f.device)
    it = 1
    while it <= max_it and bool((res > tol).any()):
        q = feti_project(st, feti_operator(st, p))
        pq = _colsum(p, q)
        alpha = rz / torch.where(torch.abs(pq) > 0, pq, torch.ones_like(pq))
        lam = lam + alpha[None, :] * p
        r = r - alpha[None, :] * q
        z = prec(r)
        rz_new = _colsum(r, z)
        beta = rz_new / torch.where(torch.abs(rz) > 0, rz,
                                    torch.ones_like(rz))
        p = z + beta[None, :] * p
        rz = rz_new
        res = (torch.sqrt(torch.sum(torch.abs(r) ** 2, dim=0)) / norm).to(rdt)
        it += 1

    # primal recovery (Feti::computeSolution, HPDDM_FETI.hpp:396-425):
    # only the kernel columns of G set the floating-mode amplitudes; the
    # GenEO columns are projection-only
    u = _k_pinv_apply(st, f - bt_apply(st, lam))
    alpha = -_gtg_solve(st, _Gt_apply(st, b_apply(st, u)))
    u = u + _kernel_expand(st, alpha)
    return FetiResult(u=u, lam=lam, iterations=it - 1, rel_res=res)


# ----------------------------------------------------------------------
# BDD runtime
# ----------------------------------------------------------------------

def _balancing_cols(st: SubstructureState) -> torch.Tensor:
    """(S, r_max) balancing-column ids sub_gid * r_max + k."""
    r_max = st.Sb_kernels.shape[2]
    return (st.sub_gid[:, None] * r_max
            + torch.arange(r_max, device=st.device)[None, :])


def _balancing_apply(st: SubstructureState, c: torch.Tensor) -> torch.Tensor:
    """W c without forming W: exchange(D Sb_kernels c) -> consistent.
    c: (ncb, mu) indexed by balancing columns."""
    W0 = st.scaling[:, :, None] * st.Sb_kernels
    return exchange(st.dec_b, torch.bmm(W0, c[_balancing_cols(st)]))


def _balancing_dots(st: SubstructureState, y: torch.Tensor) -> torch.Tensor:
    """W^T D y for consistent interface vectors y: a local product (each
    balancing column lives on one subdomain and the copies' weights sum
    to 1), laid out as (ncb, mu). The columns s * r_max + k cover 0..ncb-1
    once each, so the layout is a reshape."""
    W0 = st.scaling[:, :, None] * st.Sb_kernels
    loc = W0.mT.conj() @ y                                  # (S, r_max, mu)
    return loc.reshape(-1, y.shape[-1])


def _balancing_active(st: SubstructureState) -> torch.Tensor:
    """(ncb,) bool: which balancing columns exist."""
    r_max = st.Sb_kernels.shape[2]
    act = (torch.arange(r_max, device=st.device)[None, :]
           < st.sb_r_loc[:, None])
    return act.reshape(-1)


def _wsw_matvec(st: SubstructureState, c: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """(W^T S W) c, the identity on the inactive balancing columns."""
    y = bdd_operator(st, _balancing_apply(st, c))
    return torch.where(active[:, None], _balancing_dots(st, y), c)


def bdd_operator(st: SubstructureState, ub: torch.Tensor) -> torch.Tensor:
    """Global Schur action on consistent interface vectors:
    sum R^T S_s R u (Bdd::apply, HPDDM_BDD.hpp:151-160)."""
    return exchange(st.dec_b, _sb_apply(st, ub))


def bdd_precond(st: SubstructureState, r: torch.Tensor) -> torch.Tensor:
    """Neumann-Neumann: sum R^T D S_s^+ D R r (Bdd::precond)."""
    sc = st.scaling[:, :, None]
    return exchange(st.dec_b, sc * _sb_pinv_apply(st, sc * r))


class BddResult(NamedTuple):
    u: torch.Tensor          # (S, n, mu) primal solution on full dofs
    iterations: int
    rel_res: torch.Tensor


def _pinv_sym(M: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of the Hermitian part of M as ``jnp.linalg.pinv``
    computes it: by SVD, at its default cutoff (10 max(m, n) eps of the
    largest singular value). The SVD, not an eigh: near the cutoff the two
    keep different directions, and the enriched BDD count follows them."""
    n = M.shape[-1]
    eps = torch.finfo(underlying(M.dtype)).eps
    return torch.linalg.pinv(0.5 * (M + M.mT.conj()), rtol=10 * n * eps)


def bdd_solve(st: SubstructureState, f: torch.Tensor, tol: float = 1.0e-8,
              max_it: int = 200) -> BddResult:
    """Balanced Neumann-Neumann on the interface: deflated CG with the
    local-Schur-kernel coarse space (the balancing of BDD), then interior
    recovery u_i = K_ii^-1 (f_i - K_ib u_b). f: (S, n_max, mu)."""
    mu = f.shape[-1]
    rdt = underlying(f.dtype)
    S, nb = st.bidx.shape

    # condensed RHS g = exchange(f_b - K_bi K_ii^-1 f_i)
    # (Schur::condensateEffort, HPDDM_schur.hpp:724)
    fi = _gather_i(st, f)
    g = exchange(st.dec_b, _gather_b(st, f) - _kbi_apply(st, _kii_solve(st,
                                                                        fi)))

    # balancing coarse space: columns W^(s,k) = exchange(D_s Sb_kernel)
    r_max = st.Sb_kernels.shape[2]
    ncb = st.S_total * r_max
    active = _balancing_active(st)
    both = active[:, None] & active[None, :]
    dw = st.dec_b.d[:, :, None]
    eye = torch.eye(ncb, dtype=f.dtype, device=f.device)
    zero = f.new_zeros(())

    if st.coarse_mode == "cheby":
        # matrix-free: W never formed, (W^T S W)^-1 by the fixed-degree
        # Chebyshev polynomial on the setup's bounds
        def coarse(r):
            rhs = torch.where(active[:, None], _balancing_dots(st, r), zero)
            c = _cheb_inverse(lambda x: _wsw_matvec(st, x, active), rhs,
                              st.wsw_lo, st.wsw_hi, st.bdd_coarse_degree)
            return _balancing_apply(st, torch.where(active[:, None], c,
                                                    zero))
    elif st.coarse_mode == "mfree":
        # exact W^T S W from chunked matrix-free applies: W ((S, nb, ncb),
        # quadratic in the subdomain count) is never formed
        chunk = min(128, ncb)
        blocks = [_balancing_dots(st, bdd_operator(st, _balancing_apply(
            st, eye[:, c0: c0 + chunk]))) for c0 in range(0, ncb, chunk)]
        WtSW_inv = _pinv_sym(torch.where(both, torch.cat(blocks, dim=1),
                                         eye))
        del blocks

        def coarse(r):
            c = WtSW_inv @ torch.where(active[:, None],
                                       _balancing_dots(st, r), zero)
            return _balancing_apply(st, c)
    else:
        W0 = st.scaling[:, :, None] * st.Sb_kernels          # (S, nb, r)
        Wg = f.new_zeros((S, nb, S, r_max))
        ar = torch.arange(S, device=f.device)
        Wg[ar, :, ar, :] = W0
        W = exchange(st.dec_b, Wg.reshape(S, nb, ncb))      # consistent cols
        del Wg
        Wf = W.reshape(S * nb, ncb)

        def wdot(y):
            """consistent-vector dots: W^H D y -> (ncb, mu)."""
            return Wf.mT.conj() @ (dw * y).reshape(S * nb, -1)

        WtSW_inv = _pinv_sym(torch.where(both, wdot(bdd_operator(st, W)),
                                         eye))

        def coarse(r):
            c = WtSW_inv @ torch.where(active[:, None], wdot(r), zero)
            return (Wf @ c).reshape(S, nb, -1)

    def vdot(x, y):
        return torch.sum(x.conj() * (dw * y), dim=(0, 1))

    u = coarse(g)
    r = g - bdd_operator(st, u)

    def prec(r):
        z = bdd_precond(st, r)
        # balance: z <- z - W (W^T S W)^-1 W^T S z
        return z - coarse(bdd_operator(st, z))

    norm = torch.sqrt(torch.abs(vdot(g, g))).to(rdt)
    norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    p = prec(r)
    rz = vdot(r, p)
    res = torch.full((mu,), float("inf"), dtype=rdt, device=f.device)
    it = 1
    while it <= max_it and bool((res > tol).any()):
        q = bdd_operator(st, p)
        pq = vdot(p, q)
        alpha = rz / torch.where(torch.abs(pq) > 0, pq, torch.ones_like(pq))
        u = u + alpha[None, None, :] * p
        r = r - alpha[None, None, :] * q
        z = prec(r)
        rz_new = vdot(r, z)
        beta = rz_new / torch.where(torch.abs(rz) > 0, rz,
                                    torch.ones_like(rz))
        p = z + beta[None, None, :] * p
        rz = rz_new
        res = (torch.sqrt(torch.abs(vdot(r, r))) / norm).to(rdt)
        it += 1

    # interior recovery on the full local numbering:
    # u_i = K_ii^-1 (f_i - K_ib u_b)  (originalNumbering analogue)
    ui = _kii_solve(st, fi - _kib_apply(st, u))
    return BddResult(u=_full(st, u, ui), iterations=it - 1, rel_res=res)
