"""Overlapping Schwarz preconditioners with multilevel coarse solves.

Counterpart of ``hpddm_tpu/precond/schwarz.py``. The preconditioner state
is a small dataclass of batched tensors (leading axis = subdomains) and the
runtime methods are plain functions over it:

* ``apply``: M^-1 with the variants RAS/ASM/ORAS/SORAS/none
  (HPDDM_schwarz.hpp:527-612) and the deflated/additive/balanced coarse
  corrections,
* ``gmv``: global SpMV = local SpMM + POU-scaled sum-exchange
  (HPDDM_schwarz.hpp:726-747); a panel of right-hand sides on a canvas
  grid operator runs with the right-hand-side axis leading,
* ``deflation``: coarse correction Z E^-1 Z^T D x (HPDDM_schwarz.hpp:
  1602-1622) with the coarse solve of the JAX package's three modes: a
  replicated direct solve with the inverse of E = Z^T A Z (``direct``),
  a nested Krylov solve on the dense E (``iterative``) or on its
  neighbour blocks (``bsr``), with a level-3 aggregate deflation and
  levels 4+ (the reference's InexactCoarseOperator recursion,
  HPDDM_inexact_coarse_operator.hpp:741-778,1328),
* ``compute_residual``: independent residual recomputation
  (HPDDM_schwarz.hpp:761-803).

``Schwarz`` is the setup: decomposition, DIA or ELL packing (with the
one-pass exchange plan for ELL operators), the grid slab exchange and
canvas annotation of ``set_grid_geometry``, GenEO (the dense pencil, or
shift-invert Lanczos with banded or ``inv``-preconditioned inner solves),
``inv``, ``lu``, ``chol``, ``qr`` or banded (block-tridiagonal, on grid
boxes or through RCM) local factors, of the user's optimized matrices
(``optimized_mats``) for oras/soras/osm, real or complex128, and the
Galerkin coarse operator, assembled dense or
neighbour-block-sparse, inverted for a replicated direct solve or kept
for the nested solves of the level-2 options (``level_2_*``, ``level_3_*``
and ``level_4+``). Slice 5a: the interface-first layout
(``renumber=True``: every setup path reads the matrices through
``_permuted``), the reuse of a factorization with ``update_matrices``
(``-hpddm_reuse_preconditioner``), ``exchange_matrices``,
``restriction``, ``statistics``, ``-hpddm_geneo_estimate_nu``, the dumps
(``dump_matrices``, ``dump_eigenvectors``,
``-hpddm_level_2_dump_matrix``) and the bf16 value mirror of the
operator product (``-hpddm_gmv_dtype bfloat16``). Slice 5d: the DST
(``fft``) and Chebyshev (``cheby``, ``dst_cheby``) local solvers of
ops/fft_solve.py and ops/cheby_solve.py, and their Lanczos GenEO inner
solves; they take real matrices only (``TypeError``, ROADMAP C16). It
puts everything on the card unless the caller passes ``device="cpu"``.
Complex64 matrices raise ``TypeError`` (ROADMAP C11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.core.formats import (BatchedDIA, BatchedELL,
                                          batched_dense_from,
                                          pack_local_matrices)
from hpddm_tpu_torch.device import DEFAULT, as_device, synchronize
from hpddm_tpu_torch.dtypes import HPDDM_EPS, HPDDM_PEN, as_torch_dtype
from hpddm_tpu_torch.ops.banded_solve import (BandedSolver,
                                              build_banded_solver,
                                              build_banded_solver_rcm)
from hpddm_tpu_torch.ops.cheby_solve import (ChebyLocalSolver, JacobiSolver,
                                             _extract_dinv,
                                             build_cheby_solver, with_dtype)
from hpddm_tpu_torch.ops.fft_solve import build_fft_solver
from hpddm_tpu_torch.ops.local_solve import (KINDS, LocalSolver,
                                             factor_parts, invert, promoted)
from hpddm_tpu_torch.ops.spmv import dia_canvas_moves, spmm, spmm_muT
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel.decomposition import (Decomposition,
                                                    restrict_pou)
from hpddm_tpu_torch.parallel.grid import (build_grid_plan,
                                           grid_exchange_muT)
from hpddm_tpu_torch.parallel.ops import exchange, scaled_exchange
from hpddm_tpu_torch.parallel.pexchange import build_plan
from hpddm_tpu_torch.solvers.base import LinearOperator
from hpddm_tpu_torch.solvers.cg import cg
from hpddm_tpu_torch.solvers.gmres import gmres

# dense Galerkin assembly memory cap: above it the coarse operator is
# assembled block-sparse unless coarse_assembly=dense was asked for
_DENSE_COARSE_BYTES_CAP = 2 << 30


def _is_herm(m: MatrixCSR) -> bool:
    """A local matrix equal to its conjugate transpose, entry for entry."""
    c = m.scipy(expand=True).tocsr()
    d = (c - c.conj().T).tocoo()
    return d.nnz == 0 or not np.any(d.data != 0)


@dataclasses.dataclass(frozen=True)
class CoarseState:
    """Two-level (GenEO or user) coarse-space state (the JAX package's
    ``CoarseState``, ``hpddm_tpu/precond/schwarz.py:59-145``).

    mode ``direct``: E_inv holds the inverse of E (the analogue of a
    main-process direct factorization, HPDDM_coarse_operator_impl.hpp:1630).
    mode ``iterative``: E is kept dense and each coarse solve is a nested
    Krylov solve with the level-2 options, preconditioned by the
    block-Jacobi inverse E_inv, by overlapping neighbour blocks
    (Eloc_inv, loc_idx) or by nothing, plus the level-3 correction
    (HPDDM_inexact_coarse_operator.hpp:741-778). mode ``bsr``: only E's
    diagonal and neighbour blocks are kept (Eb_diag, Eb_nbr; the
    reference's sparsity pattern 's', HPDDM_operator.hpp:378-562) and the
    nested solve runs on them, E_inv is None. Level 3 (``lvl3``): direct
    (E2_inv the inverse of E2 = Z2^H E Z2), ``cg`` (E2_inv its Jacobi
    inverse, a Jacobi CG deflated by levels 4+, the ``chain_*`` tuples)
    or ``none``.

    ``its_log``: a list the nested solves append their iteration counts
    to, where the caller sets one (``dataclasses.replace``); None by
    default."""
    Z: torch.Tensor               # (S, n_max, nu_max) local deflation vectors
    # (N_c, N_c) inverse (direct) or block-Jacobi inverse (iterative);
    # None (bsr)
    E_inv: Optional[torch.Tensor]
    nu_loc: torch.Tensor          # (S,) int32, actual nu per subdomain
    nu_max: int
    correction: str               # 'deflated' | 'additive' | 'balanced'
    mode: str = "direct"          # 'direct' | 'iterative' | 'bsr'
    E: Optional[torch.Tensor] = None   # (N_c, N_c) coarse matrix (iterative)
    inner_tol: float = 1.0e-2
    inner_max_it: int = 50
    method: str = "cg"            # level-2 Krylov method: 'cg' | 'gmres'
    restart: int = 30
    prec: str = "bj"              # 'bj' | 'ras' | 'asm' | 'none'
    lvl3: str = "direct"          # 'direct' | 'cg' | 'none'
    l3_tol: float = 1.0e-2
    l3_max_it: int = 20
    E2_inv: Optional[torch.Tensor] = None   # (n3, n3)
    Z2: Optional[torch.Tensor] = None       # (N_c, n3) basis (iterative)
    E2: Optional[torch.Tensor] = None       # (n3, n3), lvl3 'cg' only
    Eloc_inv: Optional[torch.Tensor] = None  # (S, L, L) overlapping blocks
    loc_idx: Optional[torch.Tensor] = None   # (S, L) coarse rows (iterative)
    agg_oh: Optional[torch.Tensor] = None    # (S, nu_max, n3) basis (bsr)
    Eb_diag: Optional[torch.Tensor] = None      # (S, nu, nu)
    Eb_nbr: Optional[torch.Tensor] = None       # (S, K, nu, nu)
    Eb_diag_inv: Optional[torch.Tensor] = None  # (S, nu, nu) block Jacobi
    # (S, K) int64 neighbour subdomain of each block column, S where a
    # subdomain has fewer than K neighbours: the gather index of the JAX
    # package's one-hot ``nbr_oh`` (S, K, S+1), see ``_coarse_solve_bsr``
    nbr_idx: Optional[torch.Tensor] = None
    # levels 4+: entry j belongs to level 4+j (``Schwarz._build_chain``)
    chain_Z: tuple = ()
    chain_E: tuple = ()
    chain_inv: tuple = ()
    chain_modes: tuple = ()
    chain_tols: tuple = ()
    chain_max_its: tuple = ()
    its_log: Optional[list] = None

    @property
    def N_c(self) -> int:
        """The coarse size S * nu_max, whatever the mode."""
        return self.Z.shape[0] * self.nu_max


@dataclasses.dataclass(frozen=True)
class SchwarzState:
    dec: Decomposition
    A: object                     # batched local matrices (DIA/ELL/Dense)
    # LocalSolver, BandedSolver, a DST solver (ops/fft_solve.py) or
    # ChebyLocalSolver: each has solve(b (S, n_max, mu))
    solver: object
    coarse: Optional[CoarseState]
    variant: str                  # 'ras' | 'asm' | 'oras' | 'soras' | 'osm' | 'none'
    # Dirichlet boundary-condition values per row (Subdomain::boundaryCond,
    # HPDDM_subdomain.hpp:310-336): a_ii on detected boundary rows, 0
    # elsewhere; None when there are none. `start` seeds x0 from it.
    bc: Optional[torch.Tensor] = None


# ----------------------------------------------------------------------
# Runtime (plain functions over SchwarzState)
# ----------------------------------------------------------------------

def gmv(state: SchwarzState, x: torch.Tensor) -> torch.Tensor:
    """Global SpMV on a consistent input: local SpMM then scaled exchange.

    Correct because the POU vanishes on each subdomain's artificial
    boundary, exactly where the local rows are incomplete
    (HPDDM_schwarz.hpp:726-747).

    A panel (mu > 1) on a canvas DIA operator with the slab exchange runs
    with the right-hand-side axis leading, as the JAX package's multi-RHS
    grid branch (``hpddm_tpu/precond/schwarz.py:169-216``): the SpMM on the
    (S, mu, n) panel (``spmm_muT``: B3 on the card), the POU scaling, the
    mu-leading slab exchange (``grid_exchange_muT``), one transpose in and
    one out. The values are the trailing-mu path's: the same products and
    sums per right-hand side. The JAX package's gate between this fused
    form and its per-group ``_scan`` forms works around a TPU register
    spill keyed on an environment variable; B3 reads the panel once for
    every mu, so the port keeps no gate (ROADMAP, queue C, C2)."""
    A, dec = state.A, state.dec
    if (x.shape[-1] > 1 and isinstance(A, BatchedDIA)
            and A.canvas_hw is not None and dec.grid is not None
            and dia_canvas_moves(A.offsets, A.canvas_hw[1]) is not None):
        yT = spmm_muT(A, x.transpose(1, 2)) * dec.d[:, None, :]
        return grid_exchange_muT(dec.grid, yT).transpose(1, 2).contiguous()
    return scaled_exchange(dec, spmm(A, x))


def one_level_apply(state: SchwarzState, x: torch.Tensor) -> torch.Tensor:
    """One-level M^-1 (HPDDM_schwarz.hpp:532-546)."""
    dec = state.dec
    v = state.variant
    if v == "none":
        return x
    if v in ("ras", "oras"):
        return scaled_exchange(dec, state.solver.solve(x))   # sum R^T D A^-1 x
    if v == "soras":
        out = state.solver.solve(dec.d[:, :, None] * x)
        return exchange(dec, dec.d[:, :, None] * out)       # sum R^T D A^-1 D x
    return exchange(dec, state.solver.solve(x))             # asm / osm


def _defl_jacobi_cg(E: torch.Tensor, Jinv: torch.Tensor, rc: torch.Tensor,
                    tol: float, max_it: int, defl) -> torch.Tensor:
    """Jacobi-preconditioned CG on E w = rc (rc: (n, mu)), deflated by
    ``defl = (Z_next, solve_next)`` when given: the preconditioner is then
    Jinv + Z_next solve_next(Z_next^H r), the next coarser level's
    correction. The recursion unit of the level-N chain
    (``hpddm_tpu/precond/schwarz.py:283-321``); its ``while_loop`` is a
    Python loop with one host read per iteration."""
    def prec(r):
        z = Jinv @ r
        if defl is not None:
            Zn, slv = defl
            z = z + Zn @ slv(Zn.conj().T @ r)
        return z

    def dot(a, b):
        return torch.sum(a.conj() * b, dim=0)

    def colnorm(v):
        return torch.sqrt(dot(v, v).real)

    one = torch.ones((), dtype=rc.dtype, device=rc.device)
    norm = colnorm(rc)
    norm = torch.where(norm > 0, norm, one.real)
    w = torch.zeros_like(rc)
    r = rc
    p = prec(rc)
    rz = dot(rc, p)
    it = 0
    while it < max_it and bool(torch.any(colnorm(r) / norm > tol)):
        Ep = E @ p
        pq = dot(p, Ep)
        alpha = rz / torch.where(torch.abs(pq) > 0, pq, one)
        w = w + alpha * p
        r = r - alpha * Ep
        z = prec(r)
        rz_new = dot(r, z)
        p = z + (rz_new / torch.where(torch.abs(rz) > 0, rz, one)) * p
        rz = rz_new
        it += 1
    return w


def _solve_chain(co: CoarseState, j: int, rc: torch.Tensor) -> torch.Tensor:
    """Solve the level-(4+j) system chain_E[j] w = rc, recursing down the
    chain."""
    if co.chain_modes[j] == "direct":
        return co.chain_inv[j] @ rc
    defl = None
    if j + 1 < len(co.chain_modes):
        defl = (co.chain_Z[j + 1], lambda r: _solve_chain(co, j + 1, r))
    return _defl_jacobi_cg(co.chain_E[j], co.chain_inv[j], rc,
                           co.chain_tols[j], co.chain_max_its[j], defl)


def _solve_level3(co: CoarseState, rc: torch.Tensor) -> torch.Tensor:
    """Solve the level-3 aggregate system E2 w = rc (rc: (n3, mu)):
    ``direct`` with the prefactorized inverse, ``cg`` with the Jacobi CG
    of the level-3 options, deflated by levels 4+ where they are set
    (buildThree, HPDDM_inexact_coarse_operator.hpp:741-778,1328)."""
    if co.lvl3 == "direct":
        return co.E2_inv @ rc
    defl = None
    if len(co.chain_modes):
        defl = (co.chain_Z[0], lambda r: _solve_chain(co, 0, r))
    return _defl_jacobi_cg(co.E2, co.E2_inv, rc, co.l3_tol, co.l3_max_it,
                           defl)


def _nested_krylov(co: CoarseState, op: LinearOperator, b: torch.Tensor):
    """The level-2 solve through the port's own Krylov stack with the
    level-2 options: (x, iterations). The count goes to ``co.its_log``
    where one is set."""
    if co.method == "gmres":
        res = gmres(op, b, tol=co.inner_tol, restart=co.restart,
                    max_it=co.inner_max_it)
    else:
        res = cg(op, b, tol=co.inner_tol, max_it=co.inner_max_it)
    if co.its_log is not None:
        co.its_log.append(res.iterations)
    return res.x, res.iterations


def _coarse_solve(co: CoarseState, c: torch.Tensor,
                  return_its: bool = False):
    """Solve E y = c (c: (N_c, mu)) on the replicated coarse problem.

    ``direct``: one small matmul with the prefactorized inverse.
    ``iterative``: the nested solve of ``_nested_krylov`` on a (1, N_c,
    mu) panel with no weight, preconditioned by the block-Jacobi inverse,
    the overlapping neighbour blocks (``ras``: each block keeps its own
    rows; ``asm``: the blocks' solutions added where they overlap) or
    nothing, plus the level-3 correction Z2 E2^-1 Z2^H r
    (``hpddm_tpu/precond/schwarz.py:353-408``). With ``return_its``:
    (y, inner iterations), 0 for a direct solve."""
    anchor = co.E_inv if co.E_inv is not None else co.E
    cd = c.to(anchor.dtype)
    if co.mode == "direct":
        y = co.E_inv @ cd
        return (y, 0) if return_its else y
    E = co.E
    N_c, mu = cd.shape

    def prec3(r):
        if co.prec == "none":
            z = r
        elif co.prec in ("ras", "asm"):
            rp = torch.cat([r, r.new_zeros((1, mu))])
            zl = torch.bmm(co.Eloc_inv, rp[co.loc_idx])      # (S, L, mu)
            if co.prec == "ras":
                z = zl[:, : co.nu_max, :].reshape(N_c, mu)
            else:
                z = torch.zeros_like(rp).index_add_(
                    0, co.loc_idx.reshape(-1), zl.reshape(-1, mu))[:N_c]
        else:                                                # block-Jacobi
            z = co.E_inv @ r
        if co.lvl3 != "none" and co.Z2 is not None:
            z = z + co.Z2 @ _solve_level3(co, co.Z2.conj().T @ r)
        return z

    op = LinearOperator(gmv=lambda x: (E @ x[0])[None],
                        apply=lambda x: prec3(x[0])[None])
    x, its = _nested_krylov(co, op, cd[None])
    return (x[0], its) if return_its else x[0]


def _coarse_solve_bsr(co: CoarseState, c: torch.Tensor,
                      return_its: bool = False):
    """Nested Krylov solve on the block-sparse coarse problem
    (``hpddm_tpu/precond/schwarz.py:411-487``). c: (S, nu, mu) block RHS.

    The matvec is E_diag y + sum_j E_nbr[j] y_nbr(j) on the active slots,
    as one batched product of each block row [E_diag | E_nbr] with the
    stacked [y_s; y_nbr(s)]. The neighbour blocks are gathered by
    ``nbr_idx`` from y padded with a zero block at index S, where the JAX
    package multiplies by a one-hot (S, K, S+1): for finite y the values
    are the same (one nonzero term per slot, and 0 * finite = 0); a
    non-finite y stays in its own block here, where the one-hot product
    spreads a NaN to every block. The preconditioner is block-Jacobi,
    neighbour-block RAS (``ras`` and ``asm``: each block keeps its own
    rows) or none, plus the level-3 correction through ``agg_oh``. The
    products with the mask of active slots are skipped where every slot is
    active (a product with 1 changes no value). With ``return_its``: (y,
    inner iterations)."""
    cd = c.to(co.Eb_diag.dtype)
    S, nu, mu = cd.shape
    K = co.Eb_nbr.shape[1]
    act = (torch.arange(nu, device=cd.device)[None, :]
           < co.nu_loc[:, None])[:, :, None]
    act = None if bool(act.all()) else act.to(cd.dtype)

    def masked(v):
        return v if act is None else v * act

    cd = masked(cd)
    own = torch.arange(S, device=cd.device)[:, None]
    rows = torch.cat([own, co.nbr_idx], dim=1)                # (S, K+1)
    # block row s: [E_diag[s] | E_nbr[s, 0] | ... ], (S, nu, (K+1) nu)
    Erow = torch.cat([co.Eb_diag[:, None], co.Eb_nbr], dim=1) \
        .permute(0, 2, 1, 3).reshape(S, nu, (K + 1) * nu)

    def blocks(y):
        """[y_s; y_nbr(s, 0); ...]: (S, (K+1) nu, mu)."""
        ypad = torch.cat([y, y.new_zeros((1, nu, mu))])
        return ypad[rows].reshape(S, (K + 1) * nu, mu)

    def matvec(y):
        return masked(torch.bmm(Erow, blocks(y)))

    agg = None
    if co.lvl3 != "none" and co.E2_inv is not None:
        agg = co.agg_oh.to(cd.dtype).reshape(S * nu, -1)     # (S nu, n3)

    def prec(r):
        if co.prec == "none":
            z = r
        elif co.prec in ("ras", "asm") and co.Eloc_inv is not None:
            z = masked(torch.bmm(co.Eloc_inv, blocks(r))[:, :nu])
        else:                                                # block-Jacobi
            z = masked(torch.bmm(co.Eb_diag_inv, r))
        if agg is not None:
            # the basis unconjugated, as the JAX package's einsum
            w3 = _solve_level3(co, agg.T @ masked(r).reshape(S * nu, mu))
            z = z + masked((agg @ w3).reshape(S, nu, mu))
        return z

    x, its = _nested_krylov(co, LinearOperator(gmv=matvec, apply=prec), cd)
    return (x, its) if return_its else x


def deflation(state: SchwarzState, x: torch.Tensor) -> torch.Tensor:
    """Coarse correction out = Z E^-1 Z^T D x (HPDDM_schwarz.hpp:1602-1622).
    Z kept in another dtype than x (``Schwarz.build(dtype=...)``) is
    promoted with x, as the JAX package's einsums promote it. In ``bsr``
    mode the coarse right-hand side stays in (S, nu, mu) blocks."""
    co = state.coarse
    dec = state.dec
    mu = x.shape[-1]
    dx = dec.d[:, :, None] * x                               # D x
    Z = promoted(co.Z, dx)
    # coarse RHS c[(s, a)] = Z_s[:, a]^T (D x)_s -> (S, nu, mu)
    c = torch.bmm(Z.conj().transpose(1, 2), promoted(dx, Z))
    if co.mode == "bsr":
        y = _coarse_solve_bsr(co, c).to(x.dtype)
    else:
        y = _coarse_solve(co, c.reshape(-1, mu)).to(x.dtype) \
            .reshape(-1, co.nu_max, mu)                      # (S, nu, mu)
    return scaled_exchange(dec, torch.bmm(Z, promoted(y, Z)))   # Z y


def start(state: SchwarzState, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Initial guess with Dirichlet rows seeded exactly (Schwarz::start,
    HPDDM_schwarz.hpp:496-514): x_i = b_i / a_ii on detected boundary rows,
    then one scaled exchange. Identity when no boundary rows exist."""
    x = torch.zeros_like(b) if x0 is None else x0
    bc = state.bc
    if bc is None:
        return x
    mask = torch.abs(bc) > HPDDM_EPS
    seed = b / torch.where(mask, bc, torch.ones_like(bc)).to(b.dtype)[:, :, None]
    x = torch.where(mask[:, :, None], seed, x)
    return scaled_exchange(state.dec, x)


def apply(state: SchwarzState, x: torch.Tensor) -> torch.Tensor:
    """Full preconditioner apply (HPDDM_schwarz.hpp:527-612), with the JAX
    package's branches: the additive correction with asm/osm uses the
    unscaled exchange; deflated/balanced end with the scaled one."""
    if state.coarse is None:
        return one_level_apply(state, x)
    dec = state.dec
    corr = state.coarse.correction
    if corr == "additive":
        out = deflation(state, x)
        work = state.solver.solve(x)
        if state.variant in ("asm", "osm"):
            return out + exchange(dec, work)
        return out + scaled_exchange(dec, work)
    # deflated / balanced (HPDDM_schwarz.hpp:572-608)
    out = deflation(state, x)                                # Z E^-1 Z^T D x
    work = x - gmv(state, out)                               # (I - A Z E^-1 Z^T D) x
    if state.variant == "soras":
        work = dec.d[:, :, None] * work
    work = scaled_exchange(dec, state.solver.solve(work))    # D A_loc^-1 (...)
    if corr == "balanced":
        work = work - deflation(state, gmv(state, work))
    return out + work


def compute_residual(state: SchwarzState, x: torch.Tensor, f: torch.Tensor,
                     norm: str = "l2"):
    """Independent residual recomputation (HPDDM_schwarz.hpp:761-803).

    Returns (norm_b, norm_r) per RHS, POU-weighted so overlapping dofs
    count once; Dirichlet-penalty rows are filtered like the reference.
    x and f are in the caller's numbering."""
    dec = state.dec
    x = dec.permute(x)
    f = dec.permute(f)
    r = gmv(state, x) - f
    w = dec.d[:, :, None]
    f_eff = torch.where(torch.abs(f) > HPDDM_EPS * HPDDM_PEN, f / HPDDM_PEN, f)
    if norm == "l2":
        nr = torch.sum(w * torch.abs(r) ** 2, dim=(0, 1))
        nb = torch.sum(w * torch.abs(f_eff) ** 2, dim=(0, 1))
        return torch.sqrt(nb), torch.sqrt(nr)
    if norm == "l1":
        return (torch.sum(w * torch.abs(f_eff), dim=(0, 1)),
                torch.sum(w * torch.abs(r), dim=(0, 1)))
    return (torch.amax(torch.abs(f_eff), dim=(0, 1)),
            torch.amax(torch.abs(r), dim=(0, 1)))


# a diagonal entry this many times its matrix's median |diagonal| is a
# penalty row: the elasticity generators clamp with 1e8 max|A| on the
# diagonal (models/elasticity2d.py, models/elasticity3d.py)
PENALTY_RATIO = 1e6


def neumann_regularization(neumann: Sequence[MatrixCSR]) -> float:
    """The diagonal shift of Lanczos GenEO's Neumann solves: 1e-8 times
    the mean over the matrices of each one's mean |diagonal|, penalty rows
    (``PENALTY_RATIO``) left out. Without penalty rows this is the JAX
    package's shift (``hpddm_tpu/precond/schwarz.py:987-989``), bit for
    bit. The JAX package also averages the penalty rows in: on unscaled
    3D elasticity at 10^3 nodes its shift comes to 14.9 where 6.8e-7 was
    meant, and the shifted pencil of a floating subdomain loses its six
    rigid-body modes (smallest eigenvalue 0.50-1.49 where they are below
    1e-6); tests/test_torch_elasticity.py, ROADMAP queue C, C10."""
    means = []
    for m in neumann:
        d = np.abs(m.scipy().diagonal())
        means.append(d[d <= PENALTY_RATIO * np.median(d)].mean())
    return 1e-8 * float(np.mean(means))


def dump_eigenpairs(path: str, lam: np.ndarray, V: np.ndarray) -> None:
    """-hpddm_dump_eigenvectors' file of one subdomain: a comment line,
    the eigenvalues on one line (``%.15e``), then the vectors' rows
    (``np.savetxt``), as the JAX package writes it
    (``hpddm_tpu/precond/schwarz.py:923-934``)."""
    with open(path, "w") as fh:
        fh.write("# GenEO eigenpairs (lambda then vector columns)\n")
        fh.write(" ".join(f"{v:.15e}" for v in lam) + "\n")
        np.savetxt(fh, V)


# ----------------------------------------------------------------------
# Setup
# ----------------------------------------------------------------------

class Schwarz:
    """Setup: packs matrices, solves GenEO, factorizes, assembles the
    coarse operator (examples/schwarz.cpp:90-127 of the reference:
    Subdomain::initialize -> multiplicityScaling -> solveGEVP -> buildTwo ->
    callNumfact).

    ``timings`` holds the wall seconds of each setup phase run so far
    ("geneo", "factorize", "coarse"; with Lanczos GenEO also
    "neumann_factor", "lanczos_steps" and "lanczos_eig", parts of
    "geneo"; with the block-sparse coarse assembly "coarse_bsr_blocks"
    and "coarse_pinv", parts of "coarse"; with a nested coarse solve
    "coarse_levels", the host setup of its levels, in place of
    "coarse_pinv"), each ending in a device
    synchronization. With
    ``local_solver=banded`` through RCM, ``rcm_bandwidths`` holds the
    bandwidth of each subdomain's factor.
    """

    def __init__(self, mats: Sequence[MatrixCSR],
                 neighbors: Sequence[Sequence[int]],
                 mappings: Sequence[Sequence[np.ndarray]],
                 d: Optional[Sequence[np.ndarray]] = None,
                 options: Optional[Options] = None,
                 fmt: str = "auto",
                 optimized_mats: Optional[Sequence[MatrixCSR]] = None,
                 renumber: bool = False, prefix: str = "",
                 device=DEFAULT):
        if any(np.dtype(m.dtype) == np.complex64
               for m in list(mats) + list(optimized_mats or [])):
            raise TypeError(
                "complex64 local matrices: the port runs complex128 (the "
                "JAX package cannot carry a complex64 Krylov state through "
                "its f64 decomposition, so native c64 has no parity "
                "target: ROADMAP queue C, C11); for single precision use "
                "the real-pair form, helmholtz.generate(as_real=True, "
                "dtype=np.complex64)")
        self.opt = options if options is not None else Options()
        self.prefix = prefix
        self.device = as_device(device)
        n_loc = [m.n for m in mats]
        dec_dt = np.float64 if not mats or np.iscomplexobj(
            np.zeros(0, mats[0].dtype)) else np.dtype(mats[0].dtype).type
        self.dec = Decomposition.from_subdomains(
            neighbors, mappings, n_loc, d=d, renumber=renumber,
            dtype=dec_dt, device=self.device)
        self.mats = list(mats)             # caller numbering (dumps, stats)
        self.neighbors = [list(nb) for nb in neighbors]
        self.mappings = [[np.asarray(m, dtype=np.int64) for m in ms]
                         for ms in mappings]
        # user-supplied local matrices factorized in place of the plain
        # restrictions by oras/soras/osm (e.g. Robin interface conditions
        # for Helmholtz): the user-matrix branch of ``callNumfact``
        # (HPDDM_schwarz.hpp:337-368)
        self.optimized_mats = list(optimized_mats) if optimized_mats \
            else None
        self.n_max = self.dec.n_max
        self.A = pack_local_matrices(self._permuted(mats), n_max=self.n_max,
                                     fmt=fmt, device=self.device)
        self._apply_gmv_dtype()
        self._try_pexchange_plan()
        self._state: Optional[SchwarzState] = None
        self._bc_cache = None
        self._deflation_vectors: Optional[List[np.ndarray]] = None
        self._banded_shapes: Optional[List[tuple]] = None
        self._grid_geometry: Optional[tuple] = None
        self._herm_all: Optional[bool] = None
        self.rcm_bandwidths: Optional[List[int]] = None
        self.timings: Dict[str, float] = {}

    def _try_pexchange_plan(self) -> None:
        """Attach the one-pass exchange plan (parallel/pexchange.py) for an
        ELL operator, as ``_try_pexchange_plan`` of the JAX package
        (``hpddm_tpu/precond/schwarz.py:643-663``); ``exchange`` runs it on
        CUDA tensors. DIA (stencil) operators keep the plain exchange, as
        they do in the JAX package; so does the interface-first layout,
        whose exchange touches the contiguous interface block only."""
        if isinstance(self.A, BatchedELL) and not self.dec.renumbered:
            self.dec = dataclasses.replace(self.dec,
                                           pexch=build_plan(self.dec))

    def _timed(self, phase: str, t0: float) -> None:
        synchronize(self.device)
        self.timings[phase] = time.perf_counter() - t0

    def _boundary_conditions(self) -> Optional[torch.Tensor]:
        """(S, n_max) Dirichlet-row diagonal values (0 elsewhere), internal
        numbering; None when no boundary rows exist. Row i is a boundary
        row when its diagonal is penalty-scale (>= HPDDM_EPS * HPDDM_PEN)
        or when its off-diagonals vanish and the diagonal is ~1 (an
        eliminated identity row). A host pass over the CSR matrices, once
        per matrix set (``update_matrices`` clears it)."""
        if self._bc_cache is not None:
            return self._bc_cache[0]
        mats = self._permuted(self.mats)
        bc = np.zeros((self.dec.S, self.n_max),
                      dtype=np.asarray(mats[0].scipy().data).dtype)
        found = False
        for s, m in enumerate(mats):
            csr = m.scipy(expand=True).tocsr()
            n = csr.shape[0]
            diag = np.asarray(csr.diagonal())
            off = csr - sp.diags(diag)
            off_max = np.abs(off).max(axis=1).toarray().ravel()
            pen = np.abs(diag) >= HPDDM_EPS * HPDDM_PEN
            iden = (off_max <= HPDDM_EPS) & (np.abs(diag - 1.0) <= HPDDM_EPS)
            rows = pen | iden
            if rows.any():
                found = True
                bc[s, :n][rows] = diag[rows]
        self._bc_cache = (torch.as_tensor(bc, device=self.device)
                          if found else None,)
        return self._bc_cache[0]

    def _permuted(self, mats: Sequence[MatrixCSR]) -> List[MatrixCSR]:
        """The local matrices in the decomposition's internal numbering: a
        symmetric permutation on the host in the interface-first layout
        (``hpddm_tpu/precond/schwarz.py:831``), the matrices themselves
        otherwise."""
        if not self.dec.renumbered:
            return list(mats)
        perm = self.dec.perm.cpu().numpy()
        out = []
        for s, m in enumerate(mats):
            p = perm[s][perm[s] < m.n]
            out.append(MatrixCSR(m.scipy(expand=True)[p, :][:, p]))
        return out

    # -- HPDDM-style hooks -------------------------------------------------
    def set_vectors(self, vectors: Sequence[np.ndarray]) -> None:
        """User deflation vectors (``setVectors``): vectors[s] is (n_s,
        nu_s) in the caller's numbering, kept in the internal one."""
        self._deflation_vectors = [
            self.dec.permute_host(
                np.atleast_2d(np.asarray(v)).reshape(self.mats[s].n, -1), s)
            for s, v in enumerate(vectors)]

    def solve_gevp(self, neumann: Sequence[MatrixCSR], nu=None,
                   method: str = "auto",
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """GenEO: local pencil A_neu v = lambda (DAD|overlap) v
        (``Schwarz::solveGEVP``, HPDDM_schwarz.hpp:665-715). The
        smallest-lambda eigenvectors become the deflation vectors; returns
        nu per subdomain.

        nu: scalar or (S,) requested counts; defaults to -hpddm_geneo_nu.
        rng: the generator of ``select_nu``'s padding vectors under
        -hpddm_geneo_force_uniformity max (default: seeded with 42, as the
        JAX package). ``neumann`` must be genuine SPSD local matrices.

        method: "dense", "lanczos" or "auto", which takes Lanczos for
        n_max > 6000 or a banded, FFT or Chebyshev local solver, as the
        JAX package does (``hpddm_tpu/precond/schwarz.py:890-894``).

        The dense pencil runs one subdomain at a time, each Neumann matrix
        packed dense as the JAX package packs them, so the device holds a
        few n_max^2 blocks, not S of them. Lanczos: ``_solve_gevp_lanczos``.

        -hpddm_geneo_estimate_nu with -hpddm_geneo_threshold
        (HPDDM_schwarz.hpp:686-703; ``hpddm_tpu/precond/schwarz.py:880-911``):
        the eigensolve is sized at max(4 nu, 16) pairs (or at the option's
        value where it is above 1, capped at n_max) and each subdomain
        keeps the count of its eigenvalues below the threshold, clipped to
        [1, that size]. -hpddm_dump_eigenvectors writes each subdomain's
        kept eigenvalues and vectors (internal numbering) to
        ``<name>_<s>.txt``.
        """
        from hpddm_tpu_torch.precond.geneo import (scale_into_overlap,
                                                   select_nu,
                                                   solve_gevp_dense)
        t0 = time.perf_counter()
        opt = self.opt
        pfx = self.prefix
        S = self.dec.S
        if nu is None:
            nu = int(opt.val("geneo_nu", prefix=pfx))
        nu_req = np.full(S, nu, dtype=np.int64) if np.isscalar(nu) \
            else np.asarray(nu, dtype=np.int64)
        nu_max_req = int(max(1, nu_req.max()))
        threshold = opt.val("geneo_threshold", prefix=pfx)
        estimate = int(opt.val("geneo_estimate_nu", prefix=pfx) or 0)
        if estimate and threshold is not None:
            cap = estimate if estimate > 1 else max(4 * nu_max_req, 16)
            nu_max_req = int(min(self.n_max, max(nu_max_req, cap)))
        if method == "auto":
            method = "lanczos" if (self.n_max > 6000 or
                                   opt.val("local_solver", prefix=pfx)
                                   in ("fft", "dst_cheby", "banded")) \
                else "dense"
        if method == "lanczos":
            lam, V = self._solve_gevp_lanczos(neumann, nu_max_req)
            lam_np, V_np = lam.cpu().numpy(), V.cpu().numpy()
        else:
            lam_np = np.empty((S, nu_max_req))
            V_np = np.empty((S, self.n_max, nu_max_req))
            neumann = self._permuted(neumann)
            for s in range(S):
                sub = slice(s, s + 1)
                A_neu = pack_local_matrices([neumann[s]], n_max=self.n_max,
                                            fmt="dense", pad_identity=True,
                                            device=self.device).values
                lam, V = solve_gevp_dense(A_neu,
                                          scale_into_overlap(self.A,
                                                             self.dec, sub),
                                          nu_max_req)
                lam_np[s] = lam[0].cpu().numpy()
                V_np[s] = V[0].cpu().numpy()
        if estimate and threshold is not None:
            nu_req = np.clip((lam_np < float(threshold)).sum(axis=1), 1,
                             nu_max_req).astype(np.int64)
            if int(opt.val("verbosity", 0)) > 0:
                print(f"GenEO estimate_nu: {nu_req.tolist()} "
                      f"eigenvalues below {float(threshold):g}")
        nu_loc, V_np = select_nu(
            lam_np, nu_req,
            threshold=float(threshold) if threshold is not None else None,
            force_uniformity=opt.val("geneo_force_uniformity", prefix=pfx),
            rng=rng if rng is not None else np.random.default_rng(42),
            vectors=V_np)
        self._deflation_vectors = [
            np.ascontiguousarray(V_np[s, : self.mats[s].n, : int(nu_loc[s])])
            for s in range(S)]
        # HPDDM writes the attained count back into the option map
        self.opt["geneo_nu"] = int(nu_loc.max(initial=1))
        dump = opt.val("dump_eigenvectors")
        if dump:
            for s in range(S):
                dump_eigenpairs(f"{dump}_{s}.txt",
                                lam_np[s, : int(nu_loc[s])],
                                V_np[s, : self.mats[s].n, : int(nu_loc[s])])
        self._timed("geneo", t0)
        return nu_loc

    def _solve_gevp_lanczos(self, neumann: Sequence[MatrixCSR],
                            nu_max_req: int):
        """Matrix-free GenEO: shift-invert Lanczos on A_neu^-1 B
        (``geneo.solve_gevp_lanczos``; the JAX package's
        ``_solve_gevp_lanczos``, ``hpddm_tpu/precond/schwarz.py:937``), B
        applied as the overlap-masked D A D through the operator's SpMV.
        The inner solve of the (diagonally regularized) Neumann matrix:

        * ``local_solver=banded``: a host-f64 banded factor of
          A_neu + eps_reg I (grid boxes, else RCM), eps_reg from
          ``neumann_regularization``, applied once with one refinement
          step. The factor stays on the host path: the pencil is nearly
          singular, and a lower-precision recursion moves exactly the
          near-null eigenvalues GenEO needs
          (``hpddm_tpu/precond/schwarz.py:1022-1030``);
        * otherwise: 25 steps of CG preconditioned by the dense inverse of
          the assembled matrix, inverted one subdomain at a time as
          ``build`` inverts.

        * ``local_solver=fft`` or ``dst_cheby``: the same CG preconditioned
          by the DST solve of the grid boxes (``set_grid_geometry``
          required); ``cheby``: by the Jacobi diagonal of the assembled
          matrix (``hpddm_tpu/precond/schwarz.py:980-987``).

        Returns (lam (S, nu_max), V (S, n_max, nu_max)) on the device; the
        phases go to ``timings``.
        """
        from hpddm_tpu_torch.precond.geneo import solve_gevp_lanczos

        opt = self.opt
        dec = self.dec
        kind = opt.val("local_solver", prefix=self.prefix)
        t0 = time.perf_counter()
        # the shift from the caller's numbering: its mean sums the
        # diagonal in that order, as the JAX package's
        eps_reg = neumann_regularization(neumann)
        neumann = self._permuted(neumann)
        A_neu = pack_local_matrices(neumann, n_max=self.n_max, fmt="auto",
                                    pad_identity=True, device=self.device)
        mask = (dec.ov_mask.to(dec.d.dtype) * dec.d)[:, :, None]

        def apply_B(x):
            return mask * spmm(self.A, mask * x)

        def apply_Aneu(x):
            return spmm(A_neu, x) + eps_reg * x

        rows = int(opt.val("banded_block_rows"))
        if kind == "banded":
            regs = [sp.csr_matrix(m.scipy(expand=True).astype(np.float64)
                                  + eps_reg * sp.identity(m.n))
                    for m in neumann]
            boxes = self._banded_boxes(required=False)
            if boxes is None:
                Knb, _ = build_banded_solver_rcm(
                    regs, self.n_max, dtype=dec.d.dtype, rows_per_block=rows,
                    method="host", device=self.device)
            else:
                Knb = build_banded_solver(
                    regs, [(0, i1 - i0, 0, j1 - j0)
                           for (i0, i1, j0, j1) in boxes],
                    self.n_max, dtype=dec.d.dtype, rows_per_block=rows,
                    method="host", device=self.device)

            def apply_Ainv(r):
                x = Knb.solve(r)
                return x + Knb.solve(r - apply_Aneu(x))
        else:
            if kind in ("fft", "dst_cheby"):
                self._check_real(kind)
                boxes, Nx, Ny = self._geometry_for(kind)
                prec = build_fft_solver(boxes, Nx, Ny, self.n_max,
                                        dtype=dec.d.dtype,
                                        device=self.device)
            elif kind == "cheby":
                self._check_real(kind)
                prec = JacobiSolver(dinv=_extract_dinv(self.A, self.n_max))
            else:
                factor = torch.empty((dec.S, self.n_max, self.n_max),
                                     dtype=self.A.values.dtype,
                                     device=self.device)
                for s in range(dec.S):
                    factor[s] = invert(batched_dense_from(
                        self.A, slice(s, s + 1))[0])
                prec = LocalSolver(kind="inv", factor=factor)

            def apply_Ainv(r):
                # 25 steps of preconditioned CG, batched over subdomains
                def dot(a, b):
                    return torch.sum(a * b, dim=(1, 2))

                def safe(v):
                    return torch.where(torch.abs(v) > 0, v,
                                       torch.ones_like(v))[:, None, None]
                x = torch.zeros_like(r)
                res = r
                z = prec.solve(res)
                p = z
                rz = dot(res, z)
                for _ in range(25):
                    Ap = apply_Aneu(p)
                    alpha = rz[:, None, None] / safe(dot(p, Ap))
                    x = x + alpha * p
                    res = res - alpha * Ap
                    z = prec.solve(res)
                    rz_new = dot(res, z)
                    p = z + (rz_new[:, None, None] / safe(rz)) * p
                    rz = rz_new
                return x
        self._timed("neumann_factor", t0)
        ncv = opt.val("lanczos_ncv")
        return solve_gevp_lanczos(
            apply_Ainv, apply_B, dec.S, self.n_max, nu_max_req,
            ncv=int(ncv) if ncv else None, dtype=dec.d.dtype,
            device=self.device, timings=self.timings)

    def build(self, dtype=None) -> SchwarzState:
        """Factorize the local solvers and the coarse operator and return
        the state (``callNumfact``, HPDDM_schwarz.hpp:337-368).

        dtype: the dtype of the local factors and of the deflation
        vectors (default: the operator's). The JAX package's mixed
        precision: the operator and the Krylov vectors stay in their dtype
        and each product with a factor is promoted
        (``hpddm_tpu/precond/schwarz.py:1230-1237``).

        Local solvers: banded (``_build_banded``), ``fft`` (the DST solve
        of the grid boxes, ``hpddm_tpu/precond/schwarz.py:1110-1127``),
        ``cheby``/``dst_cheby`` (``_build_cheby``), else the dense factors
        of ``_factorize``.

        -hpddm_reuse_preconditioner: the object keeps the state it
        builds, and the next build keeps its factorization, its coarse
        operator and its boundary rows, with the current operator A
        (``update_matrices``) and variant (HPDDM_schwarz.hpp:364-366).
        Without the option nothing is kept (the JAX package keeps every
        state), so a setup object held past its solve holds no factors.
        -hpddm_dump_matrices writes each
        local matrix, caller numbering, to ``<name>_<s>.txt`` after a build
        with a dense local solver (inv, lu, chol, qr), as the JAX package
        (``hpddm_tpu/precond/schwarz.py:1243-1247``)."""
        opt = self.opt
        pfx = self.prefix
        variant = opt.val("schwarz_method", prefix=pfx)
        reuse = bool(int(opt.val("reuse_preconditioner", 0)))
        if self._state is not None and reuse:
            self._state = dataclasses.replace(self._state, A=self.A,
                                              variant=variant)
            return self._state
        self._state = None        # the old factors go before the new ones
        dt = self.A.values.dtype if dtype is None else as_torch_dtype(dtype)
        t0 = time.perf_counter()
        kind = opt.val("local_solver", prefix=pfx)
        # oras/soras/osm factorize the user's optimized matrices where given
        # (``hpddm_tpu/precond/schwarz.py:1144-1146,1223-1230``)
        src = self.optimized_mats if self.optimized_mats is not None and \
            variant in ("oras", "soras", "osm") else None
        if kind == "banded":
            solver = self._build_banded(dt, src)
        elif kind == "fft":
            self._check_real(kind)
            boxes, Nx, Ny = self._geometry_for(kind)
            solver = build_fft_solver(boxes, Nx, Ny, self.n_max, dtype=dt,
                                      device=self.device)
        elif kind in ("cheby", "dst_cheby"):
            solver = self._build_cheby(kind, dt, src)
        else:
            solver = self._factorize(kind, dt, src)
        self._timed("factorize", t0)

        t0 = time.perf_counter()
        coarse = None
        correction = opt.val("schwarz_coarse_correction", prefix=pfx)
        if correction is not None:
            coarse = self._build_coarse(correction, dt)
        self._timed("coarse", t0)

        state = SchwarzState(dec=self.dec, A=self.A, solver=solver,
                             coarse=coarse, variant=variant,
                             bc=self._boundary_conditions())
        self._state = state if reuse else None
        dump = opt.val("dump_matrices")
        if dump and kind in KINDS:
            for s, m in enumerate(self.mats):
                m.dump(f"{dump}_{s}.txt")
        return state

    def _factorize(self, kind: str, dtype, src) -> LocalSolver:
        """The dense local factors of ``kind`` (inv, lu, chol, qr), one
        subdomain at a time: the dense copy of a local matrix lives only
        while its factor is computed. The matrices are the packed
        operator's, or the optimized matrices ``src`` packed on the device
        in the operator's way (the same values as the JAX package's dense
        host pack, which would move S n_max^2 entries to the card)."""
        S = self.dec.S
        packed = self.A if src is None else pack_local_matrices(
            self._permuted(src), n_max=self.n_max, fmt="auto",
            device=self.device)
        factor = aux = None
        for s in range(S):
            A_s = batched_dense_from(packed, slice(s, s + 1))
            f_s, a_s = factor_parts(A_s.to(dtype), kind)
            if factor is None:
                factor = f_s.new_empty((S,) + tuple(f_s.shape[1:]))
                aux = None if a_s is None else \
                    a_s.new_empty((S,) + tuple(a_s.shape[1:]))
            factor[s] = f_s[0]
            if aux is not None:
                aux[s] = a_s[0]
            del A_s, f_s, a_s
        return LocalSolver(kind=kind, factor=factor, aux=aux)

    def _check_real(self, kind: str) -> None:
        """The DST and Chebyshev local solvers are real-valued: the power
        iteration's bounds take sum(v * w) without a conjugate, as the JAX
        package's (``hpddm_tpu/ops/cheby_solve.py:138,149,157``), wrong for
        a complex operator (ROADMAP queue C, C16)."""
        if self.A.values.is_complex() or any(
                np.iscomplexobj(np.zeros(0, m.dtype))
                for m in self.optimized_mats or ()):
            raise TypeError(f"local_solver={kind!r} takes real matrices "
                            "only (ROADMAP queue C, C16)")

    def _geometry_for(self, kind: str):
        """(boxes, Nx, Ny) of ``set_grid_geometry``, which the DST solve
        needs. The DST solve reads rows in box order, so the
        interface-first layout raises ``ValueError``, as ``_build_banded``
        does (the JAX package reads its permuted rows as box rows)."""
        if self._grid_geometry is None:
            raise ValueError(f"local_solver={kind} requires "
                             "set_grid_geometry(boxes, Nx, Ny)")
        if self.dec.renumbered:
            raise ValueError(f"local_solver={kind} requires the "
                             "grid-ordered (non-renumbered) layout")
        return self._grid_geometry

    def _build_cheby(self, kind: str, dtype, src) -> ChebyLocalSolver:
        """k-step Chebyshev local solves (``hpddm_tpu/precond/schwarz.py:
        1187-1222``) on the operator, or on the optimized matrices ``src``
        packed as the operator (``fmt="auto"``, identity pads) for
        oras/soras/osm; preconditioned by the DST solve with the diagonal
        scaling (``dst_cheby``, grid geometry required) or by the Jacobi
        diagonal (``cheby``); ``local_cheby_steps`` steps, the bounds from
        ``local_cheby_power_its`` power steps."""
        self._check_real(kind)
        pfx = self.prefix
        inner = None
        if kind == "dst_cheby":
            boxes, Nx, Ny = self._geometry_for(kind)
            inner = build_fft_solver(boxes, Nx, Ny, self.n_max, dtype=dtype,
                                     device=self.device)
        A_it = self.A if src is None else pack_local_matrices(
            self._permuted(src), n_max=self.n_max, fmt="auto",
            pad_identity=True, device=self.device)
        return build_cheby_solver(
            with_dtype(A_it, dtype), self.dec.row_mask, inner=inner,
            k=int(self.opt.val("local_cheby_steps", prefix=pfx)),
            power_its=int(self.opt.val("local_cheby_power_its",
                                       prefix=pfx)))

    def _build_banded(self, dtype, src=None) -> BandedSolver:
        """Exact block-tridiagonal local factors (ops/banded_solve.py):
        on the boxes of ``set_banded_shapes`` or ``set_grid_geometry``, else
        through RCM (``build_banded_solver_rcm``), ``banded_block_rows``
        grid rows per block, the factor method chosen by
        ``build_banded_solver``'s "auto" rule. Grid boxes need the caller's
        numbering and raise ``ValueError`` on the interface-first layout, as
        in the JAX package (``hpddm_tpu/precond/schwarz.py:1138-1141``); RCM
        reads the permuted matrices, its permutation riding the solver's
        slot gathers."""
        rows = int(self.opt.val("banded_block_rows", prefix=self.prefix))
        boxes = self._banded_boxes(required=False)
        if boxes is not None and self.dec.renumbered:
            raise ValueError("local_solver=banded with grid geometry "
                             "requires the grid-ordered (non-renumbered) "
                             "layout")
        mats = self.mats if src is None else src
        if boxes is None:
            solver, self.rcm_bandwidths = build_banded_solver_rcm(
                self._permuted(mats), self.n_max, dtype=dtype,
                rows_per_block=rows, device=self.device)
            return solver
        return build_banded_solver(mats, boxes, self.n_max, dtype=dtype,
                                   rows_per_block=rows, device=self.device)

    def exchange_rhs(self, f: torch.Tensor) -> torch.Tensor:
        """Make a (possibly inconsistent) RHS consistent, in the caller's
        numbering (examples/schwarz.cpp's ``A.exchange<true>(f, mu)``)."""
        return self.dec.unpermute(scaled_exchange(self.dec,
                                                  self.dec.permute(f)))

    def set_banded_shapes(self, shapes) -> None:
        """Declare the block-tridiagonal structure of the local matrices
        for ``local_solver=banded`` where no 2D grid geometry applies:
        ``shapes[s] = (rows, cols)`` with local index = row*cols + col and
        diagonal coupling between rows (for 3D boxes in plane-major order,
        rows = wz and cols = wx*wy)."""
        self._banded_shapes = [(int(r), int(c)) for (r, c) in shapes]

    def _banded_boxes(self, required: bool = True):
        """(0, cols, 0, rows) boxes from ``set_banded_shapes``, else the
        grid geometry's boxes; None (when not ``required``) selects RCM."""
        if self._banded_shapes is not None:
            return [(0, c, 0, r) for (r, c) in self._banded_shapes]
        if self._grid_geometry is None:
            if required:
                raise ValueError("local_solver=banded requires "
                                 "set_grid_geometry(boxes, Nx, Ny) or "
                                 "set_banded_shapes(shapes)")
            return None
        return self._grid_geometry[0]

    def set_grid_geometry(self, boxes, Nx: int, Ny: int) -> None:
        """Attach the generator's subdomain boxes (i0, i1, j0, j1) on an
        Nx x Ny grid: banded local solves then factor on the boxes instead
        of through RCM; on a uniform-box grid whose boxes fill n_max the
        exchange switches to the slab plan (parallel/grid.py), and a
        seam-safe DIA operator is annotated for the canvas form
        (``hpddm_tpu/precond/schwarz.py:1284-1297``). The interface-first
        layout keeps its own exchange and the flat form: no slab plan, no
        canvas."""
        self._grid_geometry = (list(boxes), int(Nx), int(Ny))
        if not self.dec.renumbered:
            plan = build_grid_plan(boxes, device=self.device)
            if plan is not None and plan.H * plan.W == self.dec.n_max:
                self.dec = dataclasses.replace(self.dec, grid=plan)
        self._try_canvas_annotate()

    def _try_canvas_annotate(self) -> None:
        """Annotate the packed DIA matrix with its canvas (H, W) when the
        boxes are uniform and fill n_max, every offset is a canvas move
        and the values are seam-safe: every coupling whose move shifts
        columns (dj != 0) vanishes where the move leaves the canvas row,
        checked on the host CSR copies (the reference generator's +-(W-1)
        offsets are diagonal moves). An operator with a seam coupling
        stays flat. The JAX package's transpose-plane map
        (``_canvas_symmetry``) is off unless an environment variable asks
        for it and measured slower there; the port leaves it out."""
        geo = self._grid_geometry
        if geo is None or self.dec.renumbered or \
                not isinstance(self.A, BatchedDIA) or \
                self.A.canvas_hw is not None:
            return
        hw = {(j1 - j0, i1 - i0) for (i0, i1, j0, j1) in geo[0]}
        if len(hw) != 1:
            return
        (H, W), = hw
        if H * W != self.n_max or any(m.n != self.n_max for m in self.mats):
            return
        moves = dia_canvas_moves(self.A.offsets, W)
        if moves is None or W < 2:
            return
        for m in self.mats:
            c = m.scipy(expand=True).tocoo()
            off = c.col - c.row
            colpos = c.row % W
            for o, (_, dj) in zip(self.A.offsets, moves):
                if dj == 0:
                    continue
                edge = (colpos == W - 1) if dj == 1 else (colpos == 0)
                if np.any((off == o) & edge & (c.data != 0)):
                    return              # a seam coupling: keep the flat form
        self.A = dataclasses.replace(self.A, canvas_hw=(H, W))

    def operator_state(self) -> SchwarzState:
        """A state with no factorization, for ``gmv`` and
        ``compute_residual`` only (SpMV benchmarks, matrix-free use)."""
        return SchwarzState(dec=self.dec, A=self.A, solver=None,
                            coarse=None, variant="none")

    def _apply_gmv_dtype(self) -> None:
        """-hpddm_gmv_dtype bfloat16: attach the bf16 mirror of a DIA
        operator's values (``hpddm_tpu/precond/schwarz.py:665-681``), which
        every product of ``ops/spmv.spmm`` then reads, in the plain DIA
        form. The JAX package's docstring says that setup keeps reading
        the full values; its code does not: the Galerkin assembly, the
        block-sparse blocks and Lanczos GenEO's B all go through ``spmm``
        and read the mirror, and so does the port, for parity (ROADMAP
        queue C, C14). Factorizations and the dense GenEO pencil read the
        full values. The JAX package's canvas planes taken from the mirror
        (``:683-701``) have no counterpart: a canvas operator takes the
        flat product here."""
        if not isinstance(self.A, BatchedDIA) or \
                self.opt.val("gmv_dtype") in (None, "same"):
            return
        self.A = dataclasses.replace(
            self.A, values_lp=self.A.values.to(torch.bfloat16))

    def update_matrices(self, mats: Sequence[MatrixCSR],
                        fmt: str = "auto") -> None:
        """Replace the local matrices for the next solve
        (``hpddm_tpu/precond/schwarz.py:1391-1401``): repacked in the
        internal numbering, the boundary-row and Hermitian caches cleared,
        the canvas check and the bf16 mirror redone. With
        -hpddm_reuse_preconditioner the next ``build`` keeps the old
        factorization and coarse operator."""
        self.mats = list(mats)
        self.A = pack_local_matrices(self._permuted(mats), n_max=self.n_max,
                                     fmt=fmt, device=self.device)
        self._herm_all = None
        self._bc_cache = None
        self._try_canvas_annotate()
        self._apply_gmv_dtype()

    def statistics(self) -> str:
        """Global decomposition statistics (Subdomain::statistics,
        HPDDM_subdomain.hpp:405-454), the JAX package's text
        (``hpddm_tpu/precond/schwarz.py:1403-1424``)."""
        dec = self.dec
        n_loc = dec.n_loc.cpu().numpy()
        d = dec.d.cpu().numpy()
        nnz = np.array([m.nnz for m in self.mats])
        nbrs = dec.if_mask.cpu().numpy().sum(axis=1)
        owned = (d > 1e-12).sum(axis=1)
        return "\n".join([
            f" --- {dec.S} subdomains, global unknowns "
            f"(unique) = {dec.n_global}",
            f"     local dofs: min {n_loc.min()} / avg "
            f"{n_loc.mean():.1f} / max {n_loc.max()}",
            f"     local nnz:  min {nnz.min()} / avg {nnz.mean():.1f} "
            f"/ max {nnz.max()}",
            f"     interface dofs per subdomain: min {nbrs.min()} / max "
            f"{nbrs.max()}",
            f"     owned (POU > 0) dofs: min {owned.min()} / max "
            f"{owned.max()}"])

    def _caller_pou(self) -> np.ndarray:
        """The POU (S, n_max) in the caller's numbering, on the host."""
        return self.dec.unpermute(self.dec.d).cpu().numpy()

    def exchange_matrices(self) -> None:
        """Algebraic matrix-overlap exchange, the matrix variant of
        ``Schwarz::exchange()`` (HPDDM_schwarz.hpp:190-275; the JAX
        package's ``exchange_matrices``, ``hpddm_tpu/precond/schwarz.py:
        703-768``). For every neighbour pair, the sharer whose POU is
        nonzero on a shared row sends that row's entries on the shared
        columns; the receiver overwrites the values at the positions its
        pattern already stores (explicit zeros included) and keeps its
        pattern. Senders go in ascending subdomain id, so the result is
        deterministic. Host setup; ends in ``update_matrices``."""
        d = self._caller_pou()
        csrs = [m.scipy(expand=True).tocsr() for m in self.mats]
        out = [c.copy() for c in csrs]
        out_keys = []                  # canonical row * n + col per entry
        for c in out:
            c.sort_indices()
            n = c.shape[0]
            rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(c.indptr))
            out_keys.append(rows * n + c.indices.astype(np.int64))
        for s in range(self.dec.S):    # ascending sender id
            A_s = csrs[s]
            for q, idx_s in zip(self.neighbors[s], self.mappings[s]):
                pos = self.neighbors[q].index(s)
                idx_q = self.mappings[q][pos]
                sendable = d[s][idx_s] > HPDDM_EPS
                if not sendable.any():
                    continue
                m = len(idx_s)
                sub_s = A_s[idx_s][:, idx_s].tocoo()
                keep = sendable[sub_s.row]             # POU-owned rows only
                sr, sc, sv = sub_s.row[keep], sub_s.col[keep], \
                    sub_s.data[keep]
                blk_q = csrs[q][idx_q][:, idx_q].tocoo()
                keys_q = np.unique(blk_q.row.astype(np.int64) * m
                                   + blk_q.col)
                hit = np.isin(sr.astype(np.int64) * m + sc, keys_q)
                if not hit.any():
                    continue
                tgt = out[q]
                key = idx_q[sr[hit]] * tgt.shape[0] + idx_q[sc[hit]]
                tgt.data[np.searchsorted(out_keys[q], key)] = sv[hit]
        self.update_matrices([MatrixCSR(m) for m in out])

    def restriction(self) -> bool:
        """Boolean rounding of the partition of unity
        (``Schwarz::restriction``, HPDDM_schwarz.hpp:277-333): each dof
        whose POU is fractional, or whose copies do not sum to 1, goes to
        the sharer with the largest value (ties to the higher subdomain
        id), whose copy becomes 1, the others 0 (``restrict_pou``). The
        decomposition is rebuilt with the rounded POU ("given" scaling, the
        same layout) and its exchange plans re-attached, and the next
        ``build`` starts afresh. Returns whether any value changed."""
        d = self._caller_pou()
        d_list = [d[s][: self.mats[s].n].copy() for s in range(self.dec.S)]
        changed = restrict_pou(self.neighbors, self.mappings, d_list)
        if changed:
            grid = self.dec.grid
            self.dec = Decomposition.from_subdomains(
                self.neighbors, self.mappings, [m.n for m in self.mats],
                d=d_list, scaling="given", renumber=self.dec.renumbered,
                dtype=d.dtype, device=self.device)
            if grid is not None:
                self.dec = dataclasses.replace(self.dec, grid=grid)
            self._try_pexchange_plan()
            self._state = None
        return changed

    # -- coarse operator ---------------------------------------------------
    def _coarse_cfg(self) -> dict:
        """The level-2 and level-3 options of a nested coarse solve
        (``hpddm_tpu/precond/schwarz.py:1427-1461``). level_2_krylov_method:
        cg (default) or gmres; level_2_schwarz_method: ras/oras/soras ->
        neighbour-block RAS, asm/osm -> ASM, none -> identity, unset ->
        block-Jacobi (an unset method with RAS is gmres: CG stalls on a
        nonsymmetric preconditioner). level_3_krylov_method: unset -> a
        direct level-3 solve, none -> no third level, cg/gmres -> the
        Jacobi CG of level_3_{tol,max_it}. level_3_aggregate_size: coarse
        blocks per level-3 aggregate; level_3_geneo_nu: spectral level-3
        vectors per aggregate (0: the aggregate constants)."""
        lvl = self.opt.level(2)
        sm = lvl.val("schwarz_method") if "schwarz_method" in lvl else None
        prec = {"ras": "ras", "oras": "ras", "soras": "ras", "asm": "asm",
                "osm": "asm", "none": "none"}.get(sm, "bj")
        if "krylov_method" in lvl:
            method = lvl.val("krylov_method")
        else:
            method = "gmres" if prec == "ras" else "cg"
        l3 = self.opt.level(3)
        l3m = l3.val("krylov_method") if "krylov_method" in l3 else None
        lvl3 = ("none" if l3m == "none" else
                "cg" if l3m is not None else "direct")
        return dict(method=method, prec=prec,
                    restart=int(lvl.val("gmres_restart", 30)),
                    inner_tol=float(lvl.val("tol", 1e-2)),
                    inner_max_it=int(lvl.val("max_it", 50)),
                    lvl3=lvl3, l3_tol=float(l3.val("tol", 1e-2)),
                    l3_max_it=int(l3.val("max_it", 20)),
                    agg=max(1, int(l3.val("aggregate_size", 1))),
                    l3_nu=int(l3.val("geneo_nu", 0) or 0))

    def _build_chain(self, E2_np: np.ndarray, dtype) -> dict:
        """Levels 4+ of the coarse recursion, on the host
        (``hpddm_tpu/precond/schwarz.py:1463-1529``): for every level k = 4,
        5, ... with a ``level_k_*`` option (krylov_method, aggregate_size,
        geneo_nu, tol, max_it), the previous level's matrix aggregated in
        groups of ``level_k_aggregate_size`` (default 4) indices, by
        constants or by the ``level_k_geneo_nu`` smallest eigenvectors of
        each group's diagonal block, Galerkin-projected and shifted by
        1e-12 trace / n. ``level_k_krylov_method`` cg/gmres continues the
        chain (a Jacobi CG deflated by level k+1); unset, the level is
        inverted and ends it. Returns the CoarseState ``chain_*`` fields
        (empty without level-4 options)."""
        hd = np.complex128 if np.iscomplexobj(E2_np) else np.float64
        E_prev = np.asarray(E2_np, dtype=hd)
        chain_Z, chain_E, chain_inv = [], [], []
        modes, tols, max_its = [], [], []
        k = 4

        def dev(a):
            return torch.as_tensor(a, device=self.device).to(dtype)

        while True:
            lv = self.opt.level(k)
            if not any(key in lv for key in ("krylov_method", "aggregate_size",
                                             "geneo_nu", "tol", "max_it")):
                break
            n_prev = E_prev.shape[0]
            agg = max(1, int(lv.val("aggregate_size", 4)))
            q = int(lv.val("geneo_nu", 0) or 0)
            n_agg = (n_prev + agg - 1) // agg
            if q > 0:
                cols = []
                for g in range(n_agg):
                    rows = np.arange(g * agg, min((g + 1) * agg, n_prev))
                    Eg = E_prev[np.ix_(rows, rows)]
                    _, v = np.linalg.eigh(0.5 * (Eg + Eg.conj().T))
                    kk = min(q, len(rows))
                    blk = np.zeros((n_prev, kk), dtype=hd)
                    blk[rows, :] = v[:, :kk]
                    cols.append(blk)
                Zk = np.concatenate(cols, axis=1)
            else:
                Zk = np.zeros((n_prev, n_agg), dtype=hd)
                Zk[np.arange(n_prev), np.arange(n_prev) // agg] = 1.0
            Ek = Zk.conj().T @ (E_prev @ Zk)
            nk = Ek.shape[0]
            Ek = Ek + (1e-12 * np.trace(Ek).real / max(nk, 1)
                       * np.eye(nk, dtype=hd))
            km = lv.val("krylov_method") if "krylov_method" in lv else None
            mode = "cg" if km in ("cg", "gmres") else "direct"
            inv = np.diag(1.0 / np.diag(Ek)) if mode == "cg" \
                else np.linalg.inv(Ek)
            chain_Z.append(dev(Zk))
            chain_E.append(dev(Ek))
            chain_inv.append(dev(inv))
            modes.append(mode)
            tols.append(float(lv.val("tol", 1e-2)))
            max_its.append(int(lv.val("max_it", 20)))
            if mode == "direct":
                break
            E_prev = Ek
            k += 1
        return dict(chain_Z=tuple(chain_Z), chain_E=tuple(chain_E),
                    chain_inv=tuple(chain_inv), chain_modes=tuple(modes),
                    chain_tols=tuple(tols), chain_max_its=tuple(max_its))

    def _nbr_blocks(self) -> List[List[int]]:
        """Each subdomain's neighbour subdomains, from the partner tables
        (E's block sparsity: E_sq != 0 only where s and q share dofs)."""
        psub = self.dec.partners.cpu().numpy() // self.dec.m_max
        S = self.dec.S
        return [sorted(set(psub[s][psub[s] < S].tolist())) for s in range(S)]

    @staticmethod
    def _aggregate_ind(S: int, agg: int) -> np.ndarray:
        """(S, n3) aggregate indicator: blocks s // agg share a column."""
        n3 = (S + agg - 1) // agg
        ind = np.zeros((S, n3))
        ind[np.arange(S), np.arange(S) // agg] = 1.0
        return ind

    @staticmethod
    def _lvl3_spectral_basis(Ed_np, En_np, nbr_sub, act, agg: int,
                             q3: int) -> np.ndarray:
        """Per-aggregate spectral level-3 basis (S, nu, n_agg * q), on the
        host (``hpddm_tpu/precond/schwarz.py:1548-1590``): for every
        aggregate g = {s : s // agg == g}, its local coarse operator (the
        diagonal and intra-aggregate neighbour blocks on the active slots),
        symmetrized, and its q smallest eigenvectors, the GenEO selection
        one level down (HPDDM_schwarz.hpp:449-495 recursed on E). Columns
        of different aggregates have disjoint support."""
        S, nu = Ed_np.shape[0], Ed_np.shape[1]
        n_agg = (S + agg - 1) // agg
        blocks_of = [[] for _ in range(n_agg)]
        for s in range(S):
            blocks_of[s // agg].append(s)
        cols = []
        for g in range(n_agg):
            slots = [(s, a) for s in blocks_of[g]
                     for a in range(nu) if act[s][a]]
            dim = len(slots)
            if dim == 0:
                continue
            index = {sa: i for i, sa in enumerate(slots)}
            Eg = np.zeros((dim, dim), dtype=Ed_np.dtype)
            for s in blocks_of[g]:
                aa = [a for a in range(nu) if act[s][a]]
                ia = [index[(s, a)] for a in aa]
                Eg[np.ix_(ia, ia)] = Ed_np[s][np.ix_(aa, aa)]
                for j, q in enumerate(nbr_sub[s]):
                    q = int(q)
                    if q < S and q // agg == g:
                        bb = [b for b in range(nu) if act[q][b]]
                        iq = [index[(q, b)] for b in bb]
                        Eg[np.ix_(ia, iq)] += En_np[s, j][np.ix_(aa, bb)]
            _, v = np.linalg.eigh(0.5 * (Eg + Eg.conj().T))
            k = min(q3, dim)
            blk = np.zeros((S, nu, k), dtype=Ed_np.dtype)
            for i, (s, a) in enumerate(slots):
                blk[s, a, :] = v[i, :k]
            cols.append(blk)
        return np.concatenate(cols, axis=2)

    def _build_coarse(self, correction: str, dtype) -> CoarseState:
        """Assemble E = Z^T A Z and set up its solve, in the JAX package's
        order (``hpddm_tpu/precond/schwarz.py:1612-1651``).

        Z columns: user vectors (set_vectors) or GenEO eigenvectors
        (solve_gevp); the constant vector by default. E is assembled dense
        (``_assemble_E``) or neighbour-block-sparse (``_bsr_blocks``):
        ``coarse_assembly=bsr``, or by itself where the dense assembly's
        (S, n_max, S*nu) tensor would pass ``_DENSE_COARSE_BYTES_CAP``
        (an explicit ``coarse_assembly=dense`` is kept, with a warning).
        Then the level-2 options (``level_2_krylov_method`` or
        ``level_2_tol``) choose a nested solve, ``iterative`` on the dense E
        or ``bsr`` on its blocks; without them E is inverted for a direct
        solve. ``-hpddm_level_2_dump_matrix`` writes the dense-assembled E
        (after its -hpddm_coarse_dtype rounding) in the reference's text
        format, as the JAX package (``hpddm_tpu/precond/schwarz.py:
        1638-1642``); the block-sparse assembly writes nothing there
        either."""
        opt = self.opt
        lvl = opt.level(2)
        dec = self.dec
        S = dec.S
        if self._deflation_vectors is None:
            vecs = [np.ones((self.mats[s].n, 1)) for s in range(S)]
        else:
            vecs = self._deflation_vectors
        nu_loc = np.array([v.shape[1] for v in vecs], dtype=np.int32)
        nu_max = int(nu_loc.max(initial=1))
        Z = np.zeros((S, self.n_max, nu_max), dtype=np.asarray(vecs[0]).dtype)
        for s, v in enumerate(vecs):
            Z[s, : v.shape[0], : v.shape[1]] = v
        Z = torch.as_tensor(Z, device=self.device).to(dtype)
        coarse_dtype = opt.val("coarse_dtype")
        low = None if coarse_dtype in (None, "same") \
            else as_torch_dtype(coarse_dtype)
        bsr = (opt.val("coarse_assembly") or "dense") == "bsr"
        bytes_dense = S * self.n_max * S * nu_max * dtype.itemsize
        if not bsr and bytes_dense > _DENSE_COARSE_BYTES_CAP:
            if opt.set("coarse_assembly"):
                print(f"WARNING -- coarse_assembly=dense materializes "
                      f"{bytes_dense / (1 << 30):.1f} GB "
                      f"(S={S}, nu={nu_max}); consider bsr")
            else:
                if int(opt.val("verbosity", 0)) >= 1:
                    print(f"coarse assembly auto-switched to bsr "
                          f"(dense would take "
                          f"{bytes_dense / (1 << 30):.1f} GB)")
                bsr = True
        nested = "krylov_method" in lvl or opt.set("level_2_tol")
        common = dict(Z=Z, nu_loc=torch.as_tensor(nu_loc, device=self.device),
                      nu_max=nu_max, correction=correction)
        if bsr and nested:
            t0 = time.perf_counter()
            E_diag, E_nb, nbr_sub = self._bsr_blocks(Z, nu_loc, nu_max)
            self._timed("coarse_bsr_blocks", t0)
            if low is not None:
                E_diag, E_nb = E_diag.to(low), E_nb.to(low)
            t0 = time.perf_counter()
            co = self._bsr_nested(E_diag, E_nb, nbr_sub, nu_loc, common)
            self._timed("coarse_levels", t0)
            return co
        if bsr:
            E_inv = self._bsr_direct_inverse(Z, nu_loc, nu_max, low)
        else:
            E = self._assemble_E(Z, nu_loc, nu_max)
            if low is not None:
                # -hpddm_coarse_dtype: the coarse operator in reduced
                # precision (``hpddm_tpu/precond/schwarz.py:2021-2023``);
                # it is inverted in f64 and rounded once, and the Krylov
                # dispatch switches GMRES to its flexible variant
                E = E.to(low)
            dump = lvl.val("dump_matrix")
            if dump:
                E_np = E.cpu().numpy() if E.dtype != torch.bfloat16 else \
                    E.cpu().float().numpy()
                MatrixCSR(sp.csr_matrix(E_np)).dump(str(dump))
            if nested:
                t0 = time.perf_counter()
                co = self._dense_nested(E, common)
                self._timed("coarse_levels", t0)
                return co
            E_inv = invert(E)
        return CoarseState(E_inv=E_inv, **common)

    def _dense_nested(self, E: torch.Tensor, common: dict) -> CoarseState:
        """The ``iterative`` coarse state of a dense E
        (``hpddm_tpu/precond/schwarz.py:1651-1731``): the block-Jacobi
        inverse (inverted in f64 and rounded below f64), the overlapping
        neighbour blocks' inverses for ``ras``/``asm`` (host f64), the
        level-3 basis Z2 (each aggregate's constants repeated over nu_max
        slots, inactive slots included, as the JAX package writes it; or
        the ``level_3_geneo_nu`` smallest eigenvectors of each aggregate's
        diagonal sub-block of E), E2 = Z2^H E Z2 shifted by 1e-12 trace / n3
        (the signed trace), and a direct or Jacobi-CG level 3 with levels
        4+. ``common``: the state's Z, nu_loc, nu_max and correction."""
        S = self.dec.S
        N_c = E.shape[0]
        nu_max = common["nu_max"]
        cfg = self._coarse_cfg()
        hd = np.complex128 if E.is_complex() else np.float64
        diag = E.reshape(S, nu_max, S, nu_max).diagonal(dim1=0, dim2=2) \
            .permute(2, 0, 1)                                # (S, nu, nu)
        Minv = torch.block_diag(*invert(diag))
        E_np = None
        if cfg["prec"] in ("ras", "asm") or cfg["l3_nu"] > 0:
            E_np = E.cpu().numpy().astype(hd)
        Eloc_inv = loc_idx = None
        if cfg["prec"] in ("ras", "asm"):
            nbrs = self._nbr_blocks()
            L = (1 + max((len(nb) for nb in nbrs), default=0)) * nu_max
            li = np.full((S, L), N_c, dtype=np.int64)
            El = np.tile(np.eye(L, dtype=hd), (S, 1, 1))
            for s in range(S):
                rows = np.concatenate([q * nu_max + np.arange(nu_max)
                                       for q in [s] + nbrs[s]])
                li[s, : len(rows)] = rows
                El[s, : len(rows), : len(rows)] = E_np[np.ix_(rows, rows)]
            Eloc_inv = torch.as_tensor(np.linalg.inv(El),
                                       device=self.device).to(E.dtype)
            loc_idx = torch.as_tensor(li, device=self.device)
        if cfg["l3_nu"] > 0:
            agg = cfg["agg"]
            cols = []
            for g in range((S + agg - 1) // agg):
                rows = np.concatenate([s * nu_max + np.arange(nu_max) for s in
                                       range(g * agg, min((g + 1) * agg, S))])
                Eg = E_np[np.ix_(rows, rows)]
                _, v = np.linalg.eigh(0.5 * (Eg + Eg.conj().T))
                kk = min(cfg["l3_nu"], len(rows))
                blk = np.zeros((N_c, kk), dtype=hd)
                blk[rows, :] = v[:, :kk]
                cols.append(blk)
            Z2 = np.concatenate(cols, axis=1)
        else:
            Z2 = np.repeat(self._aggregate_ind(S, cfg["agg"]), nu_max, axis=0)
        Z2 = torch.as_tensor(Z2, device=self.device).to(E.dtype)
        n3 = Z2.shape[1]
        E2 = Z2.conj().T @ (E @ Z2)
        E2 = E2 + (1e-12 * torch.trace(E2) / n3
                   * torch.eye(n3, dtype=E.dtype, device=E.device))
        chain = {}
        if cfg["lvl3"] == "cg":
            E2_inv, E2_keep = torch.diag(1.0 / torch.diagonal(E2)), E2
            chain = self._build_chain(E2.cpu().numpy(), E.dtype)
        else:
            E2_inv, E2_keep = invert(E2), None
        return CoarseState(
            **common, E_inv=Minv, E=E, mode="iterative",
            inner_tol=cfg["inner_tol"], inner_max_it=cfg["inner_max_it"],
            method=cfg["method"], restart=cfg["restart"], prec=cfg["prec"],
            lvl3=cfg["lvl3"], l3_tol=cfg["l3_tol"],
            l3_max_it=cfg["l3_max_it"], E2_inv=E2_inv, Z2=Z2, E2=E2_keep,
            Eloc_inv=Eloc_inv, loc_idx=loc_idx, **chain)

    def _bsr_nested(self, E_diag: torch.Tensor, E_nb: torch.Tensor,
                    nbr_sub: np.ndarray, nu_loc: np.ndarray,
                    common: dict) -> CoarseState:
        """The ``bsr`` coarse state (``hpddm_tpu/precond/schwarz.py:
        1864-1991``), on the host in f64 and rounded to the blocks' dtype:
        the block-Jacobi inverse, the neighbour-block RAS inverses over
        (K+1) nu_max blocks for ``ras``/``asm`` (blocks between two
        neighbours of s from the neighbour's own row), the level-3 basis
        (aggregate constants on the active slots, or
        ``_lvl3_spectral_basis``), E2 from the blocks shifted by 1e-12
        |trace| / n3, a direct or Jacobi-CG level 3 with levels 4+, and the
        neighbour index. In f32, a ``level_2_tol`` below 1e-5 is clamped to
        1e-5 with a warning: the f32 nested solve floors near it, and a
        tighter request spins it to max_it and can diverge the outer
        solve. ``common``: the state's Z, nu_loc, nu_max and correction."""
        S, nu = E_diag.shape[0], E_diag.shape[1]
        K = E_nb.shape[1]
        dt = E_diag.dtype
        hd = torch.complex128 if E_diag.is_complex() else torch.float64
        Ed_np = E_diag.cpu().to(hd).numpy()
        En_np = E_nb.cpu().to(hd).numpy()

        def dev(a):
            return torch.as_tensor(a, device=self.device).to(dt)

        Eb_diag_inv = dev(np.linalg.inv(Ed_np))
        cfg = self._coarse_cfg()
        act = np.arange(nu)[None, :] < nu_loc[:, None]
        Eloc_inv = None
        if cfg["prec"] in ("ras", "asm"):
            L = (K + 1) * nu
            El = np.tile(np.eye(L, dtype=Ed_np.dtype), (S, 1, 1))
            pos = {(s, int(q)): j for s in range(S)
                   for j, q in enumerate(nbr_sub[s]) if q < S}
            for s in range(S):
                ids = [s] + [int(q) for q in nbr_sub[s] if q < S]
                for a, qa in enumerate(ids):
                    for b, qb in enumerate(ids):
                        if qa == qb:
                            blk = Ed_np[qa]
                        elif (qa, qb) in pos:
                            blk = En_np[qa, pos[(qa, qb)]]
                        else:
                            continue
                        El[s, a * nu:(a + 1) * nu, b * nu:(b + 1) * nu] = blk
            Eloc_inv = dev(np.linalg.inv(El))
        if cfg["l3_nu"] > 0:
            V3h = self._lvl3_spectral_basis(Ed_np, En_np, nbr_sub, act,
                                            cfg["agg"], cfg["l3_nu"])
        else:
            ind = self._aggregate_ind(S, cfg["agg"])
            V3h = (ind[:, None, :] * act[:, :, None]).astype(Ed_np.dtype)
        n3 = V3h.shape[2]
        E2 = np.zeros((n3, n3), dtype=Ed_np.dtype)
        for s in range(S):
            Vs = V3h[s]                                      # (nu, n3)
            E2 += Vs.conj().T @ (Ed_np[s] * np.outer(act[s], act[s])) @ Vs
            for j, q in enumerate(nbr_sub[s]):
                if q < S:
                    E2 += Vs.conj().T @ En_np[s, j] @ V3h[q]
        E2 += 1e-12 * abs(np.trace(E2)) / n3 * np.eye(n3)
        chain = {}
        if cfg["lvl3"] == "cg":
            E2_inv, E2_keep = dev(np.diag(1.0 / np.diag(E2))), dev(E2)
            chain = self._build_chain(E2, dt)
        else:
            E2_inv, E2_keep = dev(np.linalg.inv(E2)), None
        inner_tol = cfg["inner_tol"]
        if dt == torch.float32 and inner_tol < 1e-5:
            print(f"WARNING -- level_2_tol {inner_tol:g} clamped to 1e-5 "
                  f"(f32 nested coarse floor; tighter requests poison "
                  f"the outer correction)")
            inner_tol = 1e-5
        return CoarseState(
            **common, E_inv=None, mode="bsr", inner_tol=inner_tol,
            inner_max_it=cfg["inner_max_it"], method=cfg["method"],
            restart=cfg["restart"], prec=cfg["prec"], lvl3=cfg["lvl3"],
            l3_tol=cfg["l3_tol"], l3_max_it=cfg["l3_max_it"], E2_inv=E2_inv,
            E2=E2_keep, Eloc_inv=Eloc_inv, agg_oh=dev(V3h), Eb_diag=E_diag,
            Eb_nbr=E_nb, Eb_diag_inv=Eb_diag_inv,
            nbr_idx=torch.as_tensor(nbr_sub, device=self.device), **chain)

    def _bsr_blocks(self, Z: torch.Tensor, nu_loc: np.ndarray, nu_max: int):
        """Neighbour-block-sparse Galerkin blocks (the reference's sparsity
        pattern 's', HPDDM_operator.hpp:378-562; the JAX package's
        ``_build_coarse_bsr``, ``hpddm_tpu/precond/schwarz.py:1737-1852``):

        * E_diag[s] = (D Z_s)^H A_s (D Z_s), identity on inactive slots;
        * E_nb[s, j] = (A_s^H D Z_s)[shared]^H (D Z_q)[shared] for the j-th
          neighbour q = nbr_sub[s, j]: the product lives on the interface
          slab, since a coarse column is supported on one subdomain and
          A_s's rows are complete wherever d_s != 0.

        ``coarse_galerkin=accumulation`` forms each subdomain's partial
        overlap contribution X_s^H (D_s A_s X_s) over the restrictions of
        its own and its neighbours' coarse vectors and adds them on the
        host in a fixed loop order (MatrixAccumulation,
        HPDDM_operator.hpp:563-1021). Memory and work are O(S *
        neighbours). Returns (E_diag (S, nu, nu), E_nb (S, K, nu, nu),
        nbr_sub (S, K) host ints, sentinel S)."""
        dec = self.dec
        S, m_max = dec.S, dec.m_max
        Av = self.A.values
        DZ = dec.d[:, :, None] * Z                           # (S, n, nu)
        W = spmm(self.A, promoted(DZ, Av))
        E_diag = torch.bmm(promoted(DZ, W).conj().transpose(1, 2),
                           promoted(W, DZ))
        if self._herm_all is None:
            # about 0.4 s a matrix at the flagship: once per matrix set
            self._herm_all = all(_is_herm(m) for m in self.mats)
        if self._herm_all:
            V = W.to(Z.dtype)                                # A^H = A
        else:
            A_H = pack_local_matrices(
                self._permuted([MatrixCSR(m.scipy().conj().T.tocsr())
                                for m in self.mats]),
                n_max=self.n_max, fmt="auto", device=self.device)
            V = spmm(A_H, DZ.to(Av.dtype)).to(Z.dtype)
        gidx = dec.if_idx[:, :, None].expand(-1, -1, nu_max)
        msk = dec.if_mask[:, :, None]
        zero = DZ.new_zeros(())
        Vif = torch.where(msk, torch.gather(V, 1, gidx), zero)
        DZif = torch.where(msk, torch.gather(DZ, 1, gidx), zero)
        flat = torch.cat([DZif.reshape(S * m_max, nu_max),
                          DZif.new_zeros((1, nu_max))])
        pvals = flat[dec.partners]                           # (S, m, k, nu)

        # partner slots grouped by neighbour subdomain (host, setup only)
        psub = dec.partners.cpu().numpy() // m_max           # sentinel -> S
        nbrs = [sorted(set(psub[s][psub[s] < S].tolist())) for s in range(S)]
        K = max([len(nb) for nb in nbrs] + [1])
        nbr_sub = np.full((S, K), S, dtype=np.int64)
        for s, nb in enumerate(nbrs):
            nbr_sub[s, : len(nb)] = nb

        def mask_of(j):
            return torch.as_tensor(psub == nbr_sub[:, j, None, None],
                                   device=self.device)

        if (self.opt.val("coarse_galerkin") or "multiplication") \
                == "accumulation":
            ar = torch.arange(S, device=self.device)[:, None]
            nbr_cols = []
            for j in range(K):
                vals_j = torch.sum(torch.where(mask_of(j)[..., None], pvals,
                                               zero), dim=2)  # (S, m, nu)
                Xq = DZ.new_zeros((S, self.n_max, nu_max))
                Xq.index_put_((ar.expand_as(dec.if_idx), dec.if_idx),
                              torch.where(msk, vals_j, zero), accumulate=True)
                nbr_cols.append(Xq)
            Xloc = torch.cat([DZ] + nbr_cols, dim=2)
            AX = spmm(self.A, Xloc.to(Av.dtype)).to(Z.dtype)
            DAX = dec.d[:, :, None] * AX
            G = torch.bmm(promoted(Xloc, DAX).conj().transpose(1, 2),
                          promoted(DAX, Xloc)).cpu().numpy()
            nu = nu_max
            Ed_acc = np.zeros((S, nu, nu), dtype=G.dtype)
            En_acc = np.zeros((S, K, nu, nu), dtype=G.dtype)
            rpos = [{int(q): j for j, q in enumerate(nbr_sub[s]) if q < S}
                    for s in range(S)]
            for s in range(S):
                ids = [s] + [int(q) for q in nbr_sub[s] if q < S]
                for a, qa in enumerate(ids):
                    Ga = G[s, a * nu:(a + 1) * nu]
                    for b, qb in enumerate(ids):
                        blk = Ga[:, b * nu:(b + 1) * nu]
                        if qa == qb:
                            Ed_acc[qa] += blk
                        elif qb in rpos[qa]:
                            En_acc[qa, rpos[qa][qb]] += blk
            E_diag = torch.as_tensor(Ed_acc, device=self.device)
            E_nb = torch.as_tensor(En_acc, device=self.device)
        else:
            Vc = Vif.conj()
            E_nb = torch.stack([
                torch.einsum("smk,sma,smkb->sab", mask_of(j).to(Vif.dtype),
                             Vc, pvals) for j in range(K)], dim=1)

        act = torch.as_tensor(np.arange(nu_max)[None, :]
                              < nu_loc[:, None], device=self.device)
        eye = torch.eye(nu_max, dtype=E_diag.dtype, device=self.device)
        E_diag = torch.where(act[:, :, None] & act[:, None, :], E_diag, eye)
        return E_diag, E_nb, nbr_sub

    def _bsr_direct_inverse(self, Z: torch.Tensor, nu_loc: np.ndarray,
                            nu_max: int, low) -> torch.Tensor:
        """The replicated direct solve of the block-sparse E (no level-2
        options: the reference's default, a direct factorization of the
        assembled E, HPDDM_coarse_operator_impl.hpp:1630): the blocks in
        ``low`` precision if -hpddm_coarse_dtype asks for one, scattered
        into an N_c^2 host f64 matrix, pseudo-inverted with numpy
        (``np.linalg.pinv``, rcond 1e-5 for f32 blocks, 1e-12 otherwise:
        f32 products leave E numerically singular when the high GenEO
        modes are nearly dependent) and rounded to the blocks' dtype."""
        t0 = time.perf_counter()
        E_diag, E_nb, nbr_sub = self._bsr_blocks(Z, nu_loc, nu_max)
        self._timed("coarse_bsr_blocks", t0)
        t0 = time.perf_counter()
        if low is not None:
            E_diag, E_nb = E_diag.to(low), E_nb.to(low)
        S = self.dec.S
        hd = np.complex128 if E_diag.is_complex() else np.float64
        Ed = E_diag.cpu().to(torch.complex128 if E_diag.is_complex()
                             else torch.float64).numpy()
        En = E_nb.cpu().to(torch.complex128 if E_nb.is_complex()
                           else torch.float64).numpy()
        E_full = np.eye(S * nu_max, dtype=hd)
        for s in range(S):
            rows = slice(s * nu_max, (s + 1) * nu_max)
            E_full[rows, rows] = Ed[s]
            for j, q in enumerate(nbr_sub[s]):
                if q < S:
                    E_full[rows, q * nu_max:(q + 1) * nu_max] = En[s, j]
        rcond = 1e-5 if E_diag.dtype == torch.float32 else 1e-12
        E_inv = torch.as_tensor(np.linalg.pinv(E_full, rcond=rcond),
                                device=self.device).to(E_diag.dtype)
        self._timed("coarse_pinv", t0)
        return E_inv

    def _assemble_E(self, Z: torch.Tensor, nu_loc: np.ndarray,
                    nu_max: int) -> torch.Tensor:
        """E[(s,a),(q,b)] = (R_s^T D_s Z_s^a)^T A (R_q^T D_q Z_q^b).

        X = exchange(D Z as global columns) gives every subdomain its
        restriction of all coarse basis vectors; then
        E = sum_s X_s^T D_s (A_s X_s), one matmul over the stacked rows."""
        dec = self.dec
        S, n, _ = Z.shape
        N_c = S * nu_max
        DZ = dec.d[:, :, None] * Z                           # (S, n, nu)
        X0 = Z.new_zeros((S, n, N_c))                        # delta_{q,s} D_s Z_s
        for s in range(S):
            X0[s, :, s * nu_max:(s + 1) * nu_max] = DZ[s]
        X = exchange(dec, X0)                                # consistent rep
        del X0
        # A_s X_s; Z in another dtype than the operator is promoted with
        # it, as the JAX package's product promotes it
        Y = spmm(self.A, promoted(X, self.A.values))
        Xd = X.conj() * dec.d[:, :, None]
        del X
        E = Xd.reshape(S * n, N_c).T @ Y.reshape(S * n, N_c)
        # pad empty coarse slots (nonuniform nu) with identity
        slot_active = (torch.arange(nu_max, device=Z.device)[None, :]
                       < torch.as_tensor(nu_loc, device=Z.device)[:, None]
                       ).reshape(-1)
        keep = slot_active[:, None] & slot_active[None, :]
        return torch.where(keep, E, torch.eye(N_c, dtype=E.dtype,
                                              device=E.device))
