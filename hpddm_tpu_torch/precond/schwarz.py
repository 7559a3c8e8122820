"""One- and two-level overlapping Schwarz preconditioners, main-path slice.

Counterpart of ``hpddm_tpu/precond/schwarz.py``. The preconditioner state
is a small dataclass of batched tensors (leading axis = subdomains) and the
runtime methods are plain functions over it:

* ``apply``: M^-1 with the variants RAS/ASM/ORAS/SORAS/none
  (HPDDM_schwarz.hpp:527-612) and the deflated/additive/balanced coarse
  corrections,
* ``gmv``: global SpMV = local SpMM + POU-scaled sum-exchange
  (HPDDM_schwarz.hpp:726-747),
* ``deflation``: coarse correction Z E^-1 Z^T D (HPDDM_schwarz.hpp:
  1602-1622) with a replicated, direct (inverted) coarse matrix
  E = Z^T A Z,
* ``compute_residual``: independent residual recomputation
  (HPDDM_schwarz.hpp:761-803).

``Schwarz`` is the setup: decomposition, DIA or ELL packing (with the
one-pass exchange plan for ELL operators), the grid slab exchange and
canvas annotation of ``set_grid_geometry``, GenEO (the dense pencil, or
shift-invert Lanczos with banded or ``inv``-preconditioned inner solves),
``inv`` or banded (block-tridiagonal, on grid boxes or through RCM) local
factors and the Galerkin coarse operator, assembled dense or
neighbour-block-sparse and inverted for a replicated direct solve. It
puts everything on the card unless the caller passes ``device="cpu"``.
The other setup branches of the JAX package (nested Krylov and
multilevel coarse solves, FFT and Chebyshev local solvers, the
interface-first layout) raise ``NotImplementedError`` naming their slice
in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

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
from hpddm_tpu_torch.ops.local_solve import LocalSolver, invert, promoted
from hpddm_tpu_torch.ops.spmv import dia_canvas_moves, spmm
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.parallel.grid import build_grid_plan
from hpddm_tpu_torch.parallel.ops import exchange, scaled_exchange
from hpddm_tpu_torch.parallel.pexchange import build_plan

# dense Galerkin assembly memory cap: above it the coarse operator is
# assembled block-sparse unless coarse_assembly=dense was asked for
_DENSE_COARSE_BYTES_CAP = 2 << 30


def _is_herm(m: MatrixCSR) -> bool:
    """A local matrix equal to its conjugate transpose, entry for entry."""
    c = m.scipy(expand=True).tocsr()
    d = (c - c.conj().T).tocoo()
    return d.nnz == 0 or not np.any(d.data != 0)


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to hpddm_tpu_torch yet ({where})")


@dataclasses.dataclass(frozen=True)
class CoarseState:
    """Two-level coarse-space state with a replicated direct coarse solve
    (the analogue of a main-process direct factorization,
    HPDDM_coarse_operator_impl.hpp:1630)."""
    Z: torch.Tensor               # (S, n_max, nu_max) local deflation vectors
    E_inv: torch.Tensor           # (N_c, N_c) inverse of E = Z^T A Z
    nu_loc: torch.Tensor          # (S,) int32, actual nu per subdomain
    nu_max: int
    correction: str               # 'deflated' | 'additive' | 'balanced'
    mode: str = "direct"


@dataclasses.dataclass(frozen=True)
class SchwarzState:
    dec: Decomposition
    A: object                     # batched local matrices (DIA/ELL/Dense)
    solver: Union[LocalSolver, BandedSolver]
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
    (HPDDM_schwarz.hpp:726-747)."""
    return scaled_exchange(state.dec, spmm(state.A, x))


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


def _coarse_solve(co: CoarseState, c: torch.Tensor) -> torch.Tensor:
    """Solve E y = c on the replicated coarse problem: one small matmul
    with the prefactorized inverse."""
    if co.mode != "direct":
        raise _not_ported(f"coarse mode {co.mode!r}",
                          "ROADMAP queue A, slices 3 and 5")
    return co.E_inv @ c.to(co.E_inv.dtype)


def deflation(state: SchwarzState, x: torch.Tensor) -> torch.Tensor:
    """Coarse correction out = Z E^-1 Z^T D x (HPDDM_schwarz.hpp:1602-1622).
    Z kept in another dtype than x (``Schwarz.build(dtype=...)``) is
    promoted with x, as the JAX package's einsums promote it."""
    co = state.coarse
    dec = state.dec
    mu = x.shape[-1]
    dx = dec.d[:, :, None] * x                               # D x
    Z = promoted(co.Z, dx)
    # coarse RHS c[(s, a)] = Z_s[:, a]^T (D x)_s -> (S, nu, mu)
    c = torch.bmm(Z.conj().transpose(1, 2), promoted(dx, Z)).reshape(-1, mu)
    y = _coarse_solve(co, c).to(x.dtype)                     # (N_c, mu)
    y = y.reshape(-1, co.nu_max, mu)                         # (S, nu, mu)
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
    count once; Dirichlet-penalty rows are filtered like the reference."""
    dec = state.dec
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
    and "coarse_pinv", parts of "coarse"), each ending in a device
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
        if optimized_mats is not None:
            raise _not_ported("optimized_mats (ORAS/SORAS user matrices)",
                              "ROADMAP queue A, slice 5")
        self.opt = options if options is not None else Options()
        self.prefix = prefix
        self.device = as_device(device)
        if self.opt.val("gmv_dtype") not in (None, "same"):
            raise _not_ported("-hpddm_gmv_dtype", "ROADMAP queue B, cells")
        n_loc = [m.n for m in mats]
        dec_dt = np.float64 if not mats or np.iscomplexobj(
            np.zeros(0, mats[0].dtype)) else np.dtype(mats[0].dtype).type
        self.dec = Decomposition.from_subdomains(
            neighbors, mappings, n_loc, d=d, renumber=renumber,
            dtype=dec_dt, device=self.device)
        self.mats = list(mats)
        self.n_max = self.dec.n_max
        self.A = pack_local_matrices(mats, n_max=self.n_max, fmt=fmt,
                                     device=self.device)
        self._try_pexchange_plan()
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
        they do in the JAX package."""
        if isinstance(self.A, BatchedELL):
            self.dec = dataclasses.replace(self.dec,
                                           pexch=build_plan(self.dec))

    def _timed(self, phase: str, t0: float) -> None:
        synchronize(self.device)
        self.timings[phase] = time.perf_counter() - t0

    def _boundary_conditions(self) -> Optional[torch.Tensor]:
        """(S, n_max) Dirichlet-row diagonal values (0 elsewhere); None when
        no boundary rows exist. Row i is a boundary row when its diagonal is
        penalty-scale (>= HPDDM_EPS * HPDDM_PEN) or when its off-diagonals
        vanish and the diagonal is ~1 (an eliminated identity row). A host
        pass over the CSR matrices, once per build."""
        bc = np.zeros((self.dec.S, self.n_max),
                      dtype=np.asarray(self.mats[0].scipy().data).dtype)
        found = False
        for s, m in enumerate(self.mats):
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
        return torch.as_tensor(bc, device=self.device) if found else None

    # -- HPDDM-style hooks -------------------------------------------------
    def set_vectors(self, vectors: Sequence[np.ndarray]) -> None:
        """User deflation vectors (``setVectors``): vectors[s] is (n_s, nu_s)."""
        self._deflation_vectors = [
            np.atleast_2d(np.asarray(v)).reshape(self.mats[s].n, -1)
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
        if int(opt.val("geneo_estimate_nu", prefix=pfx) or 0):
            raise _not_ported("-hpddm_geneo_estimate_nu",
                              "ROADMAP queue A, slice 5")
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
          A_neu + eps_reg I (grid boxes, else RCM), eps_reg = 1e-8 times
          the mean |diagonal|, applied once with one refinement step. The
          factor stays on the host path: the pencil is nearly singular, and
          a lower-precision recursion moves exactly the near-null
          eigenvalues GenEO needs (``hpddm_tpu/precond/schwarz.py:1022-1030``);
        * otherwise: 25 steps of CG preconditioned by the dense inverse of
          the assembled matrix, inverted one subdomain at a time as
          ``build`` inverts.

        The FFT and Chebyshev inner solves raise (slice 5d). Returns
        (lam (S, nu_max), V (S, n_max, nu_max)) on the device; the phases
        go to ``timings``.
        """
        from hpddm_tpu_torch.precond.geneo import solve_gevp_lanczos

        opt = self.opt
        dec = self.dec
        kind = opt.val("local_solver", prefix=self.prefix)
        if kind in ("fft", "dst_cheby", "cheby"):
            raise _not_ported(f"Lanczos GenEO with the {kind!r} inner solve",
                              "ROADMAP queue A, slice 5d")
        t0 = time.perf_counter()
        A_neu = pack_local_matrices(neumann, n_max=self.n_max, fmt="auto",
                                    pad_identity=True, device=self.device)
        mask = (dec.ov_mask.to(dec.d.dtype) * dec.d)[:, :, None]

        def apply_B(x):
            return mask * spmm(self.A, mask * x)

        # diagonal regularization of the (possibly singular) Neumann matrix
        eps_reg = 1e-8 * float(np.mean([np.abs(m.scipy().diagonal()).mean()
                                        for m in neumann]))

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
            factor = torch.empty((dec.S, self.n_max, self.n_max),
                                 dtype=self.A.values.dtype,
                                 device=self.device)
            for s in range(dec.S):
                factor[s] = invert(batched_dense_from(self.A,
                                                      slice(s, s + 1))[0])
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
        (``hpddm_tpu/precond/schwarz.py:1230-1237``)."""
        opt = self.opt
        pfx = self.prefix
        variant = opt.val("schwarz_method", prefix=pfx)
        for key in ("reuse_preconditioner", "dump_matrices",
                    "dump_eigenvectors"):
            if opt.val(key):
                raise _not_ported(f"-hpddm_{key}", "ROADMAP queue A, slice 5")
        dt = self.A.values.dtype if dtype is None else as_torch_dtype(dtype)
        t0 = time.perf_counter()
        kind = opt.val("local_solver", prefix=pfx)
        if kind == "banded":
            solver = self._build_banded(dt)
        elif kind == "inv":
            # one subdomain at a time: the dense copy of A_s lives only
            # while its inverse is computed
            factor = torch.empty((self.dec.S, self.n_max, self.n_max),
                                 dtype=dt, device=self.device)
            for s in range(self.dec.S):
                factor[s] = invert(batched_dense_from(
                    self.A, slice(s, s + 1))[0].to(dt))
            solver = LocalSolver(kind="inv", factor=factor)
        else:
            raise _not_ported(f"local_solver={kind!r}",
                              "ROADMAP queue A, slice 5")
        self._timed("factorize", t0)

        t0 = time.perf_counter()
        coarse = None
        correction = opt.val("schwarz_coarse_correction", prefix=pfx)
        if correction is not None:
            coarse = self._build_coarse(correction, dt)
        self._timed("coarse", t0)

        return SchwarzState(dec=self.dec, A=self.A, solver=solver,
                            coarse=coarse, variant=variant,
                            bc=self._boundary_conditions())

    def _build_banded(self, dtype) -> BandedSolver:
        """Exact block-tridiagonal local factors (ops/banded_solve.py):
        on the boxes of ``set_banded_shapes`` or ``set_grid_geometry``, else
        through RCM (``build_banded_solver_rcm``), ``banded_block_rows``
        grid rows per block, the factor method chosen by
        ``build_banded_solver``'s "auto" rule. The JAX package refuses grid
        boxes on its interface-first layout; the port has no such layout
        (``renumber=True`` raises), so that check has nothing to test."""
        rows = int(self.opt.val("banded_block_rows", prefix=self.prefix))
        boxes = self._banded_boxes(required=False)
        if boxes is None:
            solver, self.rcm_bandwidths = build_banded_solver_rcm(
                self.mats, self.n_max, dtype=dtype, rows_per_block=rows,
                device=self.device)
            return solver
        return build_banded_solver(self.mats, boxes, self.n_max, dtype=dtype,
                                   rows_per_block=rows, device=self.device)

    def exchange_rhs(self, f: torch.Tensor) -> torch.Tensor:
        """Make a (possibly inconsistent) RHS consistent."""
        return scaled_exchange(self.dec, f)

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
        (``hpddm_tpu/precond/schwarz.py:1284-1297``)."""
        self._grid_geometry = (list(boxes), int(Nx), int(Ny))
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
        if geo is None or not isinstance(self.A, BatchedDIA) or \
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

    def _build_coarse(self, correction: str, dtype) -> CoarseState:
        """Assemble E = Z^T A Z and invert it (replicated coarse solve).

        Z columns: user vectors (set_vectors) or GenEO eigenvectors
        (solve_gevp); the constant vector by default. E is assembled dense
        (``_assemble_E``) or neighbour-block-sparse (``_bsr_blocks``):
        ``coarse_assembly=bsr``, or by itself where the dense assembly's
        (S, n_max, S*nu) tensor would pass ``_DENSE_COARSE_BYTES_CAP``
        (an explicit ``coarse_assembly=dense`` is kept, with a warning)."""
        opt = self.opt
        lvl = opt.level(2)
        if "krylov_method" in lvl or opt.set("level_2_tol"):
            raise _not_ported("iterative (level-2) coarse solves "
                              "(coarse modes 'iterative' and 'bsr')",
                              "ROADMAP queue A, slice 3d")
        if lvl.val("dump_matrix"):
            raise _not_ported("-hpddm_level_2_dump_matrix",
                              "ROADMAP queue A, slice 5")
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
            E_inv = invert(E)
        return CoarseState(Z=Z, E_inv=E_inv,
                           nu_loc=torch.as_tensor(nu_loc, device=self.device),
                           nu_max=nu_max, correction=correction)

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
                [MatrixCSR(m.scipy().conj().T.tocsr()) for m in self.mats],
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
