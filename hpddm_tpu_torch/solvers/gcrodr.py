"""GCRO-DR: GMRES with deflated restarting and subspace recycling
(counterpart of ``hpddm_tpu/solvers/gcrodr.py``; the reference's
include/HPDDM_GCRODR.hpp).

* ``gcrodr`` is pseudo-block over the trailing RHS axis
  (HPDDM_GCRODR.hpp:35-444): every right-hand side keeps its own
  Hessenberg, Givens rotations and recycled pair (U, C = op U, C
  orthonormal in the weighted dot), while the operator and preconditioner
  applications are fused over all right-hand sides. The pair lives in the
  preconditioned operator's space (op = A M^-1 for the right variant,
  M^-1 A for the left), as the reference's updateSolRecycling
  (HPDDM_iterative.hpp:337-393).
* ``bgcrodr_fused`` is the block method (HPDDM_GCRODR.hpp:446-907): one
  block Krylov space over all right-hand sides, deflated restarting by
  block harmonic Ritz vectors; ``bgcrodr`` solves the columns one after
  another through ``gcrodr`` on one shared recycled space (not
  dispatched by ``solve``).
* At the end of the first full cycle, harmonic Ritz vectors of the
  Hessenberg seed U (HPDDM_GCRODR.hpp:676-707); later cycles solve the
  Parks et al. generalized problem G^H G p = theta G^H (Q^H W) p
  (HPDDM_GCRODR.hpp:745-760), or its strategy-B form without the cross
  products.
* The small dense eigensolves and least-squares problems run on the host
  in numpy/scipy, as the JAX package runs them in host callbacks and the
  reference in LAPACK; each cycle reads its Hessenberg from the device
  once, and the Arnoldi loop reads one convergence flag per iteration.
* Recycling across solves: ``recycled=result.recycled`` into the next call
  (``solvers/krylov.py`` keeps it in ``Options.storage``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hpddm_tpu_torch.dtypes import HPDDM_EPS, underlying
from hpddm_tpu_torch.solvers.base import LinearOperator
from hpddm_tpu_torch.solvers.block import _block_dot, _chol_qr, _init_norm


class RecycledSpace(NamedTuple):
    """Recycle pair persisted across solves (HPDDM_option.hpp storage_).

    U: (S, n, k) recycle basis (preconditioned-operator space); pseudo-block
       gcrodr with mu > 1 stores per-RHS slabs as (S, n, k, mu).
    C: same shape as U; C = op @ U, orthonormal in the weighted dot
       (each trailing-mu slab orthonormal independently)."""
    U: torch.Tensor
    C: torch.Tensor


class GCRODRResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    it_per_rhs: torch.Tensor
    rel_res: torch.Tensor
    converged: torch.Tensor
    recycled: Optional[RecycledSpace]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def _select_ritz(w: np.ndarray, k: int, target: str) -> np.ndarray:
    """Indices of k eigenvalues by -hpddm_recycle_target (SM default)."""
    if target == "LM":
        key = -np.abs(w)
    elif target == "SR":
        key = np.real(w)
    elif target == "LR":
        key = -np.real(w)
    elif target == "SI":
        key = np.abs(np.imag(w))
    elif target == "LI":
        key = -np.abs(np.imag(w))
    else:  # SM
        key = np.abs(w)
    return np.argsort(key)[:k]


def _harmonic_ritz_first(H_np: np.ndarray, p: int, k: int,
                         target: str) -> np.ndarray:
    """First-cycle harmonic Ritz of the (p+1) x p Hessenberg. Returns the
    real (p, k) coefficient matrix, orthonormalized."""
    Hs = H_np[:p, :p]
    h2 = H_np[p, p - 1] ** 2
    ep = np.zeros(p)
    ep[-1] = 1.0
    try:
        corr = h2 * np.linalg.solve(Hs.conj().T, np.outer(ep, ep))
    except np.linalg.LinAlgError:
        corr = 0.0
    w, vr = np.linalg.eig(Hs + corr)
    P = vr[:, _select_ritz(w, k, target)]
    P = np.real(P) if not np.iscomplexobj(H_np) else P
    q, _ = np.linalg.qr(P)
    return np.ascontiguousarray(q)


def _harmonic_ritz_general(G: np.ndarray, QhW: Optional[np.ndarray], k: int,
                           target: str) -> np.ndarray:
    """Parks et al. pencil: G^H G p = theta G^H (Q^H W) p.

    G: (d+1, d), QhW: (d+1, d) with d = k + p; QhW=None is the reference's
    -hpddm_recycle_strategy B (HPDDM_GCRODR.hpp:322-382): the cross
    products Q^H W are replaced by the orthogonality assumption
    [C, V]^H [U, V] = I, so the right-hand matrix of the pencil collapses
    to G^H truncated to its first d rows. Returns real (d, k)."""
    import scipy.linalg as sla
    Amat = G.conj().T @ G
    Bmat = G[:-1, :].conj().T if QhW is None else G.conj().T @ QhW
    w, vr = sla.eig(Amat, Bmat)
    w = np.where(np.isfinite(w), w, np.inf)
    P = vr[:, _select_ritz(w, k, target)]
    P = np.real(P) if not np.iscomplexobj(G) else P
    q, _ = np.linalg.qr(P)
    return np.ascontiguousarray(q)


def _rrqr_block(op: LinearOperator, r: torch.Tensor, dtol: float):
    """Rank-revealing QR of a residual block r (S, n, mu) through the Gram
    eigendecomposition: r = Q0 @ R0 with Q0 (S, n, bw) orthonormal and
    R0 (bw, mu), where bw counts singular values above ``dtol`` relative
    to the largest (the role of the reference's pivoted-QR deflation,
    HPDDM_iterative.hpp:583-595 / -hpddm_deflation_tol)."""
    w, v = np.linalg.eigh(_np(_block_dot(op, r, r)))
    w = np.maximum(w, 0.0)
    s = np.sqrt(w)[::-1]                              # descending
    v = v[:, ::-1]
    bw = max(int(np.sum(s > dtol * max(s[0], 1e-300))), 1)
    T = v[:, :bw]
    s_k = np.maximum(s[:bw], 1e-300)
    Q0 = torch.einsum("snm,ma->sna", r, _tensor(T / s_k[None, :], r))
    return Q0, _tensor(s_k[:, None] * np.conj(T).T, r), bw


def bgcrodr_fused(op: LinearOperator, b: torch.Tensor,
                  x0: Optional[torch.Tensor] = None, tol: float = 1.0e-6,
                  restart: int = 40, max_it: int = 100,
                  recycle: int = 0, target: str = "SM",
                  recycled: Optional[RecycledSpace] = None,
                  same_system: bool = False,
                  strategy: str = "A",
                  deflation_tol: float = -1.0) -> GCRODRResult:
    """Block GCRO-DR (HPDDM_GCRODR.hpp:446-907): one fused block Krylov
    space over all right-hand sides, deflated restarting through block
    harmonic Ritz vectors. Right-preconditioned only.

    The first full cycle takes harmonic Ritz vectors of the square block
    Hessenberg with the rank-mu correction Hsq^{-H} e_p (H_last^H H_last)
    e_p^H (the block form of HPDDM_GCRODR.hpp:676-707); later cycles the
    coupled-projection pencil over [U, V_p]: op([U, V_p]) = [C, V_{p+1}] G
    with G = [[I, B], [0, Hbar]], solved by the same Parks pencil as the
    pseudo-block path (HPDDM_GCRODR.hpp:745-850). Restart and recycle are
    counted in block iterations (HPDDM_GCRODR.hpp:517,603,694): each cycle
    runs restart - recycle block Arnoldi steps (restart on the first,
    recycle-less cycle), and the recycled space holds recycle blocks of
    the deflated width."""
    x = torch.zeros_like(b) if x0 is None else x0
    S, n, mu = b.shape
    dtype = b.dtype
    rdtype = underlying(dtype)
    k = int(recycle)
    m0 = max(int(restart), k + 1)
    prec = op.apply

    def op_apply(v):
        return op.gmv(prec(v))

    norm = _init_norm(op, b, rdtype)
    norm = torch.where(norm < HPDDM_EPS, torch.ones_like(norm), norm)
    norm_np = _np(norm)

    r = b - op.gmv(x)
    U = C = None
    if k and recycled is not None and recycled.U is not None:
        U, C = recycled.U, recycled.C
        if U.dim() == 4:
            # pseudo-block gcrodr stores per-RHS (S, n, k, mu) slabs; each
            # C[..., nu] is orthonormal, so slab 0 is a valid seed here
            U, C = U[..., 0], C[..., 0]
        if not (1 <= U.shape[-1] <= k * mu):
            U = C = None
    if U is not None:
        if not same_system:
            Q, Rfac = _tall_qr(op, _apply_cols(op_apply, U))
            C, U = Q, _solve_right_tri(U, Rfac)
        cr = _cross_j(op, C, r)
        x = x + prec(torch.einsum("snk,km->snm", U, cr))
        r = r - torch.einsum("snk,km->snm", C, cr)

    it = 1
    first_it = np.zeros(mu, dtype=np.int64)
    res = None
    while it <= max_it:
        kc = U.shape[-1] if U is not None else 0      # current space width
        if deflation_tol > 0:
            # deflated restarting: drop residual directions below the
            # tolerance; the cycle runs at block width bw <= mu while R0
            # (bw, mu) keeps tracking every right-hand side
            Q0, R0, bw = _rrqr_block(op, r, deflation_tol)
        else:
            Q0, R0 = _chol_qr(op, r)
            bw = mu
        R0_np = _np(R0)
        p = max(m0 - (k if U is not None else 0), 1)
        V = [Q0]                                      # block basis
        Z = []                                        # preconditioned blocks
        Hb = np.zeros((p + 1, p, bw, bw))             # block Hessenberg
        Bb = np.zeros((kc, p, bw)) if kc else None    # C-coupling
        steps = 0
        for i in range(p):
            z = prec(V[i])
            Z.append(z)
            w = op.gmv(z)
            if C is not None:
                Bc = _cross_j(op, C, w)
                w = w - torch.einsum("snk,km->snm", C, Bc)
                Bb[:, i, :] = _np(Bc)
            for j, Vj in enumerate(V):
                Hij = _block_dot(op, Vj, w)
                w = w - torch.einsum("sna,ab->snb", Vj, Hij)
                Hb[j, i] = _np(Hij)
            Qn, Rn = _chol_qr(op, w)
            Hb[i + 1, i] = _np(Rn)
            V.append(Qn)
            steps = i + 1
            # block least-squares residual per right-hand side
            Hmat = Hb[: i + 2, : i + 1].transpose(0, 2, 1, 3).reshape(
                (i + 2) * bw, (i + 1) * bw)
            rhs = np.zeros(((i + 2) * bw, mu))
            rhs[:bw] = R0_np
            y, *_ = np.linalg.lstsq(Hmat, rhs, rcond=None)
            res = np.linalg.norm(rhs - Hmat @ y, axis=0)
            crossed = res <= tol * norm_np
            first_it[(first_it == 0) & crossed] = it
            it += 1
            if crossed.all() or it > max_it:
                break

        # solution update: x += Z Y + M^-1 (U Yu), the coupled term
        Yb = _tensor(y.reshape(steps, bw, mu), b)
        upd = sum(torch.einsum("sna,am->snm", Z[i], Yb[i])
                  for i in range(steps))
        if kc:
            # z-coefficients: zc = -B y; U lives in operator space, so its
            # correction goes through M^-1
            Bflat = Bb[:, :steps, :].reshape(kc, steps * bw)
            zc = -(Bflat @ y[: steps * bw])
            upd = upd + prec(torch.einsum("snk,km->snm", U, _tensor(zc, b)))
        x = x + upd
        r = b - op.gmv(x)
        if C is not None:
            cr = _cross_j(op, C, r)
            x = x + prec(torch.einsum("snk,km->snm", U, cr))
            r = r - torch.einsum("snk,km->snm", C, cr)

        # recycle-space (re)construction at the end of a full block cycle
        if k and steps == p and (first_it == 0).any():
            pd = steps * bw
            Hflat = Hb[: steps + 1, :steps].transpose(0, 2, 1, 3).reshape(
                (steps + 1) * bw, pd)
            Vp = torch.cat(V[:steps], dim=-1)        # (S, n, p * bw)
            Vs = torch.cat(V[: steps + 1], dim=-1)
            if C is None:
                Hsq = Hflat[:pd]
                Hlast = Hb[steps, steps - 1]
                corr = np.zeros((pd, pd))
                try:
                    w_inv = np.linalg.solve(Hsq.T, np.eye(pd))
                    corr[:, -bw:] = w_inv[:, -bw:] @ (Hlast.T @ Hlast)
                except np.linalg.LinAlgError:
                    pass
                w_e, vr = np.linalg.eig(Hsq + corr)
                # bK = bw * k columns (HPDDM_GCRODR.hpp:696)
                idx = _select_ritz(w_e, min(k * bw, pd), target)
                P, _ = np.linalg.qr(np.real(vr[:, idx]))
                U_new = _lincomb_mat(Vp, _tensor(P, b))
                Qs, Rs = np.linalg.qr(Hflat @ P)      # C = V_{p+1} Q
                C = _lincomb_mat(Vs, _tensor(Qs, b))
                U = _solve_right_tri(U_new, Rs)
            else:
                d = kc + pd
                G = np.zeros((d + bw, d))
                G[:kc, :kc] = np.eye(kc)
                G[:kc, kc:] = Bb[:, :steps, :].reshape(kc, pd)
                G[kc:, kc:] = Hflat
                if strategy == "B":
                    QhW = None if bw == 1 else np.eye(d + bw, d)
                else:
                    QhW = np.zeros((d + bw, d))
                    QhW[:kc, :kc] = _cross(op, C, U)
                    QhW[kc:, :kc] = _cross(op, Vs, U)
                    QhW[kc: kc + pd, kc:] = np.eye(pd)
                P = _harmonic_ritz_general(G, QhW, min(k * bw, d), target)
                U_new = (_lincomb_mat(U, _tensor(P[:kc], b))
                         + _lincomb_mat(Vp, _tensor(P[kc:], b)))
                GPq, GPr = np.linalg.qr(G @ P)
                C = (_lincomb_mat(C, _tensor(GPq[:kc], b))
                     + _lincomb_mat(Vs, _tensor(GPq[kc:], b)))
                U = _solve_right_tri(U_new, GPr)
        if (first_it > 0).all() or it > max_it:
            break

    rel = res / norm_np if res is not None else np.full(mu, np.inf)
    its = np.where(first_it > 0, first_it, min(it - 1, max_it))
    return GCRODRResult(
        x=x, iterations=int(its.max()),
        it_per_rhs=torch.as_tensor(its, device=b.device),
        rel_res=torch.as_tensor(rel, dtype=rdtype, device=b.device),
        converged=torch.as_tensor(first_it > 0, device=b.device),
        recycled=RecycledSpace(U=U, C=C) if (k and U is not None) else None)


def bgcrodr(op: LinearOperator, b: torch.Tensor,
            x0: Optional[torch.Tensor] = None, tol: float = 1.0e-6,
            restart: int = 40, max_it: int = 100, variant: str = "right",
            recycle: int = 0, target: str = "SM",
            recycled: Optional[RecycledSpace] = None,
            same_system: bool = False, strategy: str = "A") -> GCRODRResult:
    """Sequential multi-RHS GCRO-DR (``hpddm_tpu/solvers/gcrodr.py:360``):
    the columns solved one after another by ``gcrodr``, sharing and
    refining one recycled space, so that later columns start warm (each
    after the first as the same system). ``solve`` does not dispatch here:
    ``-hpddm_krylov_method bgcrodr`` with mu > 1 runs ``bgcrodr_fused``,
    and ``gcrodr`` with mu > 1 is pseudo-block; this entry point is for
    solving columns in sequence where the warm deflation across them is
    the goal."""
    S, n, mu = b.shape
    kw = dict(tol=tol, restart=restart, max_it=max_it, variant=variant,
              recycle=recycle, target=target, strategy=strategy)
    if mu == 1:
        return gcrodr(op, b, x0, recycled=recycled, same_system=same_system,
                      **kw)
    xs, its, rels, convs = [], [], [], []
    rec = recycled
    for j in range(mu):
        xj = x0[:, :, j: j + 1] if x0 is not None else None
        res = gcrodr(op, b[:, :, j: j + 1], xj, recycled=rec,
                     same_system=same_system or j > 0, **kw)
        rec = res.recycled if res.recycled is not None else rec
        xs.append(res.x)
        its.append(int(res.iterations))
        rels.append(res.rel_res)
        convs.append(res.converged)
    return GCRODRResult(x=torch.cat(xs, dim=2), iterations=max(its),
                        it_per_rhs=torch.as_tensor(its, device=b.device),
                        rel_res=torch.cat(rels), converged=torch.cat(convs),
                        recycled=rec)


def gcrodr(op: LinearOperator, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None, tol: float = 1.0e-6,
           restart: int = 40, max_it: int = 100, variant: str = "right",
           recycle: int = 0, target: str = "SM",
           recycled: Optional[RecycledSpace] = None,
           same_system: bool = False, strategy: str = "A") -> GCRODRResult:
    """Solve with GCRO-DR, pseudo-block over the trailing RHS axis
    (HPDDM_GCRODR.hpp:35-444: per-RHS Hessenbergs and recycled slabs
    regenerated in the ``for nu < mu`` loop at :249). Internally U and C are
    (S, n, k, mu); a stored mu=1 space is exposed as (S, n, k) and
    broadcast to mu > 1 on entry (each right-hand side then refines its
    own copy)."""
    x = torch.zeros_like(b) if x0 is None else x0
    S, n, mu = b.shape
    rdtype = underlying(b.dtype)
    m = int(restart)
    k = int(min(recycle, m - 1)) if recycle else 0
    left = variant == "left"
    prec = op.apply

    def op_apply(v):  # the preconditioned operator
        return prec(op.gmv(v)) if left else op.gmv(prec(v))

    def residual(x):
        return b_eff - (prec(op.gmv(x)) if left else op.gmv(x))

    b_eff = prec(b) if left else b
    norm = torch.sqrt(op.init_norm_sq(b_eff)).to(rdtype)
    norm = torch.where(norm < HPDDM_EPS, torch.ones_like(norm), norm)
    norm_np = _np(norm)
    r = residual(x)

    U = C = None
    if k and recycled is not None and recycled.U is not None:
        U, C = recycled.U, recycled.C
        if U.dim() == 3:                      # stored mu=1 layout (S, n, k)
            U, C = U[..., None], C[..., None]
        if U.shape[-1] == 1 and mu > 1:       # broadcast to every RHS
            U = U.repeat(1, 1, 1, mu)
            C = C.repeat(1, 1, 1, mu)
        if U.shape[-1] != mu or U.shape[2] != k:
            U = C = None                      # incompatible stored space
    if U is not None:
        if not same_system:
            # re-project for the (possibly) new operator: C = Q of op(U)
            C, Rfac = _tall_qr_mu(op, _apply_cols_mu(op_apply, U))
            U = _solve_right_tri_mu(U, Rfac)
        cr = _gram_cols(op, C, r)
        Ucr = torch.einsum("snkm,km->snm", U, cr)
        x = x + (Ucr if left else prec(Ucr))
        r = r - torch.einsum("snkm,km->snm", C, cr)

    it = 1
    first_it = np.zeros(mu, dtype=np.int64)
    while it <= max_it:
        p = m - (k if U is not None else 0)
        beta = torch.sqrt(op.norm_sq(r)).to(rdtype)
        beta_np = _np(beta)
        if it > 1 and bool(np.all(beta_np <= tol * norm_np)):
            break
        V, H_np, B_np, crossing = _arnoldi_cycle(op, op_apply, r, beta, p,
                                                 C, tol, norm, it, max_it)
        steps = min(p, max_it - it + 1)
        used = int(crossing.max() - it + 1) if np.all(crossing > 0) \
            else steps
        used = max(min(used, steps), 0)

        # per-RHS least-squares solves on the small systems
        y = np.zeros((p, mu), dtype=H_np.dtype)
        for nu in range(mu):
            y[:, nu] = _ls_solve(H_np[:, :, nu], float(beta_np[nu]), used)
        upd = torch.einsum("jm,jsnm->snm", _tensor(y, b), V[:p])
        if U is not None:
            z_coef = -np.einsum("kjm,jm->km", B_np[:, :used], y[:used])
            upd = upd + torch.einsum("snkm,km->snm", U, _tensor(z_coef, b))
        x = x + (upd if left else prec(upd))
        r = residual(x)

        newly = (first_it == 0) & (crossing > 0)
        first_it[newly] = crossing[newly]

        # recycle-space update at the end of a full cycle, per RHS
        if k and used == p:
            if U is None:
                # first cycle: harmonic Ritz of each RHS's Hessenberg
                kk = min(k, p)
                P_all = np.zeros((p, kk, mu), dtype=H_np.dtype)
                Qs_all = np.zeros((p + 1, kk, mu), dtype=H_np.dtype)
                Rs_all = np.zeros((kk, kk, mu), dtype=H_np.dtype)
                for nu in range(mu):
                    P_nu = _harmonic_ritz_first(H_np[:, :, nu], p, kk, target)
                    Qs, Rs = np.linalg.qr(H_np[: p + 1, :p, nu] @ P_nu)
                    P_all[:, :, nu], Qs_all[:, :, nu] = P_nu, Qs
                    Rs_all[:, :, nu] = Rs
                U_new = torch.einsum("jkm,jsnm->snkm", _tensor(P_all, b),
                                     V[:p])
                C = torch.einsum("jkm,jsnm->snkm", _tensor(Qs_all, b),
                                 V[: p + 1])
                U = _solve_right_tri_mu(U_new, Rs_all)
            else:
                d = k + p
                if strategy != "B":
                    # Q^H W cross products (the reference's allreduced
                    # "prod"); strategy B does without them
                    CU = _cross_mu(op, C, U)                  # (k, k, mu)
                    VU = _cross_stack_mu(op, V[: p + 1], U)   # (p+1, k, mu)
                P_all = np.zeros((d, k, mu), dtype=H_np.dtype)
                GPq_all = np.zeros((d + 1, k, mu), dtype=H_np.dtype)
                GPr_all = np.zeros((k, k, mu), dtype=H_np.dtype)
                for nu in range(mu):
                    # G = [[I_k, B], [0, Hbar]] : (d+1, d)
                    G = np.zeros((d + 1, d), dtype=H_np.dtype)
                    G[:k, :k] = np.eye(k)
                    G[:k, k:] = B_np[:, :, nu]
                    G[k:, k:] = H_np[:, :, nu]
                    QhW = None
                    if strategy != "B":
                        QhW = np.zeros((d + 1, d), dtype=H_np.dtype)
                        QhW[:k, :k] = CU[:, :, nu]
                        QhW[k: d + 1, :k] = VU[:, :, nu]
                        QhW[k: d, k:] = np.eye(p)
                    P_nu = _harmonic_ritz_general(G, QhW, k, target)
                    GPq, GPr = np.linalg.qr(G @ P_nu)
                    P_all[:, :, nu], GPq_all[:, :, nu] = P_nu, GPq
                    GPr_all[:, :, nu] = GPr
                # W P = U P_u + V_p P_v, per RHS
                U_new = (torch.einsum("kjm,snkm->snjm",
                                      _tensor(P_all[:k], b), U)
                         + torch.einsum("pjm,psnm->snjm",
                                        _tensor(P_all[k:], b), V[:p]))
                C = (torch.einsum("kjm,snkm->snjm", _tensor(GPq_all[:k], b), C)
                     + torch.einsum("pjm,psnm->snjm",
                                    _tensor(GPq_all[k:], b), V[: p + 1]))
                U = _solve_right_tri_mu(U_new, GPr_all)

        it += used
        if np.all(first_it > 0) or used < steps or used == 0:
            break

    rel = torch.sqrt(op.norm_sq(r)).to(rdtype) / norm
    its = np.where(first_it > 0, first_it, min(it - 1, max_it))
    rec = None
    if k and U is not None:
        rec = RecycledSpace(U=U[..., 0] if mu == 1 else U,
                            C=C[..., 0] if mu == 1 else C)
    return GCRODRResult(x=x, iterations=int(its.max()),
                        it_per_rhs=torch.as_tensor(its, device=b.device),
                        rel_res=rel, converged=rel <= tol, recycled=rec)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def _lincomb_mat(U: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """(S, n, k) x (k, k2) -> (S, n, k2)."""
    return torch.einsum("snk,kj->snj", U, P)


def _apply_cols(fn, U: torch.Tensor) -> torch.Tensor:
    return torch.stack([fn(U[:, :, i: i + 1])[:, :, 0]
                        for i in range(U.shape[-1])], dim=-1)


def _cross_j(op: LinearOperator, Cols: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """(S, n, k)^H W y (S, n, mu) -> (k, mu) on the device."""
    return torch.einsum("snk,snm->km", Cols.conj(), op.weighted(y))


def _cross(op: LinearOperator, A: torch.Tensor,
           Bm: torch.Tensor) -> np.ndarray:
    """(S, n, k1)^H W (S, n, k2) -> numpy (k1, k2)."""
    return _np(torch.einsum("snk,snj->kj", A.conj(), op.weighted(Bm)))


def _gram_sqrt(G: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(R, R^+) of a small Gram matrix: the eigh square root of its
    Hermitian part and its pseudo-inverse, eigenvalues below 1e-12 of the
    largest dropped (robust to near-dependent columns)."""
    w, V = np.linalg.eigh(0.5 * (G + G.conj().T))
    keep = w > 1e-12 * max(float(np.max(np.abs(w))), 1e-300)
    sqrt_w = np.sqrt(np.where(keep, w, 1.0))
    return ((V * np.where(keep, sqrt_w, 0.0)[None, :]) @ V.conj().T,
            (V * np.where(keep, 1.0 / sqrt_w, 0.0)[None, :]) @ V.conj().T)


def _tall_qr(op: LinearOperator,
             U: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
    """CholQR of (S, n, k) in the weighted inner product."""
    R, Rinv = _gram_sqrt(_cross(op, U, U))
    return _lincomb_mat(U, _tensor(Rinv, U)), R


def _solve_right_tri(U: torch.Tensor, R: np.ndarray) -> torch.Tensor:
    return _lincomb_mat(U, _tensor(np.linalg.pinv(R), U))


# -- per-RHS (pseudo-block) variants: U/C carry a trailing mu axis --------

def _gram_cols(op: LinearOperator, Cols: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Per-RHS weighted Gram: Cols (S,n,k,mu)^H W y (S,n,mu) -> (k, mu)."""
    return torch.einsum("snkm,snm->km", Cols.conj(), op.weighted(y))


def _apply_cols_mu(fn, U: torch.Tensor) -> torch.Tensor:
    """Apply fn to each of the k per-RHS column groups of (S, n, k, mu)."""
    return torch.stack([fn(U[:, :, j, :]) for j in range(U.shape[2])], dim=2)


def _cross_mu(op: LinearOperator, A: torch.Tensor,
              Bm: torch.Tensor) -> np.ndarray:
    """(S,n,k1,mu)^H W (S,n,k2,mu) per RHS -> numpy (k1, k2, mu)."""
    return _np(torch.einsum("snkm,snjm->kjm", A.conj(), op.weighted(Bm)))


def _cross_stack_mu(op: LinearOperator, V: torch.Tensor,
                    U: torch.Tensor) -> np.ndarray:
    """V (j, S, n, mu) stack vs U (S, n, k, mu) per RHS -> numpy (j, k, mu)."""
    return _np(torch.einsum("jsnm,snkm->jkm", V.conj(), op.weighted(U)))


def _tall_qr_mu(op: LinearOperator,
                U: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
    """Per-RHS CholQR of (S, n, k, mu) in the weighted inner product.
    Returns (Q (S,n,k,mu), R (k,k,mu))."""
    G = _cross_mu(op, U, U)
    R = np.zeros_like(G)
    Rinv = np.zeros_like(G)
    for nu in range(G.shape[2]):
        R[:, :, nu], Rinv[:, :, nu] = _gram_sqrt(G[:, :, nu])
    return torch.einsum("snkm,kjm->snjm", U, _tensor(Rinv, U)), R


def _solve_right_tri_mu(U: torch.Tensor, R: np.ndarray) -> torch.Tensor:
    """Per-RHS right-multiply by pinv(R): U (S,n,k,mu), R (k,k,mu)."""
    Rp = np.stack([np.linalg.pinv(R[:, :, nu]) for nu in range(R.shape[2])],
                  axis=-1)
    return torch.einsum("snkm,kjm->snjm", U, _tensor(Rp, U))


def _ls_solve(H: np.ndarray, beta: float, used: int) -> np.ndarray:
    """min || beta e1 - H[:used+1, :used] y ||; returns y (p,)."""
    y = np.zeros(H.shape[1], dtype=H.dtype)
    if used == 0:
        return y
    Hs = H[: used + 1, :used]
    rhs = np.zeros(used + 1, dtype=H.dtype)
    rhs[0] = beta
    y[:used] = np.linalg.lstsq(Hs, rhs, rcond=None)[0]
    return y


def _arnoldi_cycle(op: LinearOperator, op_apply, r: torch.Tensor,
                   beta: torch.Tensor, p: int, C: Optional[torch.Tensor],
                   tol: float, norm: torch.Tensor, it0: int, max_it: int):
    """One projected Arnoldi cycle, pseudo-block over the trailing mu axis:
    each right-hand side carries its own Hessenberg column, Givens
    rotations and residual, while the operator application is fused
    (HPDDM_GCRODR.hpp:115-197 iterates ``nu < mu`` around one batched GMV).
    The JAX package scans all p steps; this loop stops once every
    right-hand side has crossed or the iteration cap is passed, since the
    caller reads no column beyond that point.

    Returns (V (p+1, S, n, mu), H (p+1, p, mu) numpy, B (k, p, mu) numpy,
    crossing (mu,) numpy: the first global iteration crossing tol within
    this cycle, 0 where none)."""
    S, n, mu = r.shape
    dtype = r.dtype
    dev = r.device
    k = C.shape[2] if C is not None else 0    # C: (S, n, k, mu)
    V = r.new_zeros((p + 1, S, n, mu))
    V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))
    H = r.new_zeros((p + 1, p, mu))
    B = r.new_zeros((k, p, mu))
    s_vec = r.new_zeros((p + 1, mu))
    s_vec[0] = beta.to(dtype)
    Q = torch.eye(p + 1, dtype=dtype, device=dev)[:, :, None].repeat(1, 1, mu)
    crossing = torch.zeros(mu, dtype=torch.int64, device=dev)
    for i in range(p):
        w = op_apply(V[i])
        if C is not None:
            Bcol = _gram_cols(op, C, w)                     # (k, mu)
            w = w - torch.einsum("snkm,km->snm", C, Bcol)
            B[:, i] = Bcol
        h = r.new_zeros((p + 1, mu))
        h[: i + 1] = op.gram(V[: i + 1], w)
        w = w - torch.einsum("km,ksnm->snm", h[: i + 1], V[: i + 1])
        hn = torch.sqrt(op.norm_sq(w)).to(dtype)
        V[i + 1] = w / torch.where(torch.abs(hn) > 0, hn, torch.ones_like(hn))
        h[i + 1] = hn
        H[:, i] = h                           # unrotated: the LS uses H

        # accumulated rotation product, per RHS (see solvers/gmres.py)
        hrot = torch.einsum("abm,bm->am", Q, h)
        hi, hi1 = hrot[i], hrot[i + 1]
        denom = torch.sqrt(torch.abs(hi) ** 2 + torch.abs(hi1) ** 2)
        pos = denom > 0
        safe_d = torch.where(pos, denom, torch.ones_like(denom))
        c = torch.where(pos, hi / safe_d, torch.ones_like(hi))
        s = torch.where(pos, hi1 / safe_d, torch.zeros_like(hi1))
        qi, qi1 = Q[i].clone(), Q[i + 1].clone()
        Q[i] = torch.conj(c) * qi + torch.conj(s) * qi1
        Q[i + 1] = -s * qi + c * qi1
        si = s_vec[i].clone()
        s_vec[i + 1] = -s * si
        s_vec[i] = torch.conj(c) * si
        res = torch.abs(s_vec[i + 1])
        glob_it = it0 + i
        if glob_it <= max_it:
            hit = (res <= tol * norm) & (crossing == 0)
            crossing = torch.where(hit, torch.full_like(crossing, glob_it),
                                   crossing)
        if glob_it >= max_it or bool(torch.all(crossing > 0)):
            break
    return V, _np(H), _np(B), _np(crossing)
