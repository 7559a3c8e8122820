"""True block Krylov methods: BGMRES, BCG, BFBCG (counterpart of
``hpddm_tpu/solvers/block.py``).

Re-design of include/HPDDM_GMRES.hpp:159-313 (BGMRES) and
include/HPDDM_CG.hpp:170-484 (BCG / BFBCG), with the JAX package's
arithmetic:

* the small (mu x mu) algebra is dense and batched,
* rank deficiency is handled with eigh-based pseudo-inverses and column
  masking instead of RRQR column pivoting: a direction whose Gram
  eigenvalue falls below the truncation stops contributing (the
  breakdown-free mechanism of BFBCG, Ji & Li),
* the block Hessenberg least-squares problem of BGMRES is solved every
  iteration through regularized normal equations on the full
  (m+1)mu x m*mu matrix with masked columns, as the JAX package does, so
  the eigh truncations see the same matrices.

The JAX package's ``lax.while_loop`` is a Python loop here, with one host
read of the convergence flag per iteration.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpddm_tpu_torch.dtypes import HPDDM_EPS, underlying
from hpddm_tpu_torch.solvers.base import LinearOperator
from hpddm_tpu_torch.solvers.gmres import (KrylovResult, first_crossing,
                                           krylov_result)


def _block_dot(op: LinearOperator, X: torch.Tensor,
               Y: torch.Tensor) -> torch.Tensor:
    """<X, Y> block Gram (mu x mu) with the partition-of-unity weight."""
    return torch.einsum("sna,snb->ab", X.conj(), op.weighted(Y))


def _eigh(G: torch.Tensor):
    """eigh of the Hermitian part (G + G^H) / 2, as ``jnp.linalg.eigh``
    symmetrizes its input by default: a Gram matrix of a nonsymmetric
    preconditioned operator, or one rounded by its product, is not exactly
    Hermitian, and torch.linalg.eigh would read its lower triangle only."""
    return torch.linalg.eigh((G + G.mH) / 2)


def _psd_pinv(G: torch.Tensor, rtol: float) -> torch.Tensor:
    """Pseudo-inverse of a small PSD Gram matrix, truncating below rtol."""
    w, v = _eigh(G)
    wmax = torch.max(torch.abs(w))
    keep = w > torch.clamp(rtol * wmax, min=0.0)
    inv_w = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    return (v * inv_w[None, :].to(v.dtype)) @ v.conj().T


def _init_norm(op: LinearOperator, b: torch.Tensor, rdtype) -> torch.Tensor:
    """Per-RHS convergence reference norms, penalty-filtered
    (initializeNorm, HPDDM_iterative.hpp:455-470)."""
    fb = op.norm_filter(b) if op.norm_filter is not None else b
    return torch.sqrt(torch.abs(torch.diagonal(_block_dot(op, fb, fb)))) \
        .to(rdtype)


def _chol_qr(op: LinearOperator, V: torch.Tensor, rtol: float = 1e-14):
    """CholQR of a block V (S, n, mu): V = Q R (HPDDM_iterative.hpp:
    559-582), through the eigh square root of the Gram so that
    rank-deficient columns are neutralized. Returns (Q, R)."""
    w, U = _eigh(_block_dot(op, V, V))
    wmax = torch.max(torch.abs(w))
    keep = w > torch.clamp(rtol * wmax, min=0.0)
    sqrt_w = torch.sqrt(torch.where(keep, w, torch.ones_like(w)))
    zero = torch.zeros_like(w)
    Uh = U.conj().T
    R = (U * torch.where(keep, sqrt_w, zero)[None, :].to(U.dtype)) @ Uh
    R_inv = (U * torch.where(keep, 1.0 / sqrt_w, zero)[None, :].to(U.dtype)) \
        @ Uh
    return torch.einsum("sna,ab->snb", V, R_inv), R


def _gs_qr(op: LinearOperator, V: torch.Tensor, kind: str = "cgs",
           rtol: float = 1e-14):
    """Column Gram-Schmidt QR of a block V (S, n, mu): the ``-hpddm_qr
    cgs|mgs`` paths (HPDDM_iterative.hpp:622-666). cgs does one Gram per
    column, mgs one dot per previous column. Near-dependent columns (norm
    below sqrt(rtol) of their size before orthogonalization) are zeroed,
    like the CholQR pseudo-inverse."""
    S, n, mu = V.shape
    R = V.new_zeros((mu, mu))
    Q = torch.zeros_like(V)
    floor_rel = max(rtol, 1e-30) ** 0.5
    for j in range(mu):
        v = V[:, :, j: j + 1]
        nrm0 = torch.sqrt(torch.abs(op.norm_sq(v)))[0]
        if kind == "cgs":
            # columns >= j of Q are still zero, so the full Gram is
            # masked to the previous columns by itself
            r = _block_dot(op, Q, v)[:, 0]
            v = v - torch.einsum("snk,k->sn", Q, r)[:, :, None]
            R[:, j] = R[:, j] + r
        else:                                                # mgs
            for k in range(j):
                r_kj = op.dot(Q[:, :, k: k + 1], v)[0]
                v = v - r_kj * Q[:, :, k: k + 1]
                R[k, j] = r_kj
        nrm = torch.sqrt(torch.abs(op.norm_sq(v)))[0]
        ok = nrm > floor_rel * torch.clamp(nrm0, min=1e-30)
        safe = torch.where(ok, nrm, torch.ones_like(nrm))
        Q[:, :, j] = torch.where(ok, (v / safe)[:, :, 0],
                                 torch.zeros_like(v[:, :, 0]))
        R[j, j] = torch.where(ok, nrm, torch.zeros_like(nrm)).to(R.dtype)
    return Q, R


def _qr(op: LinearOperator, V: torch.Tensor, kind: str = "cholqr",
        rtol: float = 1e-14):
    """Distributed QR dispatch on ``-hpddm_qr`` (cholqr | cgs | mgs)."""
    if kind in ("cgs", "mgs"):
        return _gs_qr(op, V, kind, rtol)
    return _chol_qr(op, V, rtol)


def _block_ls(H: torch.Tensor, R0: torch.Tensor, cols: int):
    """Per-RHS residuals of the block least-squares problem and its
    solution Y ((m mu) x mu), on the full (m+1)mu x m*mu Hessenberg with the
    block columns >= cols masked; regularized normal equations through the
    eigh pseudo-inverse (sizes (m mu)^2, 160^2 at restart 40 and mu=4)."""
    m1, m, mu, _ = H.shape
    dtype = H.dtype
    rdtype = underlying(dtype)
    Hmat = H.permute(0, 2, 1, 3).reshape(m1 * mu, m * mu)
    col_active = torch.arange(m, device=H.device)[:, None] < cols
    cmask = col_active.expand(m, mu).reshape(-1)
    Hmat = torch.where(cmask[None, :], Hmat, torch.zeros_like(Hmat))
    rhs = H.new_zeros((m1 * mu, mu))
    rhs[:mu] = R0
    Hh = Hmat.conj().T
    G = Hh @ Hmat
    G = G + 10 * torch.finfo(rdtype).eps * torch.trace(G).real \
        * torch.eye(m * mu, dtype=dtype, device=H.device) / (m * mu)
    Y = _psd_pinv(G, 1e-14) @ (Hh @ rhs)
    Y = torch.where(cmask[:, None], Y, torch.zeros_like(Y))
    res = torch.linalg.norm(rhs - Hmat @ Y, dim=0).to(rdtype)
    return Y, res


def bgmres(op: LinearOperator, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None, tol: float = 1.0e-6,
           restart: int = 40, max_it: int = 100, variant: str = "right",
           qr: str = "cholqr") -> KrylovResult:
    """Block GMRES: one Krylov space for all mu right-hand sides. The block
    orthogonalization is one CGS Gram whatever -hpddm_orthogonalization
    says, as in the JAX package, and new blocks are orthonormalized by
    ``qr``."""
    x = torch.zeros_like(b) if x0 is None else x0
    S, n, mu = b.shape
    m = int(restart)
    dtype = b.dtype
    rdtype = underlying(dtype)
    dev = b.device
    left = variant == "left"
    flexible = variant == "flexible"

    norm = _init_norm(op, op.apply(b) if left else b, rdtype)
    norm = torch.where(norm < HPDDM_EPS, torch.ones_like(norm), norm)

    it = 1
    first_it = torch.zeros(mu, dtype=torch.int64, device=dev)
    res = torch.full((mu,), float("inf"), dtype=rdtype, device=dev)
    hist = torch.full((max_it + 1, mu), -1.0, dtype=rdtype, device=dev)
    stop = False
    while not stop:
        r = b - op.gmv(x)
        if left:
            r = op.apply(r)
        Q0, R0 = _qr(op, r, qr)
        V = b.new_zeros((m + 1, S, n, mu))
        V[0] = Q0
        Z = b.new_zeros((m, S, n, mu)) if flexible else None
        # block Hessenberg: H[j, i] is the (mu x mu) block in block-row j,
        # block-column i
        H = b.new_zeros((m + 1, m, mu, mu))
        i = 0
        all_conv = False
        while i < m and it <= max_it and not all_conv:
            if left:
                w = op.apply(op.gmv(V[i]))
            else:
                z = op.apply(V[i])
                w = op.gmv(z)
                if flexible:
                    Z[i] = z
            Vi = V[: i + 1]
            Hcol = torch.einsum("ksna,snb->kab", Vi.conj(), op.weighted(w))
            w = w - torch.einsum("kab,ksna->snb", Hcol, Vi)
            Qn, Rn = _qr(op, w, qr)
            H[: i + 1, i] = Hcol
            H[i + 1, i] = Rn
            V[i + 1] = Qn

            _, res = _block_ls(H, R0, i + 1)
            crossed = res <= tol * norm
            first_it = first_crossing(first_it, crossed, it)
            hist[min(it, max_it)] = (res / norm).to(rdtype)
            all_conv = bool(torch.all(crossed))
            i += 1
            it += 1

        Y, _ = _block_ls(H, R0, i)
        Yb = Y.reshape(m, mu, mu)
        if flexible:
            x = x + torch.einsum("kab,ksna->snb", Yb, Z)
        else:
            u = torch.einsum("kab,ksna->snb", Yb, V[:m])
            x = x + (u if left else op.apply(u))
        stop = all_conv or it > max_it
    return krylov_result(x, first_it, it, max_it, res / norm, hist)


def _block_cg(op: LinearOperator, b: torch.Tensor,
              x0: Optional[torch.Tensor], tol: float, max_it: int,
              rtol: float, qr: Optional[str]) -> KrylovResult:
    """Block CG (qr None, HPDDM_CG.hpp:170-341) or breakdown-free block CG
    (directions re-orthonormalized by ``qr`` every step and truncated at
    rtol, HPDDM_CG.hpp:343-484)."""
    x = torch.zeros_like(b) if x0 is None else x0
    rdtype = underlying(b.dtype)
    mu = b.shape[-1]
    dev = b.device
    norm = _init_norm(op, b, rdtype)
    norm = torch.where(norm < HPDDM_EPS, torch.ones_like(norm), norm)

    r = b - op.gmv(x)
    p = op.apply(r)
    if qr is not None:
        p, _ = _qr(op, p, qr, rtol=rtol)
    it = 1
    first_it = torch.zeros(mu, dtype=torch.int64, device=dev)
    rel = torch.full((mu,), float("inf"), dtype=rdtype, device=dev)
    hist = torch.full((max_it + 1, mu), -1.0, dtype=rdtype, device=dev)
    while it <= max_it and bool(torch.any(first_it == 0)):
        Ap = op.gmv(p)
        pinv = _psd_pinv(_block_dot(op, p, Ap), rtol)
        alpha = pinv @ _block_dot(op, p, r)
        x = x + torch.einsum("sna,ab->snb", p, alpha)
        r = r - torch.einsum("sna,ab->snb", Ap, alpha)
        z = op.apply(r)
        beta = -(pinv @ _block_dot(op, Ap, z))
        p = z + torch.einsum("sna,ab->snb", p, beta)
        if qr is not None:
            p, _ = _qr(op, p, qr, rtol=rtol)
        res = torch.sqrt(torch.abs(torch.diagonal(_block_dot(op, r, r)))) \
            .to(rdtype)
        first_it = first_crossing(first_it, res <= tol * norm, it)
        rel = res / norm
        hist[min(it, max_it)] = rel.to(rdtype)
        it += 1
    return krylov_result(x, first_it, it, max_it, rel, hist)


def bcg(op: LinearOperator, b: torch.Tensor,
        x0: Optional[torch.Tensor] = None, tol: float = 1.0e-6,
        max_it: int = 100, deflation_tol: float = -1.0) -> KrylovResult:
    """Block CG with pseudo-inverse breakdown handling
    (HPDDM_CG.hpp:170-341)."""
    rtol = 1e-12 if deflation_tol <= 0 else deflation_tol
    return _block_cg(op, b, x0, tol, max_it, rtol, None)


def bfbcg(op: LinearOperator, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, tol: float = 1.0e-6,
          max_it: int = 100, deflation_tol: float = 1.0e-4,
          qr: str = "cholqr") -> KrylovResult:
    """Breakdown-free block CG (HPDDM_CG.hpp:343-484): directions are
    M-orthonormalized each step and near-dependent ones deflated by the
    pseudo-inverse truncation at ``deflation_tol``."""
    dtol = deflation_tol if deflation_tol > 0 else 1e-8
    return _block_cg(op, b, x0, tol, max_it, dtol, qr)
