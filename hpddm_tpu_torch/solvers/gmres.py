"""Restarted GMRES (counterpart of ``hpddm_tpu/solvers/gmres.py``).

Pseudo-block over multiple right-hand sides, as the reference
(include/HPDDM_GMRES.hpp:30-158):

* left, right or flexible preconditioning (``-hpddm_variant``),
* CGS orthogonalization (one Gram product), iterated CGS (``cgs2``) or
  MGS (one dot per basis vector),
* Givens-updated residual norms through the accumulated rotation product
  (HPDDM_iterative.hpp:669-710), the JAX package's arithmetic,
* per-RHS convergence tracking: the reported iteration count is the first
  iteration at which each RHS crossed the tolerance.

The JAX package's ``lax.while_loop`` is a Python loop here; the loop
reads one boolean (all right-hand sides converged) from the device per
iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hpddm_tpu_torch.dtypes import HPDDM_EPS, machine_eps, underlying
from hpddm_tpu_torch.solvers.base import LinearOperator


class KrylovResult(NamedTuple):
    x: torch.Tensor            # (S, n, mu) solution
    iterations: int            # global iteration count (max over RHS)
    it_per_rhs: torch.Tensor   # (mu,) first crossing per RHS
    rel_res: torch.Tensor      # (mu,) final Givens residual estimate / norm(b)
    converged: torch.Tensor    # (mu,) bool
    # (max_it + 1, mu) per-iteration relative residual estimates, -1 where
    # not reached
    history: Optional[torch.Tensor] = None


def first_crossing(first_it: torch.Tensor, crossed: torch.Tensor,
                   it: int) -> torch.Tensor:
    """Record iteration ``it`` for the right-hand sides crossing now."""
    return torch.where((first_it == 0) & crossed,
                       torch.full_like(first_it, it), first_it)


def krylov_result(x: torch.Tensor, first_it: torch.Tensor, it: int,
                  max_it: int, rel_res: torch.Tensor,
                  history: torch.Tensor) -> KrylovResult:
    """The result of a loop that stopped before global iteration ``it``:
    a right-hand side that never crossed reports the iterations run."""
    it_per_rhs = torch.where(first_it > 0, first_it,
                             torch.full_like(first_it, min(it - 1, max_it)))
    return KrylovResult(x=x, iterations=int(torch.max(it_per_rhs)),
                        it_per_rhs=it_per_rhs, rel_res=rel_res,
                        converged=first_it > 0, history=history)


def _givens(a, b):
    """Givens rotation (c, s, r): with G = [[conj(c), conj(s)], [-s, c]],
    G [a; b] = [r; 0] and r = sqrt(|a|^2 + |b|^2) real."""
    denom = torch.sqrt(torch.abs(a) ** 2 + torch.abs(b) ** 2)
    pos = denom > 0
    safe = torch.where(pos, denom, torch.ones_like(denom))
    c = torch.where(pos, a / safe, torch.ones_like(a))
    s = torch.where(pos, b / safe, torch.zeros_like(b))
    return c, s, denom


def _tri_solve_masked(H: torch.Tensor, s: torch.Tensor,
                      count: torch.Tensor) -> torch.Tensor:
    """Solve the (count x count) upper-triangular LS system per RHS.

    H: (m, m+1, mu), H[k] is the rotated Arnoldi column k (rows 0..m-1 form
    R); s: (m+1, mu) rotated residual coefficients; count: (mu,) columns in
    use per RHS. Returns y (m, mu) with y[j] = 0 for j >= count."""
    m = H.shape[0]
    mu = s.shape[-1]
    y = H.new_zeros((m, mu))
    k = torch.arange(m, device=H.device)[:, None]
    for j in range(m - 1, -1, -1):
        # sum_{k>j} R[j,k] y[k] ; R[j,k] = H[k, j]
        acc = torch.sum(torch.where(k > j, H[:, j, :] * y, 0), dim=0)
        diag = H[j, j, :]
        safe = torch.where(torch.abs(diag) > 0, diag, torch.ones_like(diag))
        yj = (s[j] - acc) / safe
        y[j] = torch.where(j < count, yj, torch.zeros_like(yj))
    return y


def gmres(op: LinearOperator, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, tol: float = 1.0e-6,
          restart: int = 40, max_it: int = 100, variant: str = "right",
          ortho: str = "cgs") -> KrylovResult:
    """Solve A x = b with (preconditioned) restarted GMRES.

    b, x0: (S, n, mu). ``variant`` in {"left", "right", "flexible"};
    ``ortho`` in {"cgs", "cgs2", "mgs"}."""
    if variant not in ("left", "right", "flexible"):
        raise ValueError(f"unknown GMRES variant {variant!r}")
    if ortho not in ("cgs", "cgs2", "mgs"):
        raise ValueError(f"unknown orthogonalization {ortho!r}")
    x = torch.zeros_like(b) if x0 is None else x0
    S, n, mu = b.shape
    m = int(restart)
    dtype = b.dtype
    rdtype = underlying(dtype)
    dev = b.device
    eps2 = machine_eps(dtype) ** 2
    left = variant == "left"
    flexible = variant == "flexible"

    # initializeNorm: the convergence reference is ||b|| for right and
    # flexible preconditioning, ||M^-1 b|| for left
    # (HPDDM_iterative.hpp:922-onwards)
    norm = torch.sqrt(op.init_norm_sq(op.apply(b) if left else b)).to(rdtype)
    norm = torch.where(norm < HPDDM_EPS, torch.ones_like(norm), norm)

    it = 1                                   # global iteration counter
    first_it = torch.zeros(mu, dtype=torch.int64, device=dev)
    res = torch.full((mu,), float("inf"), dtype=rdtype, device=dev)
    hist = torch.full((max_it + 1, mu), -1.0, dtype=rdtype, device=dev)
    stop = False
    while not stop:
        cycle_it = it
        r = b - op.gmv(x)
        if left:
            r = op.apply(r)
        beta_sq = op.norm_sq(r)
        beta = torch.sqrt(beta_sq).to(rdtype)
        breakdown = bool(torch.all(beta_sq < eps2))
        safe_beta = torch.where(beta > 0, beta, torch.ones_like(beta))

        V = b.new_zeros((m + 1, S, n, mu))
        V[0] = r / safe_beta
        # flexible: the preconditioned directions, kept for the update
        Z = b.new_zeros((m, S, n, mu)) if flexible else None
        H = b.new_zeros((m, m + 1, mu))
        # accumulated rotation product Q: applying all previous Givens
        # rotations to a new column is one small matvec
        Q = torch.eye(m + 1, dtype=dtype, device=dev)[:, :, None] \
            .repeat(1, 1, mu)
        svec = b.new_zeros((m + 1, mu))
        svec[0] = beta.to(dtype)

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
            # --- orthogonalization against V[0..i] (rows above are zero) --
            Vi = V[: i + 1]
            h = b.new_zeros((m + 1, mu))
            if ortho == "mgs":
                for j in range(i + 1):
                    h[j] = op.dot(V[j], w)
                    w = w - h[j] * V[j]
            else:
                h[: i + 1] = op.gram(Vi, w)
                w = w - torch.einsum("km,ksnm->snm", h[: i + 1], Vi)
            if ortho == "cgs2":
                # iterated CGS: one extra Gram pass, folded into the same h
                h2 = op.gram(Vi, w)
                w = w - torch.einsum("km,ksnm->snm", h2, Vi)
                h[: i + 1] = h[: i + 1] + h2
            hn = torch.sqrt(op.norm_sq(w)).to(dtype)
            safe_hn = torch.where(torch.abs(hn) > 0, hn, torch.ones_like(hn))
            V[i + 1] = w / safe_hn
            h[i + 1] = hn

            # --- apply all previous rotations in one matvec ---------------
            h = torch.einsum("ijm,jm->im", Q, h)
            c, s_, rr = _givens(h[i], h[i + 1])
            h[i] = rr.to(dtype)
            h[i + 1] = 0
            # fold the new rotation into the product: rows i, i+1 of Q
            qi, qi1 = Q[i].clone(), Q[i + 1].clone()
            Q[i] = torch.conj(c) * qi + torch.conj(s_) * qi1
            Q[i + 1] = -s_ * qi + c * qi1
            si = svec[i].clone()
            svec[i + 1] = -s_ * si
            svec[i] = torch.conj(c) * si
            H[i] = h

            res = torch.abs(svec[i + 1])
            crossed = res <= tol * norm
            first_it = first_crossing(first_it, crossed, it)
            hist[min(it, max_it)] = (res / norm).to(rdtype)
            all_conv = bool(torch.all(crossed))
            i += 1
            it += 1

        # --- solution update (updateSol: HPDDM_iterative.hpp:272-336) ----
        count = torch.where(first_it > 0,
                            torch.clamp(first_it - cycle_it + 1, max=i),
                            torch.full_like(first_it, i))
        y = _tri_solve_masked(H, svec, count)
        col = torch.arange(m, device=dev)[:, None] < count
        y = torch.where(col, y, torch.zeros_like(y))
        if flexible:
            x = x + torch.einsum("km,ksnm->snm", y, Z)
        else:
            u = torch.einsum("km,ksnm->snm", y, V[:m])
            x = x + (u if left else op.apply(u))
        stop = all_conv or it > max_it or breakdown

    return krylov_result(x, first_it, it, max_it, res / norm, hist)
