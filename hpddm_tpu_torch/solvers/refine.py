"""Mixed-precision iterative refinement around the device solve (counterpart
of ``hpddm_tpu/solvers/refine.py``).

A single-precision solve bottoms out at a true-residual floor ~ cond(A) *
eps. Iterative refinement with the residual in higher precision lifts it:

    repeat: r = b - A x          (host f64, per-subdomain CSR SpMV)
            e = solve(r)         (device, working precision: the full
                                  preconditioned Krylov solve)
            x = x + e            (host f64)

On the TPU this is how the JAX package reaches f64-grade residuals; on a
card with native f64 it is measured against a plain f64 solve.
``solve_refined_device`` keeps the loop on the device, with double-word
residuals (ops/doubleword.py).

The per-subdomain residual is exact on every row with a complete stencil;
incomplete rows carry zero partition-of-unity weight, so they never enter
the convergence functional.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.ops.doubleword import (dw_add, dw_from, dw_mul_f32,
                                            dw_neg, dw_renorm, spmm_dw)
from hpddm_tpu_torch.parallel.ops import exchange


def solve_refined_device(state, f: torch.Tensor, opt=None,
                         tol: float = 1.0e-12, max_refine: int = 6,
                         verbose: bool = False):
    """Refinement with no host round trip: the solution is the
    double-word pair ``hi + lo`` and ``b - A x`` is computed with
    error-free transforms on the device. The consistency projection
    (POU scaling and copy sum) is applied to hi and lo separately: the
    projected copies are near-equal small residuals, so nothing cancels.

    state: a SchwarzState with DIA or ELL local matrices; f: (S, n_max,
    mu) right-hand side with consistent copies, on the state's device, in
    the caller's numbering; opt: the inner solve's options (e.g. tol=1e-3
    a pass). An interface-first decomposition runs the loop in its own
    numbering and unpermutes x on the host in f64
    (``hpddm_tpu/solvers/refine.py:67,106-110``).

    Returns (x (S, n_max, mu) host f64 array in the caller's numbering,
    info dict with per-pass double-word weighted relative residuals and
    inner iteration counts)."""
    from hpddm_tpu_torch.solvers.krylov import _solve_core

    dec = state.dec
    b = dec.permute(f[:, :, None] if f.dim() == 2 else f)
    d = dec.d[:, :, None]
    nb = torch.sqrt(torch.sum(d * b * b))

    def residual(xh, xl):
        y = spmm_dw(state.A, (xh, xl))
        r = dw_add(dw_from(b), dw_neg(y))
        rh, rl = dw_mul_f32(d, r)
        rh, rl = dw_renorm(exchange(dec, rh), exchange(dec, rl))
        rel = torch.sqrt(torch.sum(d * rh * rh)) / torch.clamp(nb, min=1e-30)
        return rh, float(rel)

    xh = torch.zeros_like(b)
    xl = torch.zeros_like(b)
    history, inner_its = [], []
    for p in range(max_refine):
        rh, rel = residual(xh, xl)
        history.append(rel)
        if verbose:
            print(f"refine pass {p}: dw weighted rel res = {rel:.3e}")
        if rel <= tol:
            break
        res = _solve_core(state, rh, None, opt)
        xh, xl = dw_add((xh, xl), dw_from(res.x))
        inner_its.append(int(res.iterations))
    x = xh.double().cpu().numpy() + xl.double().cpu().numpy()
    if dec.renumbered:
        # on the host in f64: a device gather would round the pair first
        x = np.take_along_axis(x, dec.iperm.cpu().numpy()[:, :, None], axis=1)
    return x, {"history": history, "inner_iterations": inner_its}


def _host_consistency(dec, rd: np.ndarray, if_idx: np.ndarray) -> np.ndarray:
    """f64 host replica of ``scaled_exchange`` on an already d-weighted
    residual: every duplicated dof gets the sum of its copies (the
    consistency projector); interior dofs pass through. It reads the
    general exchange's maps, which every decomposition carries, so it
    gives the same result whichever exchange the device runs. if_idx:
    the interface slots' rows in rd's numbering (``_host_system``)."""
    if_mask = dec.if_mask.cpu().numpy()
    partners = dec.partners.cpu().numpy()
    S, m = if_idx.shape
    mu = rd.shape[-1]
    vals = np.take_along_axis(rd, if_idx[:, :, None], axis=1)
    vals = np.where(if_mask[:, :, None], vals, 0.0)
    flat = np.concatenate([vals.reshape(S * m, mu),
                           np.zeros((1, mu))], axis=0)
    summed = vals + flat[partners].sum(axis=2)
    out = rd.copy()
    s_idx = np.broadcast_to(np.arange(S)[:, None], (S, m))
    out[s_idx[if_mask], if_idx[if_mask]] = summed[if_mask]
    return out


def _host_system(mats: Sequence[MatrixCSR], f, dec):
    """(f64 host CSR matrices, f in f64, d in f64, the interface slots'
    rows, device dtype of f), all in the caller's numbering: an
    interface-first decomposition keeps d and if_idx in its own, so both
    are mapped back through perm (the JAX package's ``solve_refined``
    reads them unmapped, ROADMAP C15)."""
    if isinstance(f, torch.Tensor):
        dev_dtype = f.dtype
        f64 = f.detach().to(torch.float64).cpu().numpy()
    else:
        f64 = np.asarray(f, dtype=np.float64)
        dev_dtype = torch.from_numpy(np.zeros(0, np.asarray(f).dtype)).dtype
    d64 = dec.unpermute(dec.d).to(torch.float64).cpu().numpy()
    if_idx = dec.if_idx.cpu().numpy()
    if dec.renumbered:
        if_idx = np.take_along_axis(dec.perm.cpu().numpy(), if_idx, axis=1)
    A_h = [m.scipy(expand=True).tocsr().astype(np.float64) for m in mats]
    return A_h, f64, d64, if_idx, dev_dtype


def _consistent_residual(A_h, f64: np.ndarray, d64: np.ndarray, dec,
                         if_idx: np.ndarray, x: np.ndarray):
    """(r, rel): the host f64 residual f - A x projected onto the
    consistent subspace (already d-weighted and summed), and its weighted
    norm relative to f's; the norm counts every dof class once (the sum
    of d over a class is 1)."""
    r = f64.copy()
    for s, A in enumerate(A_h):
        n = A.shape[0]
        r[s, :n] -= A @ x[s, :n]
    rcons = _host_consistency(dec, d64[:, :, None] * r, if_idx)
    nb = np.sqrt(np.sum(d64[:, :, None] * f64 * f64))
    rel = np.sqrt(np.sum(d64[:, :, None] * rcons * rcons)) / max(nb, 1e-300)
    return rcons, float(rel)


def true_relres(mats: Sequence[MatrixCSR], f, dec, x) -> float:
    """Weighted true relative residual of x (tensor or array, (S, n_max,
    mu)) for the decomposed system, in host f64: the measure
    ``solve_refined`` stops on."""
    A_h, f64, d64, if_idx, _ = _host_system(mats, f, dec)
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float64).cpu().numpy()
    return _consistent_residual(A_h, f64, d64, dec, if_idx,
                                np.asarray(x, dtype=np.float64))[1]


def solve_refined(solve_fn: Callable, mats: Sequence[MatrixCSR], f, dec,
                  tol: float = 1.0e-10, max_refine: int = 5,
                  verbose: bool = False):
    """Iteratively refined solve of the decomposed system.

    solve_fn(b) -> KrylovResult: the device solve of a (S, n_max, mu)
    tensor on dec's device in the device precision (e.g. ``lambda b:
    solve(state, b, opt=opt)``). mats: the host per-subdomain CSR
    matrices. f: (S, n_max, mu) right-hand side (tensor or array, its
    dtype is the device precision), consistent across duplicated dofs.
    mats, f, solve_fn's b and x are in the caller's numbering on either
    layout.
    dec: the Decomposition (partition of unity and consistency
    projector). Each pass projects the host residual onto the consistent
    subspace in f64 first: it is junk on incomplete-stencil rows and its
    duplicated copies disagree by roundoff.

    Returns (x (S, n_max, mu) host f64 array, info dict with per-pass
    weighted true relative residuals and inner iteration counts)."""
    A_h, f64, d64, if_idx, dev_dtype = _host_system(mats, f, dec)
    x = np.zeros(f64.shape, dtype=np.float64)
    history, inner_its = [], []
    for p in range(max_refine):
        rcons, rel = _consistent_residual(A_h, f64, d64, dec, if_idx, x)
        history.append(rel)
        if verbose:
            print(f"refine pass {p}: true weighted rel res = {rel:.3e}")
        if rel <= tol:
            break
        # rounded to the device precision on the host, as the JAX package
        res = solve_fn(torch.from_numpy(rcons).to(dev_dtype)
                       .to(dec.device))
        x += res.x.detach().to(torch.float64).cpu().numpy()
        inner_its.append(int(res.iterations))
    return x, {"history": history, "inner_iterations": inner_its}
