"""Krylov method dispatch (counterpart of ``hpddm_tpu/solvers/krylov.py``),
the analogue of ``IterativeMethod::solve`` (HPDDM_iterative.hpp:1020-1111).

``solve(A, b, x0, opt)`` reads the options (krylov_method, tol, max_it,
restart, variant, orthogonalization, qr, recycling, enlarged Krylov) and
dispatches to gmres, bgmres, cg, bcg, bfbcg, gcrodr, bgcrodr, richardson or
none. ``A`` is a ``SchwarzState`` (wrapped into a LinearOperator) or any
LinearOperator.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpddm_tpu_torch.dtypes import (HPDDM_EPS, HPDDM_PEN, is_low_precision,
                                    underlying)
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as _schwarz
from hpddm_tpu_torch.solvers.base import LinearOperator
from hpddm_tpu_torch.solvers.block import bcg, bfbcg, bgmres
from hpddm_tpu_torch.solvers.cg import cg
from hpddm_tpu_torch.solvers.enlarged import postprocess, preprocess
from hpddm_tpu_torch.solvers.gcrodr import bgcrodr_fused, gcrodr
from hpddm_tpu_torch.solvers.gmres import KrylovResult, gmres
from hpddm_tpu_torch.solvers.richardson import richardson


def make_operator(A) -> LinearOperator:
    """Wrap a SchwarzState (or pass a LinearOperator through)."""
    if isinstance(A, LinearOperator):
        return A
    if isinstance(A, _schwarz.SchwarzState):
        norm_filter = None
        if A.bc is not None:
            def norm_filter(b, _bc=A.bc):
                # initializeNorm (HPDDM_iterative.hpp:455-470): penalty
                # entries contribute b_i / PEN to the reference norm
                big = (torch.abs(_bc[:, :, None]) > HPDDM_EPS) & \
                      (torch.abs(b) > HPDDM_EPS * HPDDM_PEN)
                return torch.where(big, b / HPDDM_PEN, b)
        return LinearOperator(
            gmv=lambda x: _schwarz.gmv(A, x),
            apply=lambda x: _schwarz.apply(A, x),
            weight=A.dec.d,
            norm_filter=norm_filter)
    raise TypeError(f"cannot build an operator from {type(A)}")


def solve(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          opt: Optional[Options] = None, prefix: str = ""):
    """Dispatch on ``-hpddm_krylov_method``. b and x0: (S, n, mu) or (S, n)
    in the caller's numbering; an interface-first decomposition permutes
    them on entry and unpermutes x on exit, two gathers per solve
    (``hpddm_tpu/solvers/krylov.py:55-69``). Returns a ``KrylovResult``,
    or a ``GCRODRResult`` for gcrodr/bgcrodr."""
    dec = A.dec if isinstance(A, _schwarz.SchwarzState) else None
    if dec is None or not dec.renumbered:
        return _solve_core(A, b, x0, opt, prefix)
    b = dec.permute(b[:, :, None] if b.dim() == 2 else b)
    if x0 is not None:
        x0 = dec.permute(x0[:, :, None] if x0.dim() == 2 else x0)
    res = _solve_core(A, b, x0, opt, prefix)
    return res._replace(x=dec.unpermute(res.x))


def _solve_core(A, b: torch.Tensor, x0: Optional[torch.Tensor],
                opt: Optional[Options], prefix: str = ""):
    """``solve`` in the operator's internal numbering."""
    if opt is None:
        opt = Options()
    opt.warn_inert()
    op = make_operator(A)
    schwarz = isinstance(A, _schwarz.SchwarzState)
    method = opt.val("krylov_method", prefix=prefix)
    tol = float(opt.val("tol", prefix=prefix))
    max_it = int(opt.val("max_it", prefix=prefix))
    restart = int(opt.val("gmres_restart"))
    variant = opt.val("variant", prefix=prefix)
    ortho = opt.val("orthogonalization", prefix=prefix)
    if not opt.set("orthogonalization", prefix=prefix) and \
            is_low_precision(b.dtype):
        # below f64 the default is iterated CGS, as in the JAX package:
        # plain CGS loses orthogonality over long bases
        ortho = "cgs2"
    qr_kind = opt.val("qr", prefix=prefix)
    if b.dim() == 2:                       # (S, n) convenience: one RHS
        b = b[:, :, None]
    if x0 is None and schwarz and A.bc is not None:
        # Schwarz::start (HPDDM_schwarz.hpp:496-514): seed the initial
        # guess exactly on detected Dirichlet rows
        x0 = _schwarz.start(A, b)

    # enlarged Krylov: split one RHS into k slices solved as a block
    # (HPDDM_iterative.hpp:735-853)
    enlarge = opt.val("enlarge_krylov_subspace")
    if enlarge and int(enlarge) > 1 and b.shape[-1] == 1 and schwarz and \
            method in ("gmres", "bgmres", "cg", "bcg", "bfbcg"):
        inner = opt.copy()
        inner.remove("enlarge_krylov_subspace")
        if method in ("gmres", "cg"):
            inner["krylov_method"] = {"gmres": "bgmres", "cg": "bcg"}[method]
        res = _solve_core(A, preprocess(A.dec, b, int(enlarge)), None,
                          inner, prefix)
        return res._replace(x=postprocess(res.x),
                            it_per_rhs=res.it_per_rhs[:1],
                            rel_res=res.rel_res[:1],
                            converged=res.converged.all()[None])

    if method == "gmres" and schwarz and A.coarse is not None \
            and variant != "flexible" \
            and (A.coarse.mode in ("iterative", "bsr")
                 or A.coarse.E_inv.dtype != b.dtype):
        # a nested (Krylov) coarse solve, or one in another precision,
        # makes M^-1 vary between applications; flexible GMRES absorbs it
        # (the reference's multilevel and HPDDM_MIXED_PRECISION runs use
        # -hpddm_variant flexible)
        variant = "flexible"
    nonsymmetric = schwarz and (A.variant in ("ras", "oras") or (
        A.coarse is not None
        and A.coarse.correction in ("deflated", "balanced")))
    if method == "gmres" or (method == "cg" and nonsymmetric
                             and not int(opt.val("operator_spd", 0))):
        # CG needs an SPD preconditioner; RAS and the deflated/balanced
        # corrections are nonsymmetric: GMRES instead, as the reference
        # (HPDDM_CG.hpp:40-42)
        return gmres(op, b, x0, tol=tol, restart=restart, max_it=max_it,
                     variant=variant, ortho=ortho)
    if method == "cg":
        return cg(op, b, x0, tol=tol, max_it=max_it)
    if method == "richardson":
        return richardson(op, b, x0, tol=tol, max_it=max_it, damping=float(
            opt.val("richardson_damping_factor")))
    if method == "bgmres":
        return bgmres(op, b, x0, tol=tol, restart=restart, max_it=max_it,
                      variant=variant, qr=qr_kind)
    if method == "bcg":
        return bcg(op, b, x0, tol=tol, max_it=max_it)
    if method == "bfbcg":
        return bfbcg(op, b, x0, tol=tol, max_it=max_it, qr=qr_kind)
    if method in ("gcrodr", "bgcrodr"):
        # gcrodr: pseudo-block recycling (HPDDM_GCRODR.hpp:35-444);
        # bgcrodr with mu > 1: block recycling over one fused block Krylov
        # space (HPDDM_GCRODR.hpp:446-907). The recycled (U, C) pair
        # persists across solve() calls in the Options' per-prefix storage
        # (OptionsPrefix::storage_, HPDDM_option.hpp:444-461);
        # -hpddm_recycle_same_system skips the re-projection of the stored
        # space (HPDDM_GCRODR.hpp:435).
        kw = dict(tol=tol, restart=restart, max_it=max_it,
                  recycle=int(opt.val("recycle", 0)),
                  target=opt.val("recycle_target"),
                  strategy=opt.val("recycle_strategy"),
                  recycled=opt.storage(prefix),
                  same_system=bool(int(opt.val("recycle_same_system", 0))))
        if method == "bgcrodr" and b.shape[-1] > 1:
            res = bgcrodr_fused(op, b, x0, deflation_tol=float(
                opt.val("deflation_tol", -1.0)), **kw)
        else:
            res = gcrodr(op, b, x0, variant=variant, **kw)
        if res.recycled is not None:
            opt.set_storage(res.recycled, prefix)
        return res
    if method == "none":
        # x = M^-1 b, one application, it = 1
        # (HPDDM_KRYLOV_METHOD_NONE, HPDDM_iterative.hpp:1056-1070)
        x = op.apply(b)
        mu = b.shape[-1]
        nb = torch.sqrt(op.norm_sq(b))
        nr = torch.sqrt(op.norm_sq(b - op.gmv(x)))
        rel = (nr / torch.where(nb > 0, nb, torch.ones_like(nb))) \
            .to(underlying(b.dtype))
        return KrylovResult(
            x=x, iterations=1,
            it_per_rhs=torch.ones(mu, dtype=torch.int64, device=b.device),
            rel_res=rel,
            converged=torch.ones(mu, dtype=torch.bool, device=b.device))
    raise ValueError(f"unknown krylov_method {method!r}")
