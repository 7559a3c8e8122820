"""Krylov method dispatch (counterpart of ``hpddm_tpu/solvers/krylov.py``),
the analogue of ``IterativeMethod::solve`` (HPDDM_iterative.hpp:1020-1111).

``solve(A, b, x0, opt)`` reads the options (krylov_method, tol, max_it,
restart, variant, orthogonalization) and dispatches. ``A`` is a
``SchwarzState`` (wrapped into a LinearOperator) or any LinearOperator.
This slice ports GMRES; the other methods raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpddm_tpu_torch.dtypes import HPDDM_EPS, HPDDM_PEN, is_low_precision
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as _schwarz
from hpddm_tpu_torch.solvers.base import LinearOperator
from hpddm_tpu_torch.solvers.gmres import KrylovResult, gmres


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
          opt: Optional[Options] = None, prefix: str = "") -> KrylovResult:
    """Dispatch on ``-hpddm_krylov_method``. b and x0: (S, n, mu) or (S, n)
    in the caller's numbering (the general path keeps it)."""
    if opt is None:
        opt = Options()
    opt.warn_inert()
    method = opt.val("krylov_method", prefix=prefix)
    if method != "gmres":
        raise NotImplementedError(
            f"krylov_method {method!r} is not ported yet (ROADMAP queue A, "
            "slice 4); use 'gmres'")
    enlarge = opt.val("enlarge_krylov_subspace")
    if enlarge and int(enlarge) > 1:
        raise NotImplementedError(
            "-hpddm_enlarge_krylov_subspace is not ported yet (ROADMAP "
            "queue A, slice 4)")
    op = make_operator(A)
    ortho = opt.val("orthogonalization", prefix=prefix)
    if not opt.set("orthogonalization", prefix=prefix) and \
            is_low_precision(b.dtype):
        # below f64 the default is iterated CGS, as in the JAX package:
        # plain CGS loses orthogonality over long bases
        ortho = "cgs2"
    if b.dim() == 2:                       # (S, n) convenience: one RHS
        b = b[:, :, None]
    if isinstance(A, _schwarz.SchwarzState) and A.coarse is not None \
            and A.coarse.E_inv.dtype != b.dtype:
        # the JAX package switches to flexible GMRES here: a coarse solve
        # in another precision makes M^-1 vary between applications
        raise NotImplementedError(
            "a coarse operator in another dtype than b needs flexible GMRES, "
            "which is not ported yet (ROADMAP queue A, slice 4)")
    if x0 is None and isinstance(A, _schwarz.SchwarzState) \
            and A.bc is not None:
        # Schwarz::start (HPDDM_schwarz.hpp:496-514): seed the initial
        # guess exactly on detected Dirichlet rows
        x0 = _schwarz.start(A, b)
    return gmres(op, b, x0, tol=float(opt.val("tol", prefix=prefix)),
                 restart=int(opt.val("gmres_restart")),
                 max_it=int(opt.val("max_it", prefix=prefix)),
                 variant=opt.val("variant", prefix=prefix), ortho=ortho)
