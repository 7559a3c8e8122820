"""Symmetric Jacobi (diagonal) scaling of a decomposed system (counterpart of
``hpddm_tpu/core/scaling.py``; host scipy, the same arithmetic).

    A~ = S A S,  b~ = S b,  x = S x~,  S = diag(A)^(-1/2)

removes the coefficient magnitude from the spectrum (the scaled matrix has
unit diagonal), which a single-precision solve of a high-contrast problem
needs. GenEO pencils stay consistent by scaling the Neumann matrices with
the same S (the GEVP is invariant under a congruence of both matrices).

Works on the decomposed data: the local diagonal equals the global one on
every duplicated row (the overlap carries complete rows; only the zero-POU
outer layer is incomplete, and its d=0 makes its scaling irrelevant).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from hpddm_tpu_torch.core.csr import MatrixCSR


def jacobi_scale(mats: Sequence[MatrixCSR],
                 f: Optional[Sequence[np.ndarray]] = None,
                 neumann: Optional[Sequence[MatrixCSR]] = None
                 ) -> Tuple[List[MatrixCSR], Optional[List[np.ndarray]],
                            Optional[List[MatrixCSR]], List[np.ndarray]]:
    """Scale local matrices (and right-hand sides / Neumann matrices)
    symmetrically. Returns (scaled_mats, scaled_f, scaled_neumann, s_list)
    with s_list[k] = diag(A_k)^(-1/2); the solution of the original system
    is x_k = s_list[k] * x~_k (``unscale_solution``)."""
    out_m, out_f, out_n, s_list = [], None, None, []
    for m in mats:
        A = m.scipy(expand=True).tocsr()
        d = np.asarray(A.diagonal(), dtype=np.float64)
        s = 1.0 / np.sqrt(np.where(np.abs(d) > 0, np.abs(d), 1.0))
        s_list.append(s.astype(m.dtype))
        out_m.append(MatrixCSR((sp.diags(s) @ A @ sp.diags(s))
                               .astype(m.dtype)))
    if f is not None:
        out_f = [np.asarray(fk) * s_list[k][:, None]
                 for k, fk in enumerate(f)]
    if neumann is not None:
        out_n = []
        for k, m in enumerate(neumann):
            A = m.scipy(expand=True).tocsr()
            S = sp.diags(s_list[k].astype(np.float64))
            out_n.append(MatrixCSR((S @ A @ S).astype(m.dtype)))
    return out_m, out_f, out_n, s_list


def unscale_solution(x: torch.Tensor, s_list) -> torch.Tensor:
    """x~ (S, n_max, mu) -> x in the original variables, on x's device."""
    out = x.clone()
    for k, s in enumerate(s_list):
        out[k, : len(s)] *= torch.as_tensor(s, device=x.device)[:, None]
    return out
