"""Dense Schwarz variant with a user-supplied global operator (counterpart
of ``hpddm_tpu/precond/dense.py``).

The re-design of ``Dense<S, K> : Schwarz`` (include/HPDDM_dense.hpp:40-214),
the variant of boundary-element and H-matrix integrations: the local
matrices are dense, the global matrix-vector product may come from the
user (the pure virtual ``GMV``, HPDDM_dense.hpp:199), the local
eigenproblem is a standard EVP (``solveEVP``, HPDDM_dense.hpp:74-159, a
host ``numpy.linalg.eig`` here as in the JAX package), and the coarse
operator is assembled through that GMV (``UserCoarseOperator``,
HPDDM_operator.hpp:351-377). It keeps the caller's numbering, puts
everything on the card unless the caller passes ``device="cpu"``, and
runs the port's Schwarz runtime (``one_level_apply``, ``deflation``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from hpddm_tpu_torch.core.formats import BatchedDense
from hpddm_tpu_torch.device import DEFAULT, as_device
from hpddm_tpu_torch.ops.local_solve import factorize
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.parallel.ops import exchange, scaled_exchange
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.base import LinearOperator


class DenseSchwarz:
    """Schwarz over dense local blocks and a user global operator."""

    def __init__(self, local_blocks: Sequence[np.ndarray],
                 neighbors: Sequence[Sequence[int]],
                 mappings: Sequence[Sequence[np.ndarray]],
                 d: Optional[Sequence[np.ndarray]] = None,
                 options: Optional[Options] = None,
                 user_gmv: Optional[Callable] = None, device=DEFAULT):
        """user_gmv(x (S, n_max, mu)) -> (S, n_max, mu): the global
        operator on consistent vectors, in the caller's numbering. Without
        it the dense blocks and the scaled exchange give it, as
        ``Schwarz.gmv``. The blocks are padded to n_max with identity
        rows."""
        self.opt = options if options is not None else Options()
        self.device = as_device(device)
        n_loc = [b.shape[0] for b in local_blocks]
        # a user GMV works in the caller's numbering: no renumbering
        self.dec = Decomposition.from_subdomains(
            neighbors, mappings, n_loc, d=d, renumber=False,
            device=self.device)
        self.n_max = self.dec.n_max
        S = len(local_blocks)
        dtype = np.result_type(*[b.dtype for b in local_blocks])
        dense = np.zeros((S, self.n_max, self.n_max), dtype=dtype)
        for s, b in enumerate(local_blocks):
            dense[s, : b.shape[0], : b.shape[1]] = b
            pad = np.arange(b.shape[0], self.n_max)
            dense[s, pad, pad] = 1.0
        self.A = BatchedDense(values=torch.as_tensor(dense,
                                                     device=self.device),
                              n_max=self.n_max)
        del dense
        self.blocks = local_blocks
        self.user_gmv = user_gmv
        self._deflation: Optional[List[np.ndarray]] = None
        self._state: Optional[sz.SchwarzState] = None

    def gmv(self, x: torch.Tensor) -> torch.Tensor:
        if self.user_gmv is not None:
            return self.user_gmv(x)
        return scaled_exchange(self.dec, torch.bmm(self.A.values, x))

    def solve_evp(self, nu: Optional[int] = None) -> int:
        """Standard local EVP: the nu dominant eigenvectors of each dense
        block, orthonormalized (Dense::solveEVP; host numpy ``eig``)."""
        if nu is None:
            nu = int(self.opt.val("geneo_nu"))
        vecs = []
        for b in self.blocks:
            cplx = np.iscomplexobj(b)
            w, v = np.linalg.eig(np.asarray(
                b, dtype=np.complex128 if cplx else np.float64))
            V = v[:, np.argsort(-np.abs(w))[:nu]]
            if not cplx:
                V = np.real(V)
            q, _ = np.linalg.qr(V)
            vecs.append(np.ascontiguousarray(q))
        self._deflation = vecs
        return nu

    def set_vectors(self, vectors: Sequence[np.ndarray]) -> None:
        """User deflation vectors, one (n_s, nu_s) array per subdomain."""
        self._deflation = [np.atleast_2d(np.asarray(v)).reshape(
            self.blocks[s].shape[0], -1) for s, v in enumerate(vectors)]

    def build(self) -> LinearOperator:
        """Factorize the blocks (``local_solver``), assemble the coarse
        operator where a correction and vectors are set, and return the
        LinearOperator (gmv, M^-1, the POU weight). The two-level apply is
        ``apply``'s deflated/balanced branch with this object's gmv."""
        solver = factorize(self.A.values, kind=self.opt.val("local_solver"))
        dec = self.dec
        coarse = None
        correction = self.opt.val("schwarz_coarse_correction")
        if correction is not None and self._deflation is not None:
            coarse = self._build_coarse(correction)
        state = sz.SchwarzState(dec=dec, A=self.A, solver=solver,
                                coarse=coarse,
                                variant=self.opt.val("schwarz_method"))
        self._state = state

        def apply(x):
            if coarse is None:
                return sz.one_level_apply(state, x)
            out = sz.deflation(state, x)
            work = scaled_exchange(dec, solver.solve(x - self.gmv(out)))
            if correction == "balanced":
                work = work - sz.deflation(state, self.gmv(work))
            return out + work

        return LinearOperator(gmv=self.gmv, apply=apply, weight=dec.d)

    def _build_coarse(self, correction: str) -> sz.CoarseState:
        """E = Z^H D A (D Z) through the (user) GMV on the exchanged panel
        of every subdomain's D Z_s in its own columns
        (``UserCoarseOperator``); inactive slots get identity rows; E is
        inverted on the host in f64 (c128)."""
        dec = self.dec
        S = dec.S
        vecs = self._deflation
        nu_loc = np.array([v.shape[1] for v in vecs], dtype=np.int32)
        nu_max = int(nu_loc.max(initial=1))
        dtype = self.A.values.dtype
        Z = np.zeros((S, self.n_max, nu_max), dtype=np.asarray(
            vecs[0]).dtype)
        for s, v in enumerate(vecs):
            Z[s, : v.shape[0], : v.shape[1]] = v
        Z = torch.as_tensor(Z, device=self.device).to(dtype)
        DZ = dec.d[:, :, None].to(dtype) * Z
        N_c = S * nu_max
        X0 = torch.zeros((S, self.n_max, N_c), dtype=dtype,
                         device=self.device)
        for s in range(S):
            X0[s, :, s * nu_max: (s + 1) * nu_max] = DZ[s]
        X = exchange(dec, X0)
        del X0
        Y = self.gmv(X)
        E = torch.einsum("snp,sn,snq->pq", X.conj(), dec.d.to(dtype), Y)
        del X, Y
        act = torch.as_tensor(
            (np.arange(nu_max)[None, :] < nu_loc[:, None]).reshape(-1),
            device=self.device)
        keep = act[:, None] & act[None, :]
        E = torch.where(keep, E, torch.eye(N_c, dtype=dtype,
                                           device=self.device))
        E_np = E.cpu().numpy().astype(np.complex128 if E.is_complex()
                                      else np.float64)
        E_inv = torch.as_tensor(np.linalg.inv(E_np),
                                device=self.device).to(dtype)
        return sz.CoarseState(Z=Z, E_inv=E_inv,
                              nu_loc=torch.as_tensor(nu_loc,
                                                     device=self.device),
                              nu_max=nu_max, correction=correction)
