"""Schur-complement solves for saddle-point systems (counterpart of
``hpddm_tpu/precond/saddle.py``).

The counterpart of the reference's PCHPDDM saddle-point support
(interface/petsc/pc/pchpddm.cxx:21, ``-pc_hpddm_schur_precondition``): the
velocity block A of

    [[A, B^T], [B, 0]] [u; p] = [f; g]

is solved by the port's Schwarz machinery (any configured Schwarz, GenEO
where Neumann matrices are given), and the pressure Schur complement
S = B A^-1 B^T by an outer CG preconditioned with the scaled inverse
pressure mass matrix (on a MAC grid Mp = h^2 I), with the constant
pressure projected out (enclosed flow).

``SaddleSolver.solve``:
  1. rhs = B A^-1 f - g                    (one inner DD solve)
  2. CG on S p = rhs, each S apply one inner DD solve
  3. u = A^-1 (f - B^T p)                  (one inner DD solve)

The outer CG runs in numpy on the host, as in the JAX package; each inner
solve is the port's ``solvers.krylov.solve`` on the decomposed velocity
block, with one copy of its right-hand side to the device and one of its
solution back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hpddm_tpu_torch.device import DEFAULT
from hpddm_tpu_torch.options import Options


class SaddleResult(NamedTuple):
    u: np.ndarray            # (n_vel,) velocity, global numbering
    p: np.ndarray            # (n_p,) pressure (zero mean)
    outer_iterations: int
    inner_iterations: int    # summed over every A^-1 apply
    rel_res: float           # outer Schur-residual reduction


class SaddleSolver:
    """Host-orchestrated Schur-complement CG around the port's DD
    solves."""

    def __init__(self, gen, B, options: Optional[Options] = None,
                 mp_inv_scale: Optional[float] = None, neumann=None,
                 device=DEFAULT):
        """gen: the ``FromFileGenerated`` decomposition of A
        (models/stokes2d or any fromfile decomposition); B: (n_p, n_vel)
        scipy matrix; mp_inv_scale: the scale of the pressure
        preconditioner (default 1.0); neumann: Neumann matrices for GenEO
        on the inner solves, used where a coarse correction is set."""
        from hpddm_tpu_torch.precond.schwarz import Schwarz

        self.opt = options if options is not None else Options()
        self.gen = gen
        self.B = B.tocsr()
        self.S = len(gen.mats)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=self.opt, device=device)
        if neumann is not None and \
                self.opt.val("schwarz_coarse_correction") is not None:
            sch.solve_gevp(neumann)
        self.sch = sch
        self.state = sch.build()
        self._inner_its = 0
        self.n_vel = self.B.shape[1]
        # global <-> decomposed maps: every local row, and the owned ones
        s_idx = np.concatenate([np.full(len(g), s) for s, g in
                                enumerate(gen.gids)])
        r_idx = np.concatenate([np.arange(len(g)) for g in gen.gids])
        gid = np.concatenate(gen.gids)
        own = gen.owner[gid] == s_idx
        self._rows = (s_idx, r_idx, gid)
        self._owned = (s_idx[own], r_idx[own], gid[own])
        self.mp_inv_scale = 1.0 if mp_inv_scale is None \
            else float(mp_inv_scale)

    def _to_local(self, x_global: np.ndarray) -> torch.Tensor:
        s_idx, r_idx, gid = self._rows
        out = np.zeros((self.S, self.sch.n_max, 1), dtype=x_global.dtype)
        out[s_idx, r_idx, 0] = x_global[gid]
        return torch.as_tensor(out, device=self.sch.device)

    def _to_global(self, x_loc: torch.Tensor) -> np.ndarray:
        x_np = x_loc.cpu().numpy()
        s_idx, r_idx, gid = self._owned
        out = np.zeros(self.n_vel, dtype=x_np.dtype)
        out[gid] = x_np[s_idx, r_idx, 0]
        return out

    def a_solve(self, b_global: np.ndarray) -> np.ndarray:
        """x = A^-1 b through the DD solve (global numbering); its
        iterations are added to the inner count."""
        from hpddm_tpu_torch.solvers.krylov import solve

        res = solve(self.state, self._to_local(b_global), opt=self.opt)
        self._inner_its += int(res.iterations)
        return self._to_global(res.x)

    def solve(self, f: np.ndarray, g: np.ndarray, tol: float = 1.0e-8,
              max_it: int = 200) -> SaddleResult:
        B = self.B
        n_p = B.shape[0]
        self._inner_its = 0

        def proj(q):                       # remove the constant nullspace
            return q - q.mean()

        def s_apply(p):
            return proj(B @ self.a_solve(B.T @ p))

        rhs = proj(B @ self.a_solve(f) - g)
        p = np.zeros(n_p)
        r = rhs.copy()
        z = self.mp_inv_scale * r
        d = z.copy()
        rz = float(r @ z)
        nrm0 = np.linalg.norm(rhs)
        nrm0 = nrm0 if nrm0 > 0 else 1.0
        it = 0
        rel = 1.0
        while it < max_it:
            q = s_apply(d)
            alpha = rz / float(d @ q)
            p += alpha * d
            r -= alpha * q
            rel = np.linalg.norm(r) / nrm0
            it += 1
            if rel <= tol:
                break
            z = self.mp_inv_scale * r
            rz_new = float(r @ z)
            d = z + (rz_new / rz) * d
            rz = rz_new
        p = proj(p)
        u = self.a_solve(f - B.T @ p)
        return SaddleResult(u=u, p=p, outer_iterations=it,
                            inner_iterations=self._inner_its,
                            rel_res=float(rel))
