#!/usr/bin/env python
"""Matrix-free solves through user callbacks, the port's twin of
``examples/custom_operator.py`` (the reference's
``HpddmCustomOperatorSolve`` examples, examples/custom_operator.c:34-53,
custom_operator.f90): the Krylov layer driven by a user ``mv``/``apply``
pair with no assembled matrix. On "rank" s of S, out_i = (n s + i + 2) x_i
- 0.5 x_{i-1} - 0.5 x_{i+1} within the local block, preconditioned by the
diagonal inverse; the S ranks are one batched program on the device.

    python -m hpddm_tpu_torch.examples.custom_operator -n 100 -mu 2 -S 4 \\
        [-device cuda|cpu] \\
        [-hpddm_krylov_method gmres|cg|bgmres|bcg|bfbcg|gcrodr ...]

In f64. Exits 0 when the recomputed true residual of every right-hand
side is at most 100 times the tolerance.
"""

import sys

import numpy as np
import torch


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.base import LinearOperator
    from hpddm_tpu_torch.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("n=<100>", "Size of the local operators."),
           ("mu=<2>", "Number of generated random right-hand sides."),
           ("S=<4>", "Number of batched \"ranks\"."),
           ("device=(cuda|cpu)", "Device of the batched ranks.")]
    opt = Options.parse(argv, display=True, app_options=app)
    n = int(opt.app()["n"])
    mu = int(opt.app()["mu"])
    S = int(opt.app()["S"])
    device = as_device(opt.app().get("device", DEFAULT))

    diag = torch.as_tensor(np.arange(S)[:, None] * n + np.arange(n)[None, :]
                           + 2.0, device=device)

    def mv(x):
        up = torch.cat([x[:, 1:, :], torch.zeros_like(x[:, :1, :])], dim=1)
        dn = torch.cat([torch.zeros_like(x[:, :1, :]), x[:, :-1, :]], dim=1)
        return diag[:, :, None] * x - 0.5 * up - 0.5 * dn

    def prec(x):
        return x / diag[:, :, None]

    op = LinearOperator(gmv=mv, apply=prec)
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.uniform(0.0, 100.0, (S, n, mu)), device=device)
    res = solve(op, b, opt=opt)
    tol = float(opt.val("tol", 1.0e-6))
    # per right-hand side, as the reference checks convergence: a
    # Frobenius norm can hide one stalled column behind converged ones
    r = mv(res.x) - b
    rel_cols = (torch.linalg.norm(r.reshape(-1, mu), dim=0)
                / torch.linalg.norm(b.reshape(-1, mu), dim=0))
    rel = float(rel_cols.max())
    print(f"{opt.val('krylov_method', 'gmres')}: {int(res.iterations)} "
          f"iterations, worst per-RHS true relative residual {rel:.2e}")
    return 0 if rel <= 100.0 * tol else 1


if __name__ == "__main__":
    sys.exit(main())
