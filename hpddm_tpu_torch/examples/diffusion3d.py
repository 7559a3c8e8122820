#!/usr/bin/env python
"""3D diffusion driver of the port, the twin of ``examples/diffusion3d.py``:
two-level GenEO-RAS on the 7-point stencil.

    python -m hpddm_tpu_torch.examples.diffusion3d -N 8 -Nx 16 \
        -contrast 1e3 [-device cuda|cpu] \
        [-hpddm_schwarz_coarse_correction deflated -hpddm_geneo_nu 6] \
        [-hpddm_coarse_assembly bsr] [-hpddm_local_solver banded]

The problem is ``diffusion3d.generate_uniform(N, Nx, Nx, Nx)`` with a
checkerboard coefficient of the given contrast (above 1). With
``-hpddm_local_solver banded`` the local solves are banded on the boxes in
plane-major order: (k1 - k0) z-planes of (i1 - i0)(j1 - j0) unknowns
(``set_banded_shapes``; the 7-point operator is block-tridiagonal in
z-planes). Exits non-zero unless the reference's oracle holds (recomputed
relative residual <= 1e-2 and iterations <= 45, 75 on one subdomain).
"""

import sys

import numpy as np
import torch


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.models import diffusion3d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu_torch.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<8>", "Number of subdomains."),
           ("Nx=<16>", "Grid points per direction."),
           ("overlap=<1>", "Overlap width."),
           ("contrast=<1.0>", "Checkerboard coefficient contrast."),
           ("generate_random_rhs=<0>", "Number of random RHS."),
           ("device=(cuda|cpu)", "Device of the batched subdomains.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S = int(opt.app()["N"])
    N = int(opt.app()["Nx"])
    overlap = int(opt.app()["overlap"])
    contrast = float(opt.app()["contrast"])
    mu = int(opt.app()["generate_random_rhs"])
    device = as_device(opt.app().get("device", DEFAULT))

    kappa = None
    if contrast > 1.0:
        def kappa(x, y, z):
            return np.where((np.floor(x / 2.5) + np.floor(y / 2.5)
                             + np.floor(z / 2.5)) % 2 == 0, 1.0, contrast)

    two_level = opt.val("schwarz_coarse_correction") is not None
    gen = diffusion3d.generate_uniform(S, N, N, N, overlap=overlap,
                                       mu=mu, kappa=kappa,
                                       with_neumann=two_level)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt, device=device)
    if opt.val("local_solver") == "banded":
        sch.set_banded_shapes([(k1 - k0, (i1 - i0) * (j1 - j0))
                               for (i0, i1, j0, j1, k0, k1) in gen.boxes])
    nrhs = max(mu, 1)
    f = np.zeros((S, sch.n_max, nrhs))
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    f = torch.as_tensor(f, device=device)
    if two_level:
        sch.solve_gevp(gen.neumann)
    state = sch.build()
    res = solve(state, f, opt=opt)
    nb, nr = compute_residual(state, res.x, f)
    nb, nr = nb.cpu().numpy(), nr.cpu().numpy()
    it = int(res.iterations)
    for i in range(nrhs):
        print(f" --- residual = {float(abs(nr[i])):e} / "
              f"{float(abs(nb[i])):e}")
    method = (opt.val("krylov_method") or "gmres").upper()
    print(f"{method} converges after {it} iterations")
    rel = np.abs(nr / nb)
    cap = 45 if S > 1 else 75
    if it > cap or np.any(rel > 1e-2):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
