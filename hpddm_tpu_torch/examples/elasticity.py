#!/usr/bin/env python
"""Heterogeneous linear-elasticity driver of the port, the twin of
``examples/elasticity.py``: two-level GenEO-RAS + (block) GMRES (BASELINE
config 4).

    python -m hpddm_tpu_torch.examples.elasticity -N 4 -Nx 24 \
        -contrast 1e3 [-dim 2|3] [-mu 2] [-device cuda|cpu] \
        [-hpddm_schwarz_coarse_correction deflated -hpddm_geneo_nu 10] \
        [-hpddm_krylov_method bgmres]

-dim 2 is plane-stress Q1 elasticity on Nx x Nx nodes, -dim 3 H8
elasticity on Nx^3 nodes, both clamped at x = 0 by a penalty with a
checkerboard Young's modulus and decomposed by the k-way partition
(overlap 2). -mu > 1 adds random right-hand sides to the model's (block
GMRES with -hpddm_krylov_method bgmres). Exits non-zero unless every
recomputed relative residual is <= 1e-2.
"""

import sys

import numpy as np
import torch

# GMRES(150) iteration counts on the CPU in f64 at the 3D elasticity card
# cell (elasticity3d.generate(8, 24, 24, 24), contrast 1e3, overlap 2,
# k-way partition, inv, tol 1e-6): one level (the JAX package's), GenEO
# nu=10 deflated by Lanczos (the port's: the inv inner solve, 25 CG steps,
# on the Neumann matrices shifted by precond/schwarz.neumann_regularization),
# and by Lanczos on the JAX package, whose shift averages the clamped
# face's penalty rows in and loses the rigid-body modes (ROADMAP queue C,
# C10); tests/test_torch_elasticity.py (-m slow) checks them
E3_ITS = {"one level": 26, "lanczos": 22, "lanczos, JAX shift": 28}


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu_torch.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<4>", "Number of subdomains."),
           ("Nx=<24>", "Nodes per direction."),
           ("contrast=<1e3>", "Young's modulus contrast."),
           ("mu=<1>", "Number of right-hand sides."),
           ("dim=<2>", "Spatial dimension (2 = plane stress Q1, 3 = H8)."),
           ("device=(cuda|cpu)", "Device of the batched subdomains.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S = int(opt.app()["N"])
    Nx = int(opt.app()["Nx"])
    contrast = float(opt.app()["contrast"])
    mu = int(opt.app()["mu"])
    dim = int(opt.app()["dim"])
    device = as_device(opt.app().get("device", DEFAULT))
    if not opt.set("max_it"):
        opt["max_it"] = 400
    if not opt.set("gmres_restart"):
        opt["gmres_restart"] = 200

    if dim == 3:
        from hpddm_tpu_torch.models import elasticity3d
        gen, neumann, _ = elasticity3d.generate(
            S, Nx=Nx, Ny=Nx, Nz=Nx, contrast=contrast, overlap=2)
    else:
        from hpddm_tpu_torch.models import elasticity2d
        gen, neumann, _ = elasticity2d.generate(
            S, Nx=Nx, Ny=Nx, contrast=contrast, overlap=2)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d, options=opt,
                  device=device)
    rng = np.random.default_rng(0)
    f = np.zeros((S, sch.n_max, mu))
    for s in range(S):
        f[s, : gen.n_loc[s], 0] = gen.f[s][:, 0]
        for j in range(1, mu):
            f[s, : gen.n_loc[s], j] = rng.normal(size=gen.n_loc[s])
    f = sch.exchange_rhs(torch.as_tensor(f, device=device))

    if opt.set("schwarz_coarse_correction") and int(opt.val("geneo_nu")) > 0:
        nu_loc = sch.solve_gevp(neumann)
        print(f"GenEO: nu per subdomain = {nu_loc.tolist()}")
    state = sch.build()
    res = solve(state, f, opt=opt)
    nb, nr = compute_residual(state, res.x, f)
    nb, nr = nb.cpu().numpy(), nr.cpu().numpy()
    rel = nr / nb
    print(f"iterations: {res.iterations}")
    for j, r in enumerate(nr):
        print(f" --- residual = {float(r):.6e} / {float(nb[j]):.6e}"
              + (f" (rhs #{j + 1})" if mu > 1 else ""))
    return 0 if np.all(rel <= 1e-2) else 1


if __name__ == "__main__":
    sys.exit(main())
