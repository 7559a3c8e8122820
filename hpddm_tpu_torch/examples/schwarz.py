#!/usr/bin/env python
"""Canonical Schwarz driver of the port, the twin of ``examples/schwarz.py``:

    python -m hpddm_tpu_torch.examples.schwarz -N 4 -hpddm_schwarz_method ras \
        -hpddm_schwarz_coarse_correction deflated -hpddm_geneo_nu 10 \
        -hpddm_tol 1e-6 -Nx 100 -Ny 100 -overlap 1 [-device cuda|cpu] \
        [-symmetric_csr 1] [-generate_random_rhs 4] [-nonuniform 1] \
        [-hpddm_krylov_method bgmres] [-hpddm_verbosity 2]

-N picks the number of subdomains, batched on one device: the card unless
-device cpu is given (without a CUDA device, -device cuda raises). Vectors
are f64 on both. ``-hpddm_local_solver banded`` factors the local matrices
as banded through RCM (the generator sets no grid geometry, as in the JAX
driver), and GenEO then runs shift-invert Lanczos. Exits non-zero unless the reference's oracles hold
(iterations <= 45, 60 for bfbcg, independently recomputed residual <= 1e-2,
examples/schwarz.cpp:140-143).
"""

import sys

import numpy as np
import torch


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu_torch.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<4>", "Number of subdomains."),
           ("Nx=<100>", "Number of grid points in the x-direction."),
           ("Ny=<100>", "Number of grid points in the y-direction."),
           ("overlap=<1>", "Number of grid points in the overlap."),
           ("generate_random_rhs=<0>", "Number of random right-hand sides."),
           ("symmetric_csr=(0|1)", "Assemble symmetric matrices."),
           ("nonuniform=(0|1)", "Different numbers of eigenpairs per subdomain."),
           ("device=(cuda|cpu)", "Device of the batched subdomains.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S = int(opt.app()["N"])
    Nx, Ny = int(opt.app()["Nx"]), int(opt.app()["Ny"])
    overlap = int(opt.app()["overlap"])
    mu = int(opt.app()["generate_random_rhs"])
    sym = bool(opt.app().get("symmetric_csr", 0))
    verbosity = int(opt.val("verbosity", 0))
    device = as_device(opt.app().get("device", DEFAULT))
    dtype = np.float64

    two_level = opt.set("schwarz_coarse_correction")
    gen = diffusion2d.generate(S, Nx, Ny, overlap=overlap, sym=sym, mu=mu,
                               with_neumann=two_level, dtype=dtype)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d, options=opt,
                  device=device)
    f = np.zeros((S, sch.n_max, max(mu, 1)), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    f = torch.as_tensor(f, device=device)
    if mu != 0:
        f = sch.exchange_rhs(f)

    if two_level:
        nu = int(opt.val("geneo_nu"))
        if nu > 0:
            nu_req = np.full(S, nu)
            if opt.app().get("nonuniform"):
                nu_req += np.maximum(-nu_req + 1,
                                     np.array([(-1) ** r * r for r in range(S)]))
                if S > 4:
                    nu_req[4] = 0
            nu_loc = sch.solve_gevp(gen.neumann, nu=nu_req)
            if verbosity:
                print(f"GenEO: nu per subdomain = {nu_loc.tolist()}")
        else:
            sch.set_vectors([np.ones((m.n, 1)) for m in gen.mats])

    state = sch.build()
    res = solve(state, f, opt=opt)
    nb, nr = compute_residual(state, res.x, f)
    nb, nr = nb.cpu().numpy(), nr.cpu().numpy()
    it = res.iterations
    rel = nr / nb
    for nu_i, r in enumerate(rel):
        lead = " --- residual = " if nu_i == 0 else "                "
        tail = f" (rhs #{nu_i + 1})" if len(rel) > 1 else ""
        print(f"{lead}{float(nr[nu_i]):.6e} / {float(nb[nu_i]):.6e}{tail}")
    method = opt.val("krylov_method")
    if verbosity:
        print(f"{method.upper()} converges after {it} iteration"
              + ("s" if it != 1 else ""))
    if verbosity >= 2 and res.history is not None:
        for i, v in enumerate(res.history[:, 0].cpu().numpy()):
            if v >= 0:
                print(f"  it {i:4d}  rel res {v:.6e}")

    if it > (60 if method == "bfbcg" else 45):
        return 1
    if np.any(rel > 1.0e-2):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
