#!/usr/bin/env python
"""Unstructured P1 FEM Schwarz driver of the port, the twin of ``examples/unstructured.py``:

    python -m hpddm_tpu_torch.examples.unstructured -N 8 -Nx 60 \
        [-overlap 2] [-Nz 0] [-grading 0.5] [-contrast 1e4] \
        [-hpddm_schwarz_coarse_correction deflated] [-hpddm_geneo_nu 8] \
        [-device cuda|cpu] [-hpddm_* ...]

A jittered Delaunay FEM Laplacian (optionally graded, with a
high-coefficient channel), partitioned algebraically (k-way graph
partition, or coordinate boxes above 200,000 mesh points), with
RCM-ordered local numbering, ELL local matrices and two-level GenEO-RAS on
the FEM Neumann matrices (``-hpddm_local_solver banded``: RCM banded
exact local solves, and Lanczos GenEO). Runs on the card unless -device
cpu is given (without a CUDA device, -device cuda raises). Vectors are
f64 on both
(the card runs f64 natively; the JAX driver drops to f32 only on the TPU,
which has no f64). Exits 0 when GMRES converges within 60 iterations and
the true residual on the assembled global system is at most 1e-6, the
JAX driver's f64 gate (``examples/unstructured.py:69-80``).
"""

import sys

import numpy as np
import torch


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.models import unstructured
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz
    from hpddm_tpu_torch.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<8>", "Number of subdomains."),
           ("Nx=<60>", "Mesh points per side."),
           ("overlap=<2>", "Overlap growth rounds."),
           ("Nz=<0>", "3-D: mesh points along z (0 = 2-D triangles)."),
           ("grading=<0.0>", "Mesh grading toward the origin."),
           ("contrast=<1.0>", "Coefficient contrast of the channel."),
           ("device=(cuda|cpu)", "Device of the batched subdomains.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S = int(opt.app()["N"])
    nx = int(opt.app()["Nx"])
    device = as_device(opt.app().get("device", DEFAULT))
    contrast = float(opt.app()["contrast"])
    kap = None
    if contrast != 1.0:
        kap = (lambda x, y: np.where((y > 0.33) & (y < 0.66),
                                     contrast, 1.0))
    two_level = opt.val("schwarz_coarse_correction") is not None
    nz = int(opt.app()["Nz"])
    if kap is not None and nz:
        kap2d = kap
        kap = (lambda x, y, z: kap2d(x, y))
    gen = unstructured.generate(
        S, nx, nx, nz=nz, overlap=int(opt.app()["overlap"]), kappa=kap,
        grading=float(opt.app()["grading"]), with_neumann=two_level,
        partition="geometric" if nx * nx * max(nz, 1) > 200000
        else "kway")

    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d, options=opt,
                  device=device)
    if two_level:
        sch.solve_gevp(gen.neumann)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1))
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    res = solve(state, torch.as_tensor(f, device=device), opt=opt)

    # true residual on the assembled global system
    xs = res.x.cpu().numpy()
    N = gen.A_global.shape[0]
    xg = np.zeros(N)
    for s in range(S):
        xg[gen.gids[s]] = xs[s, : gen.n_loc[s], 0]
    fg = np.where(gen.boundary, 0.0, 1.0)
    rel = np.linalg.norm(gen.A_global @ xg - fg) / np.linalg.norm(fg)
    print(f" --- true residual = {rel:.6e}")
    print(f"iterations: {int(res.iterations)}")
    return 0 if (int(res.iterations) <= 60 and rel <= 1e-6) else 1


if __name__ == "__main__":
    sys.exit(main())
