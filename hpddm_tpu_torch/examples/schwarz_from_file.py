#!/usr/bin/env python
"""Algebraic Schwarz driver for assembled matrices, the port's twin of
``examples/schwarz_from_file.py`` (the reference's schwarzFromFile.cpp +
generateFromFile.cpp):

    python -m hpddm_tpu_torch.examples.schwarz_from_file \\
        -matrix_filename mini.mtx -N 4 -overlap 3 [-rhs_filename ones.txt] \\
        [-device cuda|cpu] [-hpddm_* ...]

Partitions the matrix algebraically (k-way graph partition in place of
METIS), grows the overlap by powers of |A|, and solves with the
configured Schwarz and Krylov methods; a coarse correction takes GenEO on
the algebraic SPSD splitting of the assembled matrix
(``fromfile.spsd_neumann``) in place of user Neumann matrices. Local
numberings are RCM-ordered on the card (band-ordered ELL, the JAX
driver's accelerator choice). In f64. Without -matrix_filename it writes
the 2D diffusion matrix (40x40) to a temporary directory, removed at
exit, and reads it back. Exits 0 when the solve converges or its
recomputed relative residual is at most 1e-2.
"""

import os
import sys
import tempfile

import numpy as np
import torch


def main(argv=None):
    from hpddm_tpu_torch.core.csr import MatrixCSR
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.models import fromfile
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu_torch.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<4>", "Number of subdomains."),
           ("overlap=<1>", "Overlap growth rounds."),
           ("matrix_filename=<input_file>", "Matrix file (mtx or HPDDM dump)."),
           ("rhs_filename=<input_file>", "RHS file (one value per line)."),
           ("device=(cuda|cpu)", "Device of the batched subdomains.")]
    opt = Options.parse(argv, display=True, app_options=app)
    device = as_device(opt.app().get("device", DEFAULT))
    dtype = np.float64
    path = opt.app().get("matrix_filename")
    with tempfile.TemporaryDirectory() as tmp:
        if not path or not isinstance(path, str):
            from hpddm_tpu_torch.models import diffusion2d
            path = os.path.join(tmp, "hpddm_tpu_torch_dump.txt")
            diffusion2d.generate(1, 40, 40).mats[0].dump(path)
            print(f"dumped generated matrix to {path}")
        A = MatrixCSR.from_file(path, dtype=dtype)
    rhs_path = opt.app().get("rhs_filename")
    f_global = None
    if isinstance(rhs_path, str) and rhs_path:
        f_global = np.loadtxt(rhs_path).astype(dtype)

    S = int(opt.app()["N"])
    gen = fromfile.decompose(A, S, overlap=int(opt.app()["overlap"]),
                             f_global=f_global,
                             rcm_local=device.type == "cuda")
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d, options=opt,
                  device=device)
    if opt.val("schwarz_coarse_correction") is not None:
        # fully algebraic GenEO: the SPSD splitting of the assembled
        # matrix stands in for user Neumann matrices (the PCHPDDM +
        # aldaas2021robust front end)
        sch.solve_gevp(fromfile.spsd_neumann(gen))
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    f = torch.as_tensor(f, device=device)

    state = sch.build()
    res = solve(state, f, opt=opt)
    nb, nr = compute_residual(state, res.x, f)
    nb, nr = float(nb[0]), float(nr[0])
    print(f" --- residual = {nr:.6e} / {nb:.6e}")
    print(f"iterations: {int(res.iterations)}")
    return 0 if (bool(res.converged.all()) or nr / nb <= 1e-2) else 1


if __name__ == "__main__":
    sys.exit(main())
