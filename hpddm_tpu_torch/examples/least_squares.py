#!/usr/bin/env python
"""Sparse least squares, CGLS with algebraic domain decomposition on the
normal equations: the port's twin of ``examples/least_squares.py`` (the
reference's least-squares CI workflow,
.github/workflows/aldaas2021robust.sh:28-56: KSPLSQR + PCHPDDM on the
normal equations of rectangular matrices). Without a file argument a
regularized grid-gradient problem is generated (A = [grad; sqrt(delta) I],
so A^T A = graph Laplacian + delta I, near-singular as delta -> 0, where
the GenEO coarse space pays).

    python -m hpddm_tpu_torch.examples.least_squares -N 16 -Nx 48 \\
        [-hpddm_schwarz_coarse_correction additive -hpddm_geneo_nu 8] \\
        [-matrix_filename path/to/rect.mtx] [-device cuda|cpu]

The Schwarz preconditioner applies on the device, the CGLS recurrence on
the host. Exits 0 when CGLS reaches the tolerance and the recomputed
||A^T r|| / ||A^T b|| is at most 10 times it.
"""

import sys

import numpy as np
import scipy.sparse as sp


def gradient_problem(nx, delta=1.0e-4, seed=1):
    """(A, b): the grid gradient of an nx x nx grid stacked on
    sqrt(delta) I, and a normal right-hand side from seed."""
    n = nx * nx
    ids = np.arange(n).reshape(nx, nx)
    hedges = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    vedges = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    edges = np.concatenate([hedges, vedges], axis=0)
    ne = len(edges)
    rows = np.repeat(np.arange(ne), 2)
    vals = np.tile(np.array([-1.0, 1.0]), ne)
    G = sp.csr_matrix((vals, (rows, edges.ravel())), shape=(ne, n))
    A = sp.vstack([G, np.sqrt(delta) * sp.identity(n)]).tocsr()
    b = np.random.default_rng(seed).normal(size=A.shape[0])
    return A, b


def main(argv=None):
    from scipy.io import mmread

    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.leastsquares import LeastSquaresSolver

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<16>", "Number of subdomains."),
           ("Nx=<48>", "Grid points per direction (generated problem)."),
           ("delta=<1e-4>", "Tikhonov regularization of the gradient."),
           ("matrix_filename=<>", "Rectangular MatrixMarket file."),
           ("lstol=<1e-8>", "CGLS tolerance on ||A^T r|| / ||A^T b||."),
           ("device=(cuda|cpu)", "Device of the preconditioner.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S = int(opt.app()["N"])
    device = as_device(opt.app().get("device", DEFAULT))
    fname = opt.app().get("matrix_filename") or ""
    if fname:
        A = sp.csr_matrix(mmread(fname))
        if A.shape[0] < A.shape[1]:
            A = sp.csr_matrix(A.T)
        b = np.random.default_rng(1).normal(size=A.shape[0])
    else:
        A, b = gradient_problem(int(opt.app()["Nx"]),
                                delta=float(opt.app()["delta"]))
    tol = float(opt.app()["lstol"])

    ls = LeastSquaresSolver(A, n_subdomains=S, overlap=2, options=opt,
                            device=device)
    res = ls.solve(b, tol=tol, max_it=int(opt.val("max_it", 500)))
    true_rel = (np.linalg.norm(A.T @ (b - A @ res.x))
                / np.linalg.norm(A.T @ b))
    print(f"CGLS: {res.iterations} iterations, ||A^T r||/||A^T b|| = "
          f"{true_rel:.2e} (monitored {res.rel_res:.2e})")
    return 0 if res.rel_res <= tol and true_rel <= 10 * tol else 1


if __name__ == "__main__":
    sys.exit(main())
