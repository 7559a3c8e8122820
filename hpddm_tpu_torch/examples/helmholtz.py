#!/usr/bin/env python
"""Helmholtz driver of the port, the twin of ``examples/helmholtz.py``:
ORAS with Robin interface conditions and, optionally, GCRO-DR recycling
over a frequency sweep (BASELINE config 5).

    python -m hpddm_tpu_torch.examples.helmholtz -N 4 -Nx 60 -k 6.0 \
        -eps 0.0 [-sweep 3] [-hpddm_krylov_method gcrodr -hpddm_recycle 10] \
        [-device cuda|cpu]

The sweep solves k_j = k (1 + 0.01 j), j < sweep, each on its own
setup (``helmholtz.generate``, the optimized local matrices factorized
by ``Schwarz.build``), recycling the deflation space across it with
gcrodr. It runs native complex128 on both devices: the JAX driver
switches to the real pair on any accelerator, a workaround for the TPU's
missing complex type (``problem(..., as_real=True)`` builds that form,
which chip_smoke.py measures beside the native one). Defaults as the JAX
driver: oras, GMRES(200), at most 500 iterations. Exits non-zero unless
every recomputed relative residual is <= 1e-2.
"""

import sys
import time

import numpy as np
import torch

# GMRES(200) counts of both packages on the CPU at 60x60, S=4, k=6,
# eps=0, tol 1e-6 (tests/test_torch_helmholtz.py): native c128 ORAS (also
# with local_solver lu), SORAS with the optimized matrices, and the real
# pair in f64 and f32
ANCHOR_ITS = {"oras": 100, "soras": 110, "real pair f64": 194,
              "real pair f32": 194}


def problem(S, Nx, k, eps, as_real=False, dtype=np.complex128):
    """(helmholtz.generate's problem on an Nx x Nx grid, its seconds)."""
    from hpddm_tpu_torch.models import helmholtz

    t = time.perf_counter()
    gen = helmholtz.generate(S, Nx=Nx, Ny=Nx, k=k, eps=eps, as_real=as_real,
                             dtype=dtype)
    return gen, time.perf_counter() - t


def rhs(gen, n_max, device):
    """The model's right-hand side as a (S, n_max, 1) batch."""
    S = len(gen.mats)
    f = np.zeros((S, n_max, 1), dtype=gen.f[0].dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = np.asarray(gen.f[s]).reshape(-1, 1)
    return torch.as_tensor(f, device=device)


def solve_one(state, f, opt, recycled=None):
    """One solve with ``opt``'s Krylov method: gcrodr called directly with
    the recycled space of the previous solve, as the JAX driver does, any
    other method through ``krylov.solve``."""
    from hpddm_tpu_torch.solvers.gcrodr import gcrodr
    from hpddm_tpu_torch.solvers.krylov import make_operator, solve

    if opt.val("krylov_method") in ("gcrodr", "bgcrodr"):
        return gcrodr(make_operator(state), f, tol=float(opt.val("tol")),
                      restart=int(opt.val("gmres_restart")),
                      max_it=int(opt.val("max_it")),
                      recycle=int(opt.val("recycle", 10)),
                      recycled=recycled)
    return solve(state, f, opt=opt)


def wavenumbers(k0, n):
    """The driver's sweep: k_j = k0 (1 + 0.01 j), j < n."""
    return [k0 * (1.0 + 0.01 * j) for j in range(n)]


def sweep(S, Nx, ks, eps, opts, device, log=print):
    """Solve the wavenumbers ``ks`` in turn, once for each options set of
    ``opts`` (which differ only in their Krylov method), every set on the
    same setup of each k. Returns (total iterations per set, per-solve
    records (set, k, iterations, relative residual), whether every
    residual is <= 1e-2)."""
    from hpddm_tpu_torch.precond.schwarz import Schwarz, compute_residual

    totals = [0] * len(opts)
    recycled = [None] * len(opts)
    records = []
    ok = True
    for kj in ks:
        gen, _ = problem(S, Nx, kj, eps)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opts[0], optimized_mats=gen.oras_mats,
                      device=device)
        f = rhs(gen, sch.n_max, device)
        state = sch.build()
        for i, opt in enumerate(opts):
            res = solve_one(state, f, opt, recycled[i])
            recycled[i] = getattr(res, "recycled", None)
            nb, nr = compute_residual(state, res.x, f)
            rel = float(nr[0] / nb[0])
            it = int(res.iterations)
            totals[i] += it
            records.append((i, kj, it, rel))
            ok = ok and rel <= 1e-2
            log(f"k = {kj:.3f}: {it} iterations, residual "
                f"{float(nr[0]):.3e} / {float(nb[0]):.3e}"
                + (f" ({opt.val('krylov_method')})" if len(opts) > 1
                   else ""))
        del state, sch
    return totals, records, ok


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.options import Options

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<4>", "Number of subdomains."),
           ("Nx=<60>", "Grid points per direction."),
           ("k=<6.0>", "Wavenumber."),
           ("eps=<0.0>", "Damping (0 = pure Helmholtz)."),
           ("sweep=<1>", "Number of wavenumbers (recycling across solves)."),
           ("device=(cuda|cpu)", "Device of the batched subdomains.")]
    opt = Options.parse(argv, display=True, app_options=app)
    app_v = opt.app()
    device = as_device(app_v.get("device", DEFAULT))
    if not opt.set("schwarz_method"):
        opt["schwarz_method"] = "oras"
    if not opt.set("gmres_restart"):
        opt["gmres_restart"] = 200
    if not opt.set("max_it"):
        opt["max_it"] = 500
    n = int(app_v["sweep"])
    totals, _, ok = sweep(int(app_v["N"]), int(app_v["Nx"]),
                          wavenumbers(float(app_v["k"]), n),
                          float(app_v["eps"]), [opt], device)
    if n > 1:
        print(f"total iterations: {totals[0]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
