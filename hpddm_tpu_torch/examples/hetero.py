#!/usr/bin/env python
"""The heterogeneous large-subdomain cell on the card: the twin of
``tools/bench_hetero.py``:

    python -m hpddm_tpu_torch.examples.hetero [-N 16] [-Nx 1024] \
        [-hpddm_geneo_nu 16] [-hpddm_local_cheby_steps 32] \
        [-hpddm_local_solver dst_cheby] [-f32 1] [-device cuda|cpu]

The problem is ``generate_uniform(N, Nx, Nx, overlap=1)`` with the tool's
coefficient (a contrast-1e4 channel and a factor-10 quadrant jump),
Jacobi-scaled (core/scaling.py), on the grid boxes of ``set_grid_geometry``, with
inexact DST-preconditioned Chebyshev local solves (``dst_cheby``: no
factor memory; at 1024x1024 and N=16 a subdomain holds 66,564 unknowns,
whose batched dense inverses would take 567 GB), Lanczos GenEO (the DST
solve preconditions its inner CG), the block-sparse coarse assembly and
the deflated correction. f64 at tol 1e-8 by default (native on the
card); ``-f32 1`` runs f32 at tol 1e-6.

Prints the iterations, the setup seconds by phase, the solve (best of 3
after a warm-up), the recomputed relative residual and the peak device
memory. Exits non-zero when the recomputed residual misses the
tolerance.
"""

import sys
import time

import numpy as np
import torch

DEFAULTS = dict(local_solver="dst_cheby", local_cheby_steps=32, geneo_nu=16,
                schwarz_coarse_correction="deflated", coarse_assembly="bsr")


def kappa(xx, yy):
    """The tool's coefficient (``tools/bench_hetero.py:50-52``)."""
    return (np.where((yy > 3.3) & (yy < 6.6), 1.0e4, 1.0)
            * np.where(xx > 5.0, 10.0, 1.0))


def setup(S, N, opt, dtype, device):
    """(Schwarz, f (S, n_max, 1) tensor, setup seconds by phase): the
    scaled problem with its GenEO vectors; the phases end in a device
    synchronization. ``build`` is left to the caller."""
    from hpddm_tpu_torch.core.scaling import jacobi_scale
    from hpddm_tpu_torch.device import synchronize
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.precond.schwarz import Schwarz

    t = time.perf_counter()
    gen = diffusion2d.generate_uniform(S, N, N, overlap=1, kappa=kappa,
                                       with_neumann=True, dtype=dtype)
    mats, f_list, neu, _ = jacobi_scale(gen.mats, gen.f, gen.neumann)
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    sch = Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d, options=opt,
                  device=device)
    sch.set_grid_geometry(gen.boxes, N, N)
    synchronize(sch.device)
    t_dec = time.perf_counter() - t
    t = time.perf_counter()
    sch.solve_gevp(neu, method="lanczos")
    t_gevp = time.perf_counter() - t
    f = diffusion2d.padded_rhs(f_list, sch.n_max, dtype)
    phases = dict(generate_and_scale=t_gen, decomposition=t_dec,
                  gevp=t_gevp)
    return sch, torch.as_tensor(f, device=sch.device), phases


def solve_report(sch, state, f, reps=3):
    """The solve of ``state`` on f: a dict of iterations, best seconds,
    ms per iteration and the recomputed relative residual."""
    from hpddm_tpu_torch.examples.flagship import timed_solve
    from hpddm_tpu_torch.precond.schwarz import compute_residual

    t, res = timed_solve(state, f, sch.opt, reps)
    nb, nr = compute_residual(state, res.x, f)
    its = int(res.iterations)
    return dict(iterations=its, solve_s=t, ms_per_it=t / max(its, 1) * 1e3,
                relres=float((nr / nb).max()),
                converged=bool(res.converged.all()))


def build_timed(sch):
    """(state, build seconds ending in a device synchronization)."""
    from hpddm_tpu_torch.device import synchronize

    t = time.perf_counter()
    state = sch.build()
    synchronize(sch.device)
    return state, time.perf_counter() - t


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.options import Options

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<16>", "Number of subdomains."),
           ("Nx=<1024>", "Grid points per side."),
           ("f32=(0|1)", "Single precision at tol 1e-6."),
           ("device=(cuda|cpu)", "Device of the batched subdomains.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S, N = int(opt.app()["N"]), int(opt.app()["Nx"])
    f32 = bool(int(opt.app().get("f32", 0)))
    device = as_device(opt.app().get("device", DEFAULT))
    for k, v in DEFAULTS.items():
        if not opt.set(k):
            opt[k] = v
    dtype = np.float32 if f32 else np.float64
    tol = 1e-6 if f32 else 1e-8
    if not opt.set("tol"):
        opt["tol"] = tol
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sch, f, phases = setup(S, N, opt, dtype, device)
    state, phases["build"] = build_timed(sch)
    r = solve_report(sch, state, f)
    peak = f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" if cuda \
        else "not measured (CPU)"
    print(f"hetero: generate_uniform({S}, {N}, {N}, overlap=1), contrast "
          f"1e4, Jacobi-scaled, n_max {sch.n_max}, {opt.val('local_solver')} "
          f"(k={opt.val('local_cheby_steps')}), Lanczos GenEO nu="
          f"{opt.val('geneo_nu')}, {opt.val('coarse_assembly')} coarse, "
          f"{np.dtype(dtype).name}, tol {float(opt.val('tol')):g}")
    print("  setup " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 phases.items()))
    print(f"  {r['iterations']} iterations, solve {r['solve_s']:.4f} s "
          f"(best of 3 after a warm-up, {r['ms_per_it']:.2f} ms per "
          f"iteration), recomputed rel. residual {r['relres']:.3e}, peak "
          f"device memory {peak}")
    return 0 if r["relres"] <= float(opt.val("tol")) else 1


if __name__ == "__main__":
    sys.exit(main())
