#!/usr/bin/env python
"""ladder256 on the card: the twin of ``bench.py``'s S-ladder point
(``bench.py:227-283``), in either precision:

    python -m hpddm_tpu_torch.examples.ladder [-N 256] [-Nx 2048] \
        [-device cuda|cpu] [-dtype float32|float64]

The problem is ``generate_uniform(N, Nx, Nx, overlap=1)`` with the bench's
contrast-1e4 channel (``examples/flagship.py``'s ``kappa``), Jacobi-scaled
(core/scaling.py), generated and scaled once in f64 and cast for f32. The
preconditioner: banded exact local solves on the grid boxes
(``set_grid_geometry``: slab exchange and canvas operator), Lanczos GenEO
(nu=8), the block-sparse coarse assembly with a nested level-2 CG
(tol 1e-2, at most 50 iterations) preconditioned by the block-Jacobi
inverse and a direct level 3 on the aggregate constants, deflated, in
flexible GMRES (restart 40):

* f32, as the bench runs it: the device solve at tol 2e-3, then host-f64
  iterative refinement (``solve_refined``, the same inner solve, at most 8
  passes) to a true weighted relative residual <= 1e-10;
* f64, native on the card: the same setup, solved at tol 1e-8 with no
  refinement.

Each prints outer iterations, the nested solve's inner iterations per
coarse solve (mean and largest), setup seconds by phase, solve, refine
and time-to-true-1e-8 (solve + refine) seconds, the true relative residual
and the peak device memory. Exits 0 when every precision reaches a true
relative residual <= 1e-8 (``bench.py:220``).
"""

import dataclasses
import sys
import time

import numpy as np
import torch

LADDER_N, LADDER_NX = 256, 2048


def options(tol):
    from hpddm_tpu_torch.options import Options
    return Options(tol=tol, local_solver="banded", coarse_assembly="bsr",
                   gmres_restart=40, schwarz_coarse_correction="deflated",
                   geneo_nu=8, level_2_krylov_method="cg", level_2_tol=1e-2,
                   level_2_max_it=50)


def problem(S=LADDER_N, N=LADDER_NX):
    """The scaled f64 problem, shared by both precisions: a dict of the
    generator's output, the scaled matrices, right-hand sides and Neumann
    matrices, and the seconds it took."""
    from hpddm_tpu_torch.core.scaling import jacobi_scale
    from hpddm_tpu_torch.examples.flagship import kappa
    from hpddm_tpu_torch.models import diffusion2d

    t = time.perf_counter()
    gen = diffusion2d.generate_uniform(S, N, N, overlap=1, kappa=kappa,
                                       with_neumann=True)
    mats, f_list, neu, _ = jacobi_scale(gen.mats, gen.f, gen.neumann)
    return dict(S=S, N=N, gen=gen, mats=mats, f=f_list, neumann=neu,
                seconds=time.perf_counter() - t)


def _cast(mats, dtype):
    from hpddm_tpu_torch.core.csr import MatrixCSR
    if dtype == np.float64:
        return list(mats)
    return [MatrixCSR(m.scipy().astype(dtype)) for m in mats]


def run(prob, dtype, device="cuda", reps=2):
    """One precision of the ladder on ``prob`` (``problem()``). Returns (a
    dict of the results, the state)."""
    from hpddm_tpu_torch.device import as_device, synchronize
    from hpddm_tpu_torch.examples.flagship import timed_solve
    from hpddm_tpu_torch.precond.schwarz import Schwarz
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.solvers.refine import solve_refined, true_relres

    device = as_device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    f32 = dtype == np.float32
    S, N, gen = prob["S"], prob["N"], prob["gen"]
    mats = _cast(prob["mats"], dtype)
    opt = options(2e-3 if f32 else 1e-8)
    t0 = time.perf_counter()
    sch = Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d, options=opt,
                  device=device)
    sch.set_grid_geometry(gen.boxes, N, N)
    synchronize(sch.device)
    t_dec = time.perf_counter() - t0
    sch.solve_gevp(_cast(prob["neumann"], dtype), method="lanczos")
    state = sch.build()
    setup_s = time.perf_counter() - t0
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = prob["f"][s]
    f = torch.as_tensor(f, device=sch.device)
    inner = []
    state = dataclasses.replace(state, coarse=dataclasses.replace(
        state.coarse, its_log=inner))
    solve_s, res = timed_solve(state, f, sch.opt, reps=reps)
    co = state.coarse
    out = dict(dtype=np.dtype(dtype).name, iterations=int(res.iterations),
               reps=reps,
               setup_s=setup_s, phases=dict(decomposition=t_dec,
                                            **sch.timings),
               solve_s=solve_s, n_max=sch.n_max, coarse=co.N_c,
               mode=co.mode, lvl3=co.lvl3, inner_tol=co.inner_tol,
               coarse_solves=len(inner) // (reps + 1),
               inner_mean=float(np.mean(inner)) if inner else 0.0,
               inner_max=max(inner, default=0),
               converged=bool(res.converged.all()),
               solve_relres=true_relres(mats, f, state.dec, res.x))
    if f32:
        synchronize(device)
        t = time.perf_counter()
        _, info = solve_refined(lambda b: solve(state, b, opt=opt), mats,
                                f, state.dec, tol=1e-10, max_refine=8)
        out.update(refine_s=time.perf_counter() - t,
                   history=info["history"],
                   refine_iterations=info["inner_iterations"])
    else:
        out.update(refine_s=0.0, history=[out["solve_relres"]],
                   refine_iterations=[])
    out["true_relres"] = out["history"][-1]
    out["time_to_1e-8_s"] = out["solve_s"] + out["refine_s"] \
        if out["true_relres"] <= 1e-8 else None
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    return out, state


def report(r):
    """Print one precision's results."""
    peak = "not measured (CPU)" if r["peak_bytes"] is None else \
        f"{r['peak_bytes'] / 2**30:.2f} GiB"
    print(f"  {r['dtype']}: {r['iterations']} outer iterations (n_max "
          f"{r['n_max']}, coarse size {r['coarse']}, mode {r['mode']}, "
          f"level 3 {r['lvl3']}, level-2 tol {r['inner_tol']:g}), solve "
          f"{r['solve_s']:.4f} s (best of {r['reps']} after a warm-up), "
          "true rel. "
          f"residual of the solve {r['solve_relres']:.3e}")
    print(f"    nested level-2 CG: {r['coarse_solves']} coarse solves a "
          f"solve, inner iterations per coarse solve mean "
          f"{r['inner_mean']:.2f}, largest {r['inner_max']}")
    print("    setup " + f"{r['setup_s']:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["phases"].items()))
    if r["refine_iterations"]:
        print(f"    host refinement {r['refine_s']:.4f} s, "
              f"{len(r['refine_iterations'])} passes (outer iterations "
              f"{r['refine_iterations']}), history "
              + ", ".join(f"{h:.3e}" for h in r["history"]))
    ttt = r["time_to_1e-8_s"]
    print(f"    true rel. residual {r['true_relres']:.3e}; time to true 1e-8 "
          + ("not reached" if ttt is None else f"{ttt:.4f} s")
          + f" (solve + refine); peak device memory {peak}")


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT
    from hpddm_tpu_torch.options import Options

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<256>", "Number of subdomains."),
           ("Nx=<2048>", "Grid points per side."),
           ("device=(cuda|cpu)", "Device of the batched subdomains."),
           ("dtype=(float64|float32)", "Precision (default: both).")]
    opt = Options.parse(argv, display=True, app_options=app)
    S, N = int(opt.app()["N"]), int(opt.app()["Nx"])
    device = opt.app().get("device", DEFAULT)
    kinds = [opt.app()["dtype"]] if opt.app().get("dtype") else \
        ["float32", "float64"]
    print(f"ladder: generate_uniform({S}, {N}, {N}, overlap=1), contrast "
          "1e4 channel, Jacobi-scaled, banded, Lanczos GenEO nu=8, bsr "
          "coarse, level-2 CG + direct level 3, deflated")
    prob = problem(S, N)
    print(f"  generate and scale (f64, once): {prob['seconds']:.3f} s")
    ok = True
    for kind in kinds:
        r, _ = run(prob, np.dtype(kind).type, device)
        report(r)
        ok &= r["true_relres"] <= 1e-8
    print("ladder:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
