#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``hpddm_tpu_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one CUDA GPU

Phases (any failure exits non-zero before the last line is printed):

1. device: a CUDA GPU is required; TF32 is switched off for matmuls and
   cuDNN, so float32 products run in full float32;
2. build: the CUDA kernels are compiled from ``hpddm_tpu_torch/csrc``;
3. kernel vs plain: the DIA SpMV kernel against its plain PyTorch version
   on the card, in f32 and f64, at the oracle shapes, the card-scale
   shapes and edge cases;
4. oracle parity: the two-level GenEO-RAS + GMRES main path at 100x100,
   S=4, nu=10, deflated, in f64, must take exactly the JAX package's
   CPU-f64 iteration counts (``ORACLE_ITS``); then the same run in f32;
5. card scale: the main path at 512x512, S=64, overlap 1, nu=10, tol 1e-6,
   with setup phases, solve time, peak memory, kernel launch counts and
   the time of one gmv through the kernel and through the plain version.

It prints one JSON line with the kernels' results, the card's name and
power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# GMRES iteration counts of the JAX package on the CPU in f64 at the oracle
# (100x100, S=4, GenEO nu=10, deflated); tests/test_torch_gmres.py checks
# them against hpddm_tpu
ORACLE_ITS = {1e-6: 19, 1e-8: 22}

KERNEL_RTOL = {"float64": 1e-12, "float32": 1e-5}

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def build_problem(S, N, nu, dtype, device, timings=None):
    import torch
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz

    t = time.perf_counter()
    gen = diffusion2d.generate(S, N, N, overlap=1, with_neumann=True,
                               dtype=dtype)
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    opt = Options(schwarz_coarse_correction="deflated", geneo_nu=nu)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt, device=device)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    sch.solve_gevp(gen.neumann)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    if timings is not None:
        timings.update(generate=t_gen, decomposition=t_dec, **sch.timings)
    return opt, state, torch.as_tensor(f, device=device)


def checked_residual(state, f, res):
    """Recomputed relative residual of a solve, after checking that its
    solution is finite and of the right-hand side's shape."""
    import torch
    from hpddm_tpu_torch.precond.schwarz import compute_residual

    check(tuple(res.x.shape) == tuple(f.shape), f"x shape {tuple(res.x.shape)}")
    check(bool(torch.isfinite(res.x).all()), "non-finite solution")
    nb, nr = compute_residual(state, res.x, f)
    return float((nr / nb).max())


def solve_checked(state, f, opt, tol):
    from hpddm_tpu_torch.solvers.krylov import solve

    opt["tol"] = tol
    res = solve(state, f, opt=opt)
    return res, checked_residual(state, f, res)


def phase_kernels():
    import torch
    from hpddm_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_reference

    cases = [("oracle", 4, 2601, (-50, -1, 0, 1, 50)),
             ("card", 64, 4356, (-64, -1, 0, 1, 64)),
             ("ragged n", 3, 1000, (-3, 0, 7)),
             ("|offset| >= n", 2, 300, (-400, -1, 0, 350)),
             ("single diagonal", 5, 777, (0,)),
             ("single shifted diagonal", 2, 513, (9,))]
    rng = np.random.default_rng(1234)
    worst = 0.0
    for name, S, n, offs in cases:
        vals_np = rng.normal(size=(S, len(offs), n))
        x_np = rng.normal(size=(S, n))
        for dt in (torch.float64, torch.float32):
            vals = torch.as_tensor(vals_np, device="cuda").to(dt)
            x = torch.as_tensor(x_np, device="cuda").to(dt)
            y = dia_spmv(vals, x, offs)
            ref = dia_spmv_reference(vals, x, offs)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            rtol = KERNEL_RTOL[str(dt).split(".")[1]]
            print(f"  kernel vs plain [{name}, S={S}, n={n}, offsets={offs}, "
                  f"{dt}]: max|err| = {err:.3e} (max|y| = {scale:.3e}, "
                  f"tolerance {rtol:g} * max|y|)")
            check(err <= rtol * scale, f"kernel disagrees with plain: {name} {dt}")
            worst = max(worst, err)
    return worst


def phase_oracle():
    print("phase 4: oracle parity (100x100, S=4, nu=10, deflated)")
    opt, state, f = build_problem(4, 100, 10, np.float64, "cuda")
    for tol, want in ORACLE_ITS.items():
        res, rel = solve_checked(state, f, opt, tol)
        print(f"  f64 tol {tol:g}: {res.iterations} iterations "
              f"(JAX CPU f64: {want}), recomputed rel. residual {rel:.3e}")
        check(res.iterations == want,
              f"f64 oracle at tol {tol:g}: {res.iterations} != {want}")
        check(rel <= (1e-5 if tol == 1e-6 else 1e-2),
              f"f64 oracle residual {rel:.3e} at tol {tol:g}")
    opt, state, f = build_problem(4, 100, 10, np.float32, "cuda")
    res, rel = solve_checked(state, f, opt, 1e-6)
    print(f"  f32 tol 1e-06: {res.iterations} iterations, recomputed rel. "
          f"residual {rel:.3e}")
    check(res.iterations <= 45 and rel <= 1e-2, "f32 oracle gates")


def phase_card_scale():
    import torch
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.ops.spmv import spmm_dia
    from hpddm_tpu_torch.parallel.ops import scaled_exchange
    from hpddm_tpu_torch.precond.schwarz import gmv
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import cold_events_ms, events_ms, timed

    S, N = 64, 512
    print(f"phase 5: card scale ({N}x{N}, S={S}, overlap 1, nu=10, f64, "
          "tol 1e-6)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kmod.launches = 0                        # the main path's count from here
    timings = {}
    opt, state, f = build_problem(S, N, 10, np.float64, "cuda", timings)
    after_setup = kmod.launches
    opt["tol"] = 1e-6
    best, solve_s, res = timed(lambda: solve(state, f, opt=opt), reps=3,
                               warmup=1)
    launches = kmod.launches                 # read just after the main path
    rel = checked_residual(state, f, res)
    peak = torch.cuda.max_memory_allocated()
    per_solve = (launches - after_setup) // 4
    check(bool(res.converged.all()) and res.iterations < int(opt.val("max_it")),
          f"card scale did not converge in {res.iterations} iterations")
    check(rel <= 1e-5, f"card-scale recomputed rel. residual {rel:.3e}")
    check(per_solve > 0 and launches > after_setup,
          f"kernel launches: setup {after_setup}, after 4 solves {launches}")
    print(f"  n_max {state.dec.n_max}, coarse size "
          f"{state.coarse.E_inv.shape[0]}, DIA offsets {state.A.offsets}")
    print("  setup seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in timings.items()))
    print(f"  solve: {res.iterations} iterations, recomputed rel. residual "
          f"{rel:.3e}, best of 3 after a warm-up {best:.4f} s "
          f"({', '.join(f'{t:.4f}' for t in solve_s)})")
    print(f"  peak device memory {peak / 2**30:.2f} GiB "
          "(torch.cuda.max_memory_allocated)")
    print(f"  dia_spmv launches: {after_setup} in setup, {per_solve} per "
          f"solve, {launches} in all")

    # kernel and gmv times: comparisons, not counted as main-path launches
    x = state.dec.d[:, :, None] * torch.ones_like(f)
    xs = x[:, :, 0].contiguous()
    vals, offs = state.A.values, state.A.offsets
    k_ms = cold_events_ms(lambda: kmod.dia_spmv(vals, xs, offs))
    p_ms = cold_events_ms(lambda: kmod.dia_spmv_reference(vals, xs, offs))
    k_warm = events_ms(lambda: kmod.dia_spmv(vals, xs, offs), 200)
    p_warm = events_ms(lambda: kmod.dia_spmv_reference(vals, xs, offs), 50)
    g_k = events_ms(lambda: gmv(state, x), 50)
    g_p = events_ms(lambda: scaled_exchange(state.dec, spmm_dia(state.A, x)),
                    50)
    nbytes = vals.numel() * 8 + 2 * xs.numel() * 8
    print(f"  dia_spmv at (S={state.dec.S}, nd={len(offs)}, "
          f"n={state.dec.n_max}) f64: "
          f"kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us with L2 "
          f"flushed; {k_warm * 1e3:.2f} / {p_warm * 1e3:.2f} us back to back; "
          f"{nbytes / 1e6:.2f} MB moved -> kernel "
          f"{nbytes / (k_ms * 1e-3) / 1e9:.0f} GB/s (L2 flushed)")
    print(f"  gmv: {g_k * 1e3:.2f} us through the kernel, {g_p * 1e3:.2f} us "
          "through the plain version (best of 5 x 50)")
    return launches, k_ms, p_ms


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA GPU")
    check(os.path.isdir(os.path.join(ROOT, "hpddm_tpu_torch")),
          f"no hpddm_tpu_torch package beside {__file__}: run from a checkout")
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"phase 1: device {kind}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    from hpddm_tpu_torch import _build
    t = time.perf_counter()
    _build.build(force=True)
    _build.load()
    print(f"phase 2: built {_build.LIB_PATH} from "
          f"{len(_build.sources())} source(s) in "
          f"{time.perf_counter() - t:.2f} s")

    print("phase 3: kernel vs plain")
    max_err = phase_kernels()
    phase_oracle()
    launches, k_ms, p_ms = phase_card_scale()

    kernels = {"kernels": [{
        "name": "dia_spmv", "route": "cuda",
        "source": "hpddm_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "hpddm_tpu/ops/pallas_spmv.py:98",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}
    print(f"wall {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
