#!/usr/bin/env python
"""Where the time of the main path goes on the GPU.

    python -m hpddm_tpu_torch.examples.profile_main_path [--N 512] [--S 64] \
        [--nu 10] [--tol 1e-6] [--model diffusion2d|unstructured] \
        [--trace trace.json]

Builds the two-level GenEO-RAS preconditioner on the GPU, in f64, of the
2D diffusion problem (N x N grid, S subdomains, overlap 1: DIA local
matrices, slice 1) or of the unstructured P1-FEM problem (N x N mesh
points, S subdomains by geometric partition, overlap 2: ELL local
matrices and the one-pass exchange kernel, slice 2), then:

* times each piece of one right-preconditioned GMRES iteration with CUDA
  events (best of 5 blocks of back-to-back calls): the local solve, the
  exchange, the local SpMV kernel, gmv, the coarse deflation, the full
  preconditioner apply and the CGS Gram step at mid-cycle;
* times whole solves (host clock around a synchronized solve);
* traces one solve with torch.profiler: device time by kernel and the
  device's busy share of the solve's wall time (``--trace`` also writes
  the Chrome trace).

Prints one line per measurement with the card's name and power limit.
"""

import argparse
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv=None):
    from hpddm_tpu_torch.models import diffusion2d, unstructured
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.ops.spmv import spmm
    from hpddm_tpu_torch.parallel.ops import scaled_exchange
    from hpddm_tpu_torch.precond import schwarz as sz
    from hpddm_tpu_torch.solvers.krylov import make_operator, solve
    from hpddm_tpu_torch.timing import events_ms, timed

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--N", type=int, default=512)
    p.add_argument("--S", type=int, default=64)
    p.add_argument("--nu", type=int, default=10)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--model", choices=("diffusion2d", "unstructured"),
                   default="diffusion2d")
    p.add_argument("--trace", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")

    S, N = args.S, args.N
    if args.model == "unstructured":
        gen = unstructured.generate(S, N, N, overlap=2, with_neumann=True,
                                    partition="geometric")
    else:
        gen = diffusion2d.generate(S, N, N, overlap=1, with_neumann=True)
    opt = Options(schwarz_coarse_correction="deflated", geneo_nu=args.nu,
                  tol=args.tol)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=opt, device="cuda")
    sch.solve_gevp(gen.neumann)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1))
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    f = torch.as_tensor(f, device="cuda")
    dec = state.dec
    print(f"problem: {args.model} {N}x{N}, S={S}, n_max={dec.n_max}, m_max={dec.m_max}, "
          f"coarse {state.coarse.N_c}; setup "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sch.timings.items()))

    x = scaled_exchange(dec, torch.randn(S, dec.n_max, 1, device="cuda",
                                         dtype=torch.float64))
    op = make_operator(state)
    V = torch.randn(21, S, dec.n_max, 1, device="cuda", dtype=torch.float64)
    pieces = {
        "local solve (bmm of the inverses)": lambda: state.solver.solve(x),
        "scaled exchange": lambda: scaled_exchange(dec, x),
        f"{type(state.A).__name__} SpMV kernel (spmm)":
            lambda: spmm(state.A, x),
        "gmv = spmm + scaled exchange": lambda: sz.gmv(state, x),
        "deflation (coarse correction)": lambda: sz.deflation(state, x),
        "apply (deflated RAS)": lambda: sz.apply(state, x),
        "CGS Gram + update, 21 vectors": lambda: x - torch.einsum(
            "km,ksnm->snm", op.gram(V, x), V),
    }
    for name, fn in pieces.items():
        print(f"  {name:36s} {events_ms(fn) * 1e3:10.1f} us")

    best, _, res = timed(lambda: solve(state, f, opt=opt))
    its = res.iterations
    print(f"  solve: {its} iterations, best {best:.4f} s, "
          f"{best / its * 1e3:.3f} ms per iteration")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(state, f, opt=opt)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # device-side events only (kernels, copies): the CPU-side operator
    # rows repeat their kernels' device time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    print(f"  profiled solve: wall {window:.4f} s (profiler on), device busy "
          f"{busy:.4f} s = {100 * busy / window:.1f}% of it")
    for dev_us, count, key in rows[:15]:
        print(f"    {dev_us / 1e3:9.3f} ms {100 * dev_us * 1e-6 / busy:5.1f}%"
              f" {count:6d}x  {key[:90]}")
    if not rows:
        print("    the profiler recorded no device time")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
