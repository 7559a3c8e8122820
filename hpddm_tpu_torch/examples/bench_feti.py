#!/usr/bin/env python
"""FETI/BDD coarse-path benchmark of the port, the twin of
``tools/bench_feti.py``: setup and solve times and iteration counts of the
coarse modes on ``nonoverlap.generate(S, N, N)``, and the memory the
matrix-free mode avoids (the dense BDD balancing basis W is S x nb x S*r,
quadratic in the subdomain count; the dense FETI G is N_l x nc).

    python -m hpddm_tpu_torch.examples.bench_feti --S 64 --N 128 \\
        [--modes dense,mfree,cheby] [--local dense|banded] \\
        [--device cuda|cpu]

In float64 (the JAX twin's CPU precision). Prints, per coarse mode, the
build time with its setup phases, nc and ncb, the G and W bytes avoided
(mfree, cheby), the Chebyshev degrees (cheby), the FETI and BDD
iterations, relative residual, solve time and first solve time, and the
peak device memory (on the card). ``--local banded`` builds banded local
factors from the generator's grid shapes, slot maps and kernels (no dense
local block: the mode for local boxes whose dense factors do not fit).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def rhs(gen, n_max: int, dtype) -> np.ndarray:
    """(S, n_max, 1) split right-hand side of a generated problem."""
    f = np.zeros((len(gen.mats), n_max, 1), dtype=dtype)
    for s, fs in enumerate(gen.f):
        f[s, : gen.n_loc[s], 0] = fs
    return f


def timed(fn, device):
    """(result, wall seconds) of fn() ended by a device synchronize."""
    from hpddm_tpu_torch.device import synchronize

    t = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t


def run_mode(gen, mode: str, args, device, dtype, log=print) -> dict:
    """Build one coarse mode and run FETI (and BDD unless skipped) twice;
    returns the setup object, state, right-hand side, results and times."""
    import torch

    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.substructure import (Substructure,
                                                      bdd_solve, feti_solve)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kw = {}
    if args.local == "banded":
        kw = dict(kernels=gen.kernels, grid_shapes=gen.grid_shapes,
                  slot_maps=gen.slot_maps)
    sub, t_build = timed(lambda: Substructure(
        gen.mats, gen.neighbors, gen.mappings,
        options=Options(substructuring_coarse=mode,
                        substructuring_local=args.local),
        device=device, **kw), device)
    st = sub.state
    S = len(gen.mats)
    nb_max = st.bidx.shape[1]
    ncb = S * st.Sb_kernels.shape[2]
    itemsize = np.dtype(dtype).itemsize
    extra = ""
    if mode != "dense":
        extra = (f" avoided: G {st.N_l * st.nc * itemsize / 1e6:.1f} MB, "
                 f"W {S * nb_max * ncb * itemsize / 1e6:.1f} MB")
    if st.coarse_mode == "cheby":
        extra += (f" cheb_deg(G^TG)={st.coarse_degree}"
                  f" cheb_deg(W^TSW)={st.bdd_coarse_degree}")
    if st.local_mode == "banded":
        extra += f" cheb_deg(S_b^+)={st.sb_degree}"
    log(f"[{mode}] build {t_build:.2f}s nc={st.nc} ncb={ncb}{extra}")
    log(f"[{mode}] setup phases: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in sub.timings.items()))
    f = torch.as_tensor(rhs(gen, sub.n_max, dtype), device=device)
    out = dict(sub=sub, state=st, f=f, build=t_build)
    solvers = [("FETI", lambda: feti_solve(st, f, tol=args.tol,
                                           max_it=args.max_it))]
    if not args.skip_bdd:
        solvers.append(("BDD ", lambda: bdd_solve(st, f, tol=args.tol,
                                                  max_it=args.max_it)))
    for name, fn in solvers:
        _, t1 = timed(fn, device)
        res, t2 = timed(fn, device)
        log(f"[{mode}] {name}  its={res.iterations} "
            f"relres={float(res.rel_res.max()):.2e} "
            f"solve={t2:.2f}s (first {t1:.2f}s)")
        out[name.strip().lower()] = dict(res=res, solve=t2, first=t1)
    if device.type == "cuda":
        out["peak"] = torch.cuda.max_memory_allocated()
        log(f"[{mode}] peak device memory "
            f"{out['peak'] / 2**30:.2f} GiB")
    return out


def parser() -> argparse.ArgumentParser:
    from hpddm_tpu_torch.device import DEFAULT

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--S", type=int, default=64)
    ap.add_argument("--N", type=int, default=128)
    ap.add_argument("--contrast", type=float, default=1.0)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max-it", type=int, default=500)
    ap.add_argument("--modes", default="dense,mfree,cheby")
    ap.add_argument("--local", default="dense", choices=("dense", "banded"))
    ap.add_argument("--skip-bdd", action="store_true")
    ap.add_argument("--device", default=DEFAULT)
    return ap


def main(argv=None) -> int:
    from hpddm_tpu_torch.device import as_device
    from hpddm_tpu_torch.models import nonoverlap

    args = parser().parse_args(argv)
    device = as_device(args.device)
    dtype = np.float64
    gen = nonoverlap.generate(args.S, args.N, args.N,
                              contrast=args.contrast, dtype=dtype)
    print(f"S={args.S} grid={args.N}^2 dofs={gen.A_global.shape[0]} "
          f"local_max={max(gen.n_loc)} device={device}")
    for mode in args.modes.split(","):
        run_mode(gen, mode, args, device, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
