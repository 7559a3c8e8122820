#!/usr/bin/env python
"""The GMV cell on the card: the twin of ``bench.py``'s GMV block
(``bench.py:89-160``, ``spmv_nnz_per_s`` and ``gmv_arg_us``):

    python -m hpddm_tpu_torch.examples.bench_gmv [-N 16] [-Nx 2048]

``generate_uniform(N, Nx, Nx, overlap=1)`` in f64 with ``set_grid_geometry`` (the
slab exchange and the canvas operator) and ``operator_state`` (no
factorization): a chain of gmv calls, each on the last one's output, timed
back to back between CUDA events, beside the SpMM (the DIA kernel B1 on
the canvas operator) and three exchanges of the same decomposition in
the same bracket: the slab exchange (parallel/grid.py), the plain general
exchange and the one-pass kernel (B5, with ``build_plan``). Prints the gmv
time, nonzeros per second, the share of the bound (the values, x and y
moved once at 3.35 TB/s) and the device operations per gmv. Needs a CUDA
device.
"""

import dataclasses
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # NVIDIA H100 SXM data sheet


def device_ops(fn):
    """Device operations (kernels, copies, fills) of one call of ``fn()``
    under torch.profiler, or None where it records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def cell(S, N, device="cuda"):
    """(operator state, x, seconds to generate and set up): the cell's f64
    operator on the card, x random from seed 0."""
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz

    t = time.perf_counter()
    gen = diffusion2d.generate_uniform(S, N, N, overlap=1)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options(), device=device)
    sch.set_grid_geometry(gen.boxes, N, N)
    state = sch.operator_state()
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(S, sch.n_max, 1)), device=state.dec.device)
    return state, x, time.perf_counter() - t


def chain_ms(state, x, length=20, blocks=5):
    """Milliseconds per gmv of a chain of ``length`` gmv calls (each on the
    last one's output, back to back between two CUDA events), best of
    ``blocks`` after a warm-up chain."""
    from hpddm_tpu_torch.precond.schwarz import gmv

    def run():
        y = x
        for _ in range(length):
            y = gmv(state, y)
        return y

    run()
    best = float("inf")
    for _ in range(blocks):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) / length)
    return best


def exchanges(dec):
    """{name: Decomposition} of the three exchanges of one decomposition:
    the slab plan, the plain general path and the one-pass kernel."""
    from hpddm_tpu_torch.parallel.pexchange import build_plan

    general = dataclasses.replace(dec, grid=None)
    return {"slab": dec, "general": general,
            "B5": dataclasses.replace(general, pexch=build_plan(general))}


def measure(state, x):
    """The cell's times (ms) and counts."""
    from hpddm_tpu_torch.ops.spmv import spmm
    from hpddm_tpu_torch.parallel.ops import exchange
    from hpddm_tpu_torch.precond.schwarz import gmv
    from hpddm_tpu_torch.timing import events_ms

    A, dec = state.A, state.dec
    nnz = int(torch.count_nonzero(A.values))
    nbytes = (A.values.numel() + 2 * x.numel()) * x.element_size()
    paths = exchanges(dec)
    out = dict(nnz=nnz, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               gmv_ms=chain_ms(state, x),
               gmv_general_ms=chain_ms(
                   dataclasses.replace(state, dec=paths["general"]), x),
               spmm_ms=events_ms(lambda: spmm(A, x), 50),
               gmv_ops=device_ops(lambda: gmv(state, x)))
    y = spmm(A, x)
    for name, d in paths.items():
        out[f"exchange_{name}_ms"] = events_ms(lambda: exchange(d, y), 50)
    out["exchange_slab_ops"] = device_ops(lambda: exchange(dec, y))
    return out


def measure_muT(state, x):
    """The multi-RHS gmv on the panel x (S, n, mu), back to back between
    CUDA events in one bracket (ms): gmv (its RHS-leading branch: B3 on
    the (S, mu, n) panel, the scaling and ``grid_exchange_muT``) against
    the trailing-mu path (B2, then the slab exchange through its
    permutes), and the RHS-leading product and exchange fused and in
    their per-group ``_scan`` forms."""
    from hpddm_tpu_torch.ops.spmv import (spmm, spmm_dia_canvas_muT_scan,
                                          spmm_muT)
    from hpddm_tpu_torch.parallel.grid import (grid_exchange_muT,
                                               grid_exchange_muT_scan)
    from hpddm_tpu_torch.parallel.ops import exchange, scaled_exchange
    from hpddm_tpu_torch.precond.schwarz import gmv
    from hpddm_tpu_torch.timing import events_ms

    A, dec = state.A, state.dec
    xT = x.transpose(1, 2).contiguous()
    d = dec.d[:, None, :]
    return dict(
        mu=x.shape[-1],
        gmv_ms=events_ms(lambda: gmv(state, x)),
        trailing_ms=events_ms(lambda: scaled_exchange(dec, spmm(A, x))),
        fused_ms=events_ms(lambda: grid_exchange_muT(
            dec.grid, spmm_muT(A, xT) * d)),
        scan_ms=events_ms(lambda: grid_exchange_muT_scan(
            dec.grid, spmm_dia_canvas_muT_scan(A, xT, scale=dec.d))),
        b3_ms=events_ms(lambda: spmm_muT(A, xT)),
        b2_ms=events_ms(lambda: spmm(A, x)),
        exchange_muT_ms=events_ms(lambda: grid_exchange_muT(dec.grid, xT)),
        exchange_ms=events_ms(lambda: exchange(dec, x)),
        gmv_ops=device_ops(lambda: gmv(state, x)))


def report_muT(r):
    print(f"  gmv at mu={r['mu']} (RHS leading: B3, scaling, mu-leading slab "
          f"exchange) {r['gmv_ms'] * 1e3:.2f} us ({r['gmv_ops']} device "
          f"operations) against the trailing-mu path (B2 + the permuted "
          f"slab exchange) {r['trailing_ms'] * 1e3:.2f} us; RHS leading "
          f"fused {r['fused_ms'] * 1e3:.2f} us, in the per-group scan forms "
          f"{r['scan_ms'] * 1e3:.2f} us")
    print(f"    B3 {r['b3_ms'] * 1e3:.2f} us, B2 {r['b2_ms'] * 1e3:.2f} us; "
          f"slab exchange RHS leading {r['exchange_muT_ms'] * 1e3:.2f} us, "
          f"trailing {r['exchange_ms'] * 1e3:.2f} us (back to back, best "
          "of 5 x 20)")


def report(S, N, r):
    ops = "not recorded" if r["gmv_ops"] is None else r["gmv_ops"]
    print(f"  {N}x{N}/{S}: gmv {r['gmv_ms'] * 1e3:.2f} us a call (chain of "
          f"20, best of 5), {r['nnz'] / (r['gmv_ms'] * 1e-3):.4g} nnz/s, "
          f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bytes'] / 1e6:.1f} MB) = "
          f"{100 * r['bound_ms'] / r['gmv_ms']:.1f}% of it; device "
          f"operations per gmv {ops}; on the general exchange "
          f"{r['gmv_general_ms'] * 1e3:.2f} us")
    print(f"    SpMM (B1 on the canvas operator) {r['spmm_ms'] * 1e3:.2f} us; "
          f"exchange: slab {r['exchange_slab_ms'] * 1e3:.2f} us "
          f"({r['exchange_slab_ops']} device operations), general "
          f"{r['exchange_general_ms'] * 1e3:.2f} us, B5 "
          f"{r['exchange_B5_ms'] * 1e3:.2f} us (back to back, best of 5 x 50)")


def main(argv=None):
    from hpddm_tpu_torch.options import Options

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<16>", "Number of subdomains."),
           ("Nx=<2048>", "Grid points per side.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S, N = int(opt.app()["N"]), int(opt.app()["Nx"])
    state, x, t = cell(S, N)
    print(f"bench_gmv: generate_uniform({S}, {N}, {N}, overlap=1), "
          f"float64, n_max {state.dec.n_max}, canvas "
          f"{state.A.canvas_hw}, slab plan t={state.dec.grid.t}; setup "
          f"{t:.2f} s")
    report(S, N, measure(state, x))
    xm = torch.as_tensor(np.random.default_rng(1).normal(
        size=(S, state.dec.n_max, 4)), device=state.dec.device)
    report_muT(measure_muT(state, xm))
    return 0


if __name__ == "__main__":
    sys.exit(main())
