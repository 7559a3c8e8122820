#!/usr/bin/env python
"""The ELL SpMM kernel (B4) and the one-pass exchange kernel (B5) at the
unstructured card cell beside the floors of the cold measurement.

    python -m hpddm_tpu_torch.examples.bench_ell [--reps 30] [--mus 1,4,640]
        [--parent DIR]

Builds the unstructured card cell's operator and exchange plan (512x512
mesh points, S=64, overlap 2, geometric partition, f64; the model,
decomposition and packing, with no GenEO) and times B4 and B5 at each mu
of ``--mus`` (640: the coarse assembly's panel, S * nu at nu=10), each
beside its bound (the bytes it must move at 3.35 TB/s), two floors of the
same bracket (a device copy that moves the same bytes, half read and half
written, and a kernel that writes one element) and the library call
(``torch.sparse.mm`` on the block-diagonal CSR matrix for B4, on I + P for
B5). B4 is also timed with a payload without row counts (every slot
summed). Every time is the median of ``--reps`` single calls with the L2
cache flushed before each, twice: by a write (``timing.cold_events_ms``,
the smoke's bracket) and by a read (``timing.read_flushed_ms``). Every
result is held bitwise to the plain version. Prints the card's name and
power limit.

``--parent DIR``: a checkout of another commit whose kernels take the
payload of B4 and the slot-major plan of B5 (the sources of 5e52bf2 and
885c0ac: B4 without the scratch of its flags of non-finite x[s, 0, :]);
its kernel sources are built and timed beside.
"""

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys

import torch

S, NX, NU = 64, 512, 10
HBM_BYTES_PER_S = 3.35e12

_P, _I = ctypes.c_void_p, ctypes.c_int
# the parent's entry points: B4 without the flags' scratch, B5 as now
PARENT_SIGNATURES = {
    "ell_spmv": {f"ell_spmv_{t}": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                                   _P]
                 for t in ("f32", "f64")},
    "pexchange": {f"pexchange_{t}": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P]
                  for t in ("f32", "f64")},
}


def card_cell():
    """(ELL batch, exchange plan) of the unstructured card cell."""
    from hpddm_tpu_torch.core.formats import pack_local_matrices
    from hpddm_tpu_torch.models import unstructured
    from hpddm_tpu_torch.parallel.decomposition import Decomposition
    from hpddm_tpu_torch.parallel.pexchange import build_plan

    gen = unstructured.generate(S, NX, NX, overlap=2, with_neumann=False,
                                partition="geometric")
    dec = Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                        gen.n_loc, d=gen.d, device="cuda")
    A = pack_local_matrices(gen.mats, n_max=dec.n_max, device="cuda")
    return A, build_plan(dec)


def parent_calls(lib, A, plan):
    """(B4, B5) of the parent's kernels, called as this tree's wrappers
    call theirs."""
    Sx, w, n = A.values.shape
    pay = A.payload
    stream = torch.cuda.current_stream().cuda_stream

    def ell(x):
        fn = lib.ell_spmv_f64 if x.dtype == torch.float64 \
            else lib.ell_spmv_f32
        y = torch.empty_like(x)
        err = fn(A.values.data_ptr(), pay.cols.data_ptr(),
                 int(pay.cols.dtype == torch.uint16), pay.counts.data_ptr(),
                 x.data_ptr(), y.data_ptr(), Sx, n, w, x.shape[2], stream)
        assert err == 0, f"parent ell_spmv launch: cudaError {err}"
        return y

    def pex(x):
        fn = lib.pexchange_f64 if x.dtype == torch.float64 \
            else lib.pexchange_f32
        y = torch.empty_like(x)
        err = fn(x.data_ptr(), y.data_ptr(), plan.interior.data_ptr(),
                 plan.dst.data_ptr(), plan.rows.data_ptr(), Sx, n,
                 plan.m_max, plan.k_max, x.shape[2], stream)
        assert err == 0, f"parent pexchange launch: cudaError {err}"
        return y

    return ell, pex


def main(argv=None):
    from hpddm_tpu_torch import _build
    from hpddm_tpu_torch.examples.library_ops import ell_csr, exchange_csr
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.parallel import pexchange as pk
    from hpddm_tpu_torch.timing import cold_events_ms, read_flushed_ms

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--mus", default="1,4,640")
    p.add_argument("--parent", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ell: needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    _build.load()
    for stem, log in sorted(_build.LOGS.items()):
        for rec in _build.resources(log):
            if stem != "dia_spmv":
                print(f"  {stem}.cu {rec['kernel']}: {rec['registers']} "
                      f"registers, spills {rec['spill_stores']} / "
                      f"{rec['spill_loads']} B")
    A, plan = card_cell()
    vals = A.values
    Sx, w, n = vals.shape
    nnz = int(torch.count_nonzero(vals))
    slots = int((plan.dst >= 0).sum())
    partners = int((plan.rows >= 0).sum())
    print(f"card cell: S={Sx}, n_max={n}, w={w}, {nnz} nonzeros "
          f"({100 * nnz / vals.numel():.1f}% of the slots), m_max="
          f"{plan.m_max}, k_max={plan.k_max}, {slots} interface slots, "
          f"{partners} partner rows, columns {A.payload.cols.dtype}")
    ell_parent = pex_parent = None
    if args.parent:
        root = os.path.abspath(args.parent)
        plib = _build.load_from(
            os.path.join(root, "hpddm_tpu_torch", "csrc"),
            os.path.join(root, "hpddm_tpu_torch", "build"), PARENT_SIGNATURES)
        ell_parent, pex_parent = parent_calls(plib, A, plan)
    no_counts = dataclasses.replace(A.payload, counts=None)
    E4 = ell_csr(vals, A.cols)
    E5 = exchange_csr(plan, vals.dtype)
    one = torch.empty(1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for mu in (int(m) for m in args.mus.split(",")):
        x = torch.randn((Sx, n, mu), generator=gen, device="cuda",
                        dtype=vals.dtype)
        xs = x.reshape(-1, mu)
        # the nonzeros' values and columns at the width the payload stores
        b4 = nnz * (vals.element_size() + A.payload.cols.element_size()) + \
            2 * x.numel() * x.element_size()
        b5 = 2 * x.numel() * x.element_size() + plan.interior.numel() + \
            4 * (slots + partners)
        cases = [("B4", b4, lambda: ek.ell_spmv(vals, A.cols, x, A.payload),
                  ek.ell_spmv_payload_reference(vals, A.payload, x),
                  [("no row counts",
                    lambda: ek.ell_spmv(vals, A.cols, x, no_counts))]
                  + ([("parent", lambda: ell_parent(x))] if ell_parent
                     else []),
                  lambda: torch.sparse.mm(E4, xs)),
                 ("B5", b5, lambda: pk.pexchange(plan, x),
                  pk.pexchange_reference(plan, x),
                  [("parent", lambda: pex_parent(x))] if pex_parent else [],
                  lambda: torch.sparse.mm(E5, xs))]
        for kernel, nbytes, fn, want, alts, library in cases:
            same = {"kernel": torch.equal(fn(), want)}
            for label, alt in alts:
                same[label] = torch.equal(alt(), want)
            ok = ok and all(same.values())
            bound_us = nbytes / HBM_BYTES_PER_S * 1e6
            half = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
            dst = torch.empty_like(half)
            reps = args.reps if mu <= 64 else max(5, args.reps // 3)
            for flush, timer in (("write", cold_events_ms),
                                 ("read", read_flushed_ms)):
                us = timer(fn, reps) * 1e3
                alt_txt = "; ".join(f"{label} {timer(alt, reps) * 1e3:.2f} us"
                                    for label, alt in alts)
                lib_us = timer(library, reps) * 1e3
                copy_us = timer(lambda: dst.copy_(half), reps) * 1e3
                one_us = timer(one.zero_, reps) * 1e3
                print(f"{kernel} mu={mu} f64 {flush} flush: kernel {us:.2f} "
                      f"us, bound {bound_us:.2f} us ({100 * bound_us / us:.1f}"
                      f"%); {alt_txt + '; ' if alt_txt else ''}"
                      f"torch.sparse.mm {lib_us:.2f} us (kernel / library "
                      f"{us / lib_us:.3f}); a copy of the same "
                      f"{nbytes / 1e6:.2f} MB {copy_us:.2f} us, a one-element "
                      f"kernel {one_us:.2f} us")
            print(f"{kernel} mu={mu}: bitwise equal to the plain version: "
                  + ", ".join(f"{k} {v}" for k, v in same.items()))
            del half, dst, want
        del x, xs
        torch.cuda.empty_cache()
    print(f"card: {smi}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
