#!/usr/bin/env python
"""The DIA kernels (B1, B2, B3) at the grid card cell beside the floors of
the cold measurement.

    python -m hpddm_tpu_torch.examples.bench_dia [--reps 30]

At the grid card cell's shape (S=64, nd=5, n=4356, offsets -64, -1, 0, 1,
64; f64, random values from a seed) it times B1 (one right-hand side),
B2 (x (S, n, mu)) at mu=4 and 640 and B3 (x (S, mu, n)) at mu=640, each
beside its bound (the bytes moved at 3.35 TB/s) and two floors of the
same bracket: a device copy that moves the same bytes (half read, half
written) and a kernel that writes one element. Every time is the median
of ``--reps`` single calls with the L2 cache flushed before each, twice:
by a write (``timing.cold_events_ms``, the smoke's bracket: the call finds
the L2 full of dirty lines) and by a read (clean lines, as after a kernel
that only reads, such as the local solve's bmm). Every result is held
bitwise to ``dia_spmv_reference``. Prints the card's name and power limit.
"""

import argparse
import subprocess
import sys

import torch

S, N, OFFSETS = 64, 4356, (-64, -1, 0, 1, 64)
HBM_BYTES_PER_S = 3.35e12


def main(argv=None):
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.timing import cold_events_ms, read_flushed_ms

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_dia: needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    vals = torch.randn((S, len(OFFSETS), N), generator=gen, device="cuda",
                       dtype=torch.float64)
    one = torch.empty(1, device="cuda")
    cases = [("B1", 1, kmod.dia_spmv), ("B2", 4, kmod.dia_spmm),
             ("B2", 640, kmod.dia_spmm), ("B3", 640, kmod.dia_spmm_muT)]
    for kernel, mu, fn in cases:
        shape = (S, N) if mu == 1 else \
            (S, mu, N) if kernel == "B3" else (S, N, mu)
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float64)
        want = kmod.dia_spmm_muT_reference(vals, x, OFFSETS) \
            if kernel == "B3" else kmod.dia_spmv_reference(vals, x, OFFSETS)
        same = torch.equal(fn(vals, x, OFFSETS), want)
        nbytes = (vals.numel() + 2 * x.numel()) * 8
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        half = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(half)
        for flush, timer in (("write", cold_events_ms),
                             ("read", read_flushed_ms)):
            us = timer(lambda: fn(vals, x, OFFSETS), args.reps) * 1e3
            copy_us = timer(lambda: dst.copy_(half), args.reps) * 1e3
            one_us = timer(one.zero_, args.reps) * 1e3
            print(f"{kernel} mu={mu} f64 {flush} flush: {us:.2f} us, bound "
                  f"{bound_us:.2f} us ({100 * bound_us / us:.1f}%); a copy "
                  f"of the same {nbytes / 1e6:.2f} MB {copy_us:.2f} us, a "
                  f"one-element kernel {one_us:.2f} us; bitwise equal: "
                  f"{same}")
        del x, want, half, dst
        if not same:
            return 1
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
