#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``hpddm_tpu_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one CUDA GPU

Phases (any failure exits non-zero before the last line is printed):

1. device: a CUDA GPU is required; TF32 is switched off for matmuls and
   cuDNN, so float32 products run in full float32;
2. build: the CUDA kernels are compiled from ``hpddm_tpu_torch/csrc``,
   with each kernel's registers, shared memory and spills as ptxas
   reports them;
3. kernel vs plain: the DIA SpMV kernel (B1) against its plain PyTorch
   version on the card, bitwise, in f32 and f64, at ``DIA_CASES``: the
   oracle and card-scale shapes and the edges of the kernel's paths; then
   B1 and B2 in complex128 at the same shapes and ``COMPLEX_MUS``, also
   with a NaN and an inf in the imaginary parts of x;
4. oracle parity: the two-level GenEO-RAS + GMRES main path at 100x100,
   S=4, nu=10, deflated, in f64, must take exactly the JAX package's
   CPU-f64 iteration counts (``ORACLE_ITS``); then the same run in f32;
5. card scale: the main path at 512x512, S=64, overlap 1, nu=10, tol 1e-6,
   with setup phases, solve time, peak memory, kernel launch counts,
   plain-version calls (must be 0) and the time of one gmv through the
   kernel and through the plain version;
6. kernels vs plain, slice 2: the ELL SpMV kernel (B4, with its payload)
   and the one-pass exchange kernel (B5) against their plain PyTorch
   versions on the card, bitwise, in f32 and f64, at the unstructured test
   size, at card size, at a ragged n with an all-padding row and rows of
   every length, at int32 columns (n > 65,535), and at mu=1, 3 and 4;
7. unstructured parity: the P1-FEM path (60x60 Delaunay mesh, S=8,
   overlap 2, k-way, GenEO nu=8, deflated, ELL) in f64 must take exactly
   the JAX package's CPU-f64 iteration counts (``UNSTR_ITS``) on the card
   and on this machine's CPU, with a true global residual <= 1e-6 at tol
   1e-6; then one f32 run;
8. unstructured card scale: 512x512 mesh, S=64, overlap 2, geometric
   partition, nu=10, tol 1e-6, with setup phases, solve time, then
   pseudo-block gmres over 4 consistent random right-hand sides, peak
   memory, B4/B5 launch counts in all and by panel width (each width that
   is timed must have launched on the path), plain-version calls (must be
   0), B4 and B5 against their plain versions (bitwise) at mu=1, 4 and the
   coarse assembly's panel width (mu = coarse size), each timed beside its
   bound and torch.sparse.mm on the matrix of the same linear map, and one
   gmv;
9. kernel vs plain, slice 4: the DIA SpMM kernel in both panel layouts,
   (S, n, mu) (B2, ``dia_spmm``) and (S, mu, n) (B3, ``dia_spmm_muT``),
   against the plain version, bitwise, in f32 and f64 at phase 3's shapes
   and every mu of ``SPMM_MUS``, and mu=640 (the coarse panel) at card
   size;
10. multi-RHS parity: every method and sequence of ``MULTI_ITS`` at the
   oracle in f64 must take the JAX package's CPU-f64 counts per
   right-hand side (one iteration of slack for ``MULTI_SLACK``), with
   recomputed residuals <= 1e-5 per right-hand side (``MULTI_RES`` where
   the method stops on another residual); then f32 gmres and bgmres at
   mu=4;
11. multi-RHS card scale, on phase 5's state: pseudo-block gmres and
   bgmres over 4 consistent random right-hand sides (best of 3 after a
   warm-up; time per right-hand side beside phase 5's single-RHS solve),
   a recycled gcrodr sequence at mu=1, peak memory, launch counts and
   plain-version calls (must be 0), B2 at mu=4 and B2 and B3 at the
   coarse panel against their plain versions (bitwise), their bounds and
   torch.sparse.mm, one gmv at mu=4 and the time of bgmres's block least
   squares;
12. banded grid card cell (generate_uniform 512x512, S=64, overlap 1,
   n_max 4356, nu=10, f64, tol 1e-6; ``set_grid_geometry``: the slab
   exchange and the canvas operator): (a) banded local solves with Lanczos
   GenEO (the JAX package's count ``BANDED_GRID_ITS``; setup phases, solve
   time, peak memory, B1 launches in GenEO and in the solve, plain-version
   calls 0), then Lanczos at ``BANDED_NCV`` steps; (b) dense GenEO once,
   and inv and banded states on its vectors, which must take equal counts
   (Lanczos at ``BANDED_NCV`` within 2 of it), the two local solves
   agreeing to 1e-10; (c) one local
   solve at mu=1 and 4 against the inv bmm, time per iteration,
   banded_block_rows 1, 2 and 4 (equal counts) and the f64 factor on the
   host and on the card (agreeing to 1e-12); (d) the f32 device factor
   (local residuals < 5e-4);
13. unstructured card cell through RCM, on phase 8's problem and setup:
   (a) banded on phase 8's dense-GenEO vectors (phase 8's count exactly),
   (b) banded with Lanczos GenEO (within 2 of it), both with phase 8's
   true-residual gate; bandwidths, factor bytes, local solve and
   iteration times, GenEO against phase 8's, peak memory, B4/B5 launches
   and plain-version calls (must be 0);
14. GMV cells (examples/bench_gmv.py), f64, on the slab exchange and the
   canvas operator: bench.py's 2048x2048/16 and the banded grid cell's
   512x512/64: a chain of gmv calls (the path; B1 launches, plain-version
   calls 0), its time, nonzeros per second, share of the bound and
   device operations, the SpMM and three exchanges back to back (slab,
   plain general, B5), B1 and B2 (mu=4, 8) against the plain canvas form
   (bitwise), the slab exchange within 1e-13 of the general one; at
   2048x2048/16 the gmv of four right-hand sides through its RHS-leading
   branch (a chain: B3 launches, no B2, plain-version calls 0), B3 at mu=2,
   3, 4 against its plain version and the plain canvas form and the gmv
   against the trailing-mu path (bitwise), and its time against the
   trailing-mu path (B2 + the permuted slab exchange) and the per-group
   scan forms;
15. flagship512 (examples/flagship.py: generate_uniform(16, 512, 512),
   contrast-1e4 channel, Jacobi-scaled, banded, Lanczos GenEO nu=8,
   block-sparse coarse assembly, deflated): f32 solved at tol 1e-6 then
   refined on the host to 1e-10 (and by double-word refinement on the
   device), f64 solved at tol 1e-8 alone; each must reach a true
   relative residual <= 1e-8, f64 in the JAX package's CPU count
   (``FLAGSHIP_ITS``), f32 within one of its f32 count with its GenEO
   run op by op; setup phases, solve, refine, time to true 1e-8 and peak
   memory; B1/B2 launches (B2 in the bsr assembly, mu=8), plain-version
   calls 0, B1 and B2 at mu=8 against the plain canvas form (bitwise);
16. ladder256 (examples/ladder.py: generate_uniform(256, 2048, 2048),
   n_max 16,900, the same channel, Jacobi-scaled once in f64 and cast for
   f32, banded, Lanczos GenEO nu=8, block-sparse coarse assembly, N_c
   2048, nested level-2 CG (tol 1e-2, at most 50) with a direct level 3,
   deflated, flexible GMRES restart 40): f32 solved at tol 2e-3 then
   refined on the host to 1e-10, f64 solved at tol 1e-8 alone; each must
   reach a true relative residual <= 1e-8 within 80 GB, in coarse mode
   bsr with a direct level 3; outer and inner iterations, setup phases,
   solve, refine, time to true 1e-8, peak memory, B1/B2 launches,
   plain-version calls 0, one coarse solve and one apply against an
   outer iteration, B1 and B2 at mu=8 and B3 at mu=2, 3, 4 against their
   plain versions (bitwise);
17. the elasticity flagship (examples/bench_elasticity.py, the twin of
   tools/bench_elasticity.py: elasticity2d.generate(8, 512, 512),
   contrast 1e3, overlap 2, 2D box partition, Jacobi-scaled, banded local
   solves with dense coupling on the node rows, Lanczos GenEO nu=16,
   deflated, GMRES(60), f64, tol 1e-8): recomputed relative residual <=
   1e-8, true relative residual of the unscaled global system <= 1e-6,
   converged; the same solve with modified Gram-Schmidt within 2 of the
   JAX package's CPU count (``ELAST_ITS``; the classical Gram-Schmidt
   count is driven by rounding at this size and printed beside the JAX
   package's range), dense coupling engaged, peak < 80 GB,
   B1 launches, plain-version calls 0; setup phases, solve, time per
   iteration, factor bytes, peak; one banded solve and one gmv against an
   iteration; B1 at nd=21 against its plain version (bitwise);
18. 3D diffusion (diffusion3d.generate_uniform(64, 64, 64, 64), overlap
   1, checkerboard contrast 1e3, 18^3 boxes, f64, tol 1e-8): Lanczos
   GenEO nu=8 once (banded inner solve), then inv and plane-blocked
   banded on its vectors (equal counts) and one-level inv (no fewer);
   residuals <= 1e-8, B1 launches, plain-version calls 0; B1 at nd=7
   against its plain version (bitwise);
19. 3D elasticity (elasticity3d.generate(8, 24, 24, 24), contrast 1e3,
   overlap 2, k-way, ELL, inv, tol 1e-6): one-level, GenEO nu=10 by
   Lanczos and by the dense pencil (below one-level); B4/B5 launches,
   plain-version calls 0, B4 and B5 at this operator (rows of up to 80
   slots) against their plain versions (bitwise) beside the bound and
   torch.sparse.mm;
20. the recycling sequence (examples/driver.py: 10 systems, n=2025,
   GMRES(40) and GCRODR(40,20), tol 1e-10, f64): the totals in the
   reference-derived windows, GCRODR below GMRES;
21. Helmholtz (models/helmholtz.py, examples/helmholtz.py; ORAS on the
   Robin-optimized local matrices): (a) the anchors at 60x60, S=4, k=6,
   eps=0 within 2 of the CPU counts (c128 ORAS and SORAS, the real pair
   in f64 and f32), c128 RAS above ORAS; (b) the full cell 512x512,
   S=64, k=25.6, eps=0.3 in native complex128 (within 2 of
   ``HELM_FULL_ITS``) and in the real pair f64 (31 diagonals, n_max
   8712): iterations, residuals, solve, setup by phase, inverse bytes,
   peak, B1 launches, plain-version calls 0, which route pays; reported
   only, c128 RAS at eps=0.3 and ORAS at eps=0; (c) the twin's recycling
   sweep (3 wavenumbers, GMRES(200) and GCRODR(200,10)): GCRODR at most
   GMRES + 10; (d) four random c128 right-hand sides on (b)'s state
   (B2 c128 on the path), every residual <= 1e-5; B1 and B2 c128 and B1
   f64 at 31 diagonals timed beside their bounds and torch.sparse.mm;
22. slice 5a: the renumbered production configuration, the reuse
   sequence, exchange_matrices + restriction, the bf16 mirror, the GenEO
   estimate and the dumps (``phase_slice_5a``);
23. slices 5d + 5e(ii) (``phase_slice_5d``): (a) one-level FFT-RAS at the
   oracle, the JAX package's count ``FFT_ORACLE_ITS``, and the fft and
   matmul DST modes within 1e-10; (b) the heterogeneous cell of
   examples/hetero.py (generate_uniform(16, 1024, 1024), contrast 1e4,
   Jacobi-scaled, dst_cheby k=32, Lanczos GenEO nu=16, bsr, f64, tol
   1e-8) within 1 of the JAX package's count on its Chebyshev bounds
   (``HETERO_JAX_BOUNDS``), and on the port's own start vectors inside
   its converged counts over start vectors (``HETERO_JAX_ITS``), banded
   on its GenEO vectors (not above it), B1 and B2 at the path's shapes,
   every local solver timed at mu=1 and 4, and where a
   Chebyshev apply spends its time; (c) fft two-level on the constant
   coefficient beside banded; (d) the dense Schwarz variant at
   generate(16, 256, 256) with the bmm gmv and the sparse gmv as its user
   GMV (equal counts), EVP + deflated on the card and the host CPU; (e)
   MAC Stokes at N=``STOKES_N`` with GenEO and banded (RCM) inner solves
   (block residuals, B4/B5 at its operator);
24. slice 5e(i)a, FETI and BDD with exact solves (``phase_slice_5e``):
   (a) tools/bench_feti.py's default cell through
   examples/bench_feti.py (generate(64, 128, 128), f64, tol 1e-8): FETI in
   the four preconditioners and BDD, dense and mfree, each within 1 of the
   JAX package's CPU count (``FETI_JAX_ITS``), the averaged solution within
   1e-6 of the direct solve; (b) the GenEO cell (generate(64, 256, 256,
   contrast=1e4, checker=16)): FETI and BDD base (at their cap in both
   packages) within 1, after solve_gevp(nu=6, feti_deflation=True)
   converged, deflated below base, enriched not above, and within 10% of
   the JAX package's counts (the pencil is degenerate at nu: ROADMAP C20);
   (c) the scale cell generate(1024, 1024, 1024) (1,048,576 unknowns):
   setup by phase and its peak, FETI (dirichlet) and BDD in the dense and
   mfree coarse modes, best of 3 after a warm-up with the same count in
   every repeat, ms per iteration, the K^+ bmm against its bound, true
   residuals <= 1e-6 on A_global, FETI and BDD within 1e-6 of each other,
   mfree FETI = dense, mfree BDD within 5 of dense, peak < 80 GB. Phase 24
   takes at most 180 s;
25. slices 5e(i)b and 5f (``phase_slice_5eb``), every cell with banded
   local solves (K^+ refined on banded factors, implicit S_b through B1/B2,
   Chebyshev S_b^+): (a) generate(64, 128, 128) in the dense, mfree and
   cheby coarse modes, FETI (dirichlet, lumped, none) and BDD against the
   JAX package's CPU counts ``FETI5B_JAX_ITS`` (dirichlet exact, lumped and
   none within 1: C22; BDD in C21's window, which is exact), solutions
   within 1e-6 of the direct solve; (b) the GenEO cell (contrast 1e4,
   checker 16) in the cheby coarse mode, where nothing converges in
   either package (C23): FETI before and after Lanczos solve_gevp(nu=6,
   feti_deflation=True) at a cap of 150, BDD base and enriched at 5,
   base FETI's and BDD's residuals within a factor 2 of the JAX package's
   at the same caps (``FETI5B_JAX_RES``), the deflated residual below a
   tenth of base's; (c) the scale cell generate(16,
   512, 512) (128^2 local boxes, 262,144 unknowns; generate(64, 1024, 1024)
   cut to 16 subdomains for the run's time limit): setup by phase, factor
   bytes, FETI and BDD in the mfree and cheby coarse modes to 1e-8, FETI
   best of 3 and each BDD solve once (host-paced), true residuals <= 1e-6,
   the device-busy share of a one-iteration BDD solve, peak < 80 GB; (d) LeastSquaresSolver at
   256x256 (S=16, one level and GenEO, both to 1e-8, GenEO below 0.7 of
   one level), spsd_neumann GenEO at 60x60/S=8, and the five new example
   twins on matrix files written there; B1/B2 records at (b)'s and (c)'s
   shapes. The whole run takes less than 1,100 s.

Phase 5 drives the DIA path, phase 8 the unstructured path, phase 11 the
multi-RHS path, phase 12 the banded grid path, phase 13 the banded
unstructured path, phase 14 the grid gmv (and its multi-RHS branch),
phase 15 the flagship, phase 16 the ladder, phase 17 the elasticity
flagship, phase 18 the 3D diffusion path, phase 19 the 3D elasticity
path, phase 21 the Helmholtz path (native, four sources, real pair),
phase 23 the hetero dst_cheby, dense-variant and Stokes paths and phase 25
the banded FETI/BDD paths (phase 24's dense FETI/BDD paths launch no
hand-written kernel),
each with its kernels' launch counts set to 0 just before it and read just after; comparisons
and timings come after the counts are read. Each phase's wall seconds
are printed. The script prints one JSON line with the kernels' results
(time, plain time, bound, library time, launches, error), the card's name
and power limit as nvidia-smi reports them, and last
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

# GMRES iteration counts of the JAX package on the CPU in f64 at the
# unstructured parity configuration (60x60 Delaunay mesh, S=8, overlap 2,
# k-way, GenEO nu=8, deflated); tests/test_torch_unstructured.py checks
# them against hpddm_tpu
UNSTR_ITS = {1e-6: 8, 1e-8: 10}

# GMRES iteration count of the JAX package on the CPU in f64 at the banded
# grid cell (generate_uniform 512x512, S=64, overlap 1, banded local
# solves, Lanczos GenEO nu=10 at the default -hpddm_lanczos_ncv, 2 nu + 1 =
# 21, deflated, tol 1e-6); tests/test_torch_banded.py checks it against
# hpddm_tpu. Lanczos stops after ncv steps without a convergence test, and
# at 21 steps its vectors are not those of the dense pencil (17 iterations
# there); at 4 nu + 1 = 41 steps they are, and phase 12 holds that count
# within 2 of the dense vectors'
BANDED_GRID_ITS = 22
BANDED_NCV = 41

# iteration counts per right-hand side of the JAX package on the CPU in f64
# at the oracle (100x100, S=4, GenEO nu=10, deflated, tol 1e-6), one list
# per solve of a sequence that shares one Options object (the recycled
# space of gcrodr/bgcrodr persists in it): name -> (right-hand side, solve
# options, setup options, counts). "f4" is the four random right-hand
# sides of diffusion2d.generate(..., mu=4) made consistent, "f1" the
# closed-form one. tests/test_torch_gmres.py checks them against
# hpddm_tpu.
MULTI_ITS = {
    "gmres": ("f4", {}, {}, [[20, 19, 19, 19]]),
    "bgmres": ("f4", {"krylov_method": "bgmres"}, {}, [[14] * 4]),
    "bcg": ("f4", {"krylov_method": "bcg"}, {}, [[22] * 4]),
    "bfbcg": ("f4", {"krylov_method": "bfbcg"}, {}, [[27] * 4]),
    "richardson": ("f4", {"krylov_method": "richardson"}, {}, [[100] * 4]),
    "gcrodr recycle 20": ("f4", {"krylov_method": "gcrodr", "recycle": 20},
                          {}, [[20, 19, 19, 19]]),
    "bgcrodr recycle 20": ("f4", {"krylov_method": "bgcrodr", "recycle": 20},
                           {}, [[14] * 4]),
    "flexible gmres": ("f4", {"variant": "flexible"}, {},
                       [[20, 19, 19, 19]]),
    "left gmres": ("f4", {"variant": "left"}, {}, [[16, 15, 16, 16]]),
    "gmres restart 10": ("f4", {"gmres_restart": 10}, {},
                         [[24, 23, 24, 24]] * 2),
    "gcrodr restart 10 recycle 5": (
        "f4", {"krylov_method": "gcrodr", "gmres_restart": 10, "recycle": 5},
        {}, [[20] * 4, [13, 14, 13, 13]]),
    # strategy B at recycle 2: at recycle 5 its harmonic Ritz selection is
    # ill-conditioned here (a 1e-15 change of b moves the JAX package's own
    # counts by up to 4)
    "gcrodr restart 10 recycle 2 strategy B": (
        "f4", {"krylov_method": "gcrodr", "gmres_restart": 10, "recycle": 2,
               "recycle_strategy": "B"}, {}, [[20] * 4, [20, 21, 21, 20]]),
    "bgmres restart 10": ("f4", {"krylov_method": "bgmres",
                                 "gmres_restart": 10}, {}, [[18] * 4] * 2),
    "bgcrodr restart 10 recycle 5": (
        "f4", {"krylov_method": "bgcrodr", "gmres_restart": 10,
               "recycle": 5}, {}, [[15] * 4, [10] * 4]),
    "enlarged k=4": ("f1", {"enlarge_krylov_subspace": 4}, {}, [[14]]),
    "cg (gmres under RAS)": ("f1", {"krylov_method": "cg"}, {}, [[19]]),
    "coarse_dtype float32 (flexible gmres)": (
        "f1", {}, {"coarse_dtype": "float32"}, [[19]]),
}
# methods whose count may differ by one on the card (the eigh and harmonic
# Ritz truncations of block CG and of recycling can flip on rounding)
MULTI_SLACK = ("bfbcg", "gcrodr", "bgcrodr")
# the JAX package's own largest recomputed relative residual where the
# method stops on another residual than the true one (left GMRES on the
# preconditioned residual) or at max_it (Richardson); every other solve is
# held to 1e-5
MULTI_RES = {"left gmres": 7.901e-05, "richardson": 1.223e-05}

# one-level FFT-RAS iteration count of the JAX package on the CPU in f64
# at the oracle (100x100, S=4, local_solver fft, tol 1e-6; matmul DST
# mode); tests/test_torch_fft_cheby.py checks it against hpddm_tpu
FFT_ORACLE_ITS = 38

# GMRES iteration counts of the JAX package on the CPU in f64 at the
# heterogeneous cell of examples/hetero.py (tools/bench_hetero.py:
# generate_uniform(16, 1024, 1024), contrast 1e4, Jacobi-scaled, dst_cheby
# k=32, Lanczos GenEO nu=16, bsr, deflated, tol 1e-8), by the seed of the
# Chebyshev bounds' start vector (7 is its default; with 6 the solve stops
# at max_it 100 at 2.1e-8); tests/test_torch_fft_cheby.py (-m slow)
# recomputes them. The lower Chebyshev bound follows rounding (ROADMAP
# C17) and the port draws its start vector otherwise, so phase 23 holds
# the port's counts inside the converged ones widened by 5 below, and its
# residual to 1e-8
HETERO_JAX_ITS = {1: 85, 2: 69, 3: 69, 4: 85, 5: 96, 6: 100, 7: 74}
# the JAX package's Chebyshev bounds per subdomain at that cell (its
# default start vector, seed 7), with which it takes HETERO_JAX_ITS[7]
# iterations, and so does the port on the CPU; phase 23 carries them into
# the port's solver and holds the card's count within 1 of it;
# tests/test_torch_fft_cheby.py (-m slow) recomputes them and holds the
# port's CPU count
HETERO_JAX_BOUNDS = {
    "lo": [1.668930053710938e-05, 1.7336702873488803e-05,
           1.583271418767823e-05, 1.6689300537109375e-05,
           8.452254117733817e-06, 1.0376194864487268e-05,
           1.603153912033889e-05, 7.749278757240254e-06,
           8.35250372327702e-06, 2.709101232135009e-06,
           8.656650855093065e-06, 1.4046548736747807e-07,
           1.6689300537109375e-05, 1.7244276684006482e-05,
           1.50276027436268e-05, 1.668930053710938e-05],
    "hi": [2.5033950805664066e-05, 6.454646398538962e-05,
           3.759741286645841e-05, 2.503395080566408e-05,
           0.0014336197603959581, 0.0014338462012592479,
           0.001433528122671007, 0.00143361976039596,
           0.0014748876173585172, 0.0014751258454757158,
           0.0014747910632732534, 0.0014748876173585198,
           2.5033950805664062e-05, 6.453909335635124e-05,
           3.7697717827688446e-05, 2.503395080566407e-05]}
# the JAX package's CPU f64 counts at smoke phase 24's cells (a)
# tools/bench_feti.py's default, nonoverlap.generate(64, 128, 128), tol
# 1e-8: FETI in each preconditioner and BDD, dense and mfree coarse modes;
# (b) generate(64, 256, 256, contrast=1e4, checker=16), tol 1e-8: FETI and
# BDD before and after solve_gevp(nu=6, feti_deflation=True);
# tests/test_torch_substructure.py (-m slow) recomputes them. Phase 24
# holds the card within 1 of each, (b)'s GenEO counts within 10%
FETI_JAX_ITS = {
    "a dense feti dirichlet": 20, "a dense feti lumped": 37,
    "a dense feti superlumped": 53, "a dense feti none": 48,
    "a dense bdd": 19, "a mfree feti dirichlet": 20,
    "a mfree feti lumped": 37, "a mfree feti superlumped": 53,
    "a mfree feti none": 48, "a mfree bdd": 19,
    # base FETI and BDD stop at their cap (500) unconverged, in both
    # packages; the GenEO counts depend on the eigensolver's basis (C20)
    "b feti": 500, "b bdd": 500, "b feti deflated": 440,
    "b bdd enriched": 476,
}
# the JAX package's CPU f64 counts at smoke phase 25's cells with banded
# locals (-hpddm_substructuring_local banded): (a) generate(64, 128, 128),
# tol 1e-8, FETI in three preconditioners and BDD, in the dense, mfree and
# cheby coarse modes (the same over start keys of the Chebyshev bounds,
# C21); and ``FETI5B_JAX_RES``, the relative residuals at (b)
# generate(64, 256, 256, contrast=1e4, checker=16), cheby coarse, where no
# solve converges in either package (at a cap of 500, FETI 4.3e-05 and
# deflated 1.2e-07, BDD near 1: the Chebyshev S_b^+ degree is clipped at
# 128 while kappa(D S_b D) is about 1.1e4, ROADMAP C23): FETI before and
# after solve_gevp(nu=6, feti_deflation=True) at a cap of 150, BDD base
# and enriched at a cap of 5. tests/test_torch_substructure_banded.py
# (-m slow) recomputes them
FETI5B_JAX_ITS = {f"a {m} {k}": v for m in ("dense", "mfree", "cheby")
                  for k, v in (("feti dirichlet", 20), ("feti lumped", 37),
                               ("feti none", 48), ("bdd", 19))}
FETI5B_CAPS = {"feti": 150, "bdd": 5}
FETI5B_JAX_RES = {"b feti": 0.006865564823952121,
                  "b feti deflated": 0.00023356406604713772,
                  "b bdd": 2.9158138919087255,
                  "b bdd enriched": 2.380734024639147}
# the Stokes cell's grid: the JAX package's k-way partition of the MAC
# velocity block puts a whole velocity component (a separate component of
# A's graph) into one subdomain, n_max 65,373 at N=256, whose dense
# inverses would take 547 GB: phase 23 (e) factors through RCM (banded
# local solver, bandwidth 255 there)
STOKES_N = 256

# the card's peaks for a kernel's bound (NVIDIA H100 SXM data sheet):
# HBM3 bandwidth, and f64 / f32 arithmetic outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}

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


def dtype_name(dt):
    return str(dt).split(".")[1]


def bound(nbytes, flops, dtype):
    """(least milliseconds for the work, what bounds it): the bytes moved
    over the HBM rate against the operations over the peak of dtype."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_ms(csr, x):
    """Cold milliseconds of torch.sparse.mm(csr, x), or None (printed) when
    the installed PyTorch cannot run it on the card."""
    import torch
    from hpddm_tpu_torch.timing import cold_events_ms

    try:
        return cold_events_ms(lambda: torch.sparse.mm(csr, x))
    except (RuntimeError, NotImplementedError) as e:
        print(f"  torch.sparse.mm not timed: {e}")
        return None


def kernel_record(name, source, replaces, launches, max_err, ms, plain_ms,
                  bound_ms, bound_by, lib_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def build_problem(S, N, nu, dtype, device, timings=None, mu=0,
                  schwarz=None):
    """(options, state, right-hand side) of the grid main path: the
    closed-form right-hand side (S, n_max, 1), or with mu > 0 the mu random
    ones of diffusion2d.generate made consistent. With ``schwarz`` a list,
    the Schwarz setup object is appended to it (to rebuild the state with
    other setup options)."""
    import torch
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz

    t = time.perf_counter()
    gen = diffusion2d.generate(S, N, N, overlap=1, with_neumann=True,
                               dtype=dtype, mu=mu)
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    opt = Options(schwarz_coarse_correction="deflated", geneo_nu=nu)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt, device=device)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    sch.solve_gevp(gen.neumann)
    state = sch.build()
    f = torch.as_tensor(diffusion2d.padded_rhs(gen.f, sch.n_max, dtype),
                        device=device)
    if mu:
        f = sch.exchange_rhs(f)
    if timings is not None:
        timings.update(generate=t_gen, decomposition=t_dec, **sch.timings)
    if schwarz is not None:
        schwarz.append(sch)
    return opt, state, f


def checked_residual(state, f, res):
    """Largest recomputed relative residual of a solve's right-hand sides
    (``checked_residual_per_rhs``)."""
    return max(checked_residual_per_rhs(state, f, res))


def solve_checked(state, f, opt, tol):
    from hpddm_tpu_torch.solvers.krylov import solve

    opt["tol"] = tol
    res = solve(state, f, opt=opt)
    return res, checked_residual(state, f, res)


# the DIA kernels' check shapes: the oracle (odd n: B1's and B3's scalar
# units with the unrolled 5-diagonal loop), the card cell (16-byte units),
# a ragged n, |offset| >= n, a single and a single shifted diagonal (the
# run-time diagonal loop), n below one block's rows (even and odd), an odd
# n with 5 diagonals, one subdomain, and an offset span wider than most of
# the rows (few units without bounds checks)
DIA_CASES = [("oracle", 4, 2601, (-50, -1, 0, 1, 50)),
             ("card", 64, 4356, (-64, -1, 0, 1, 64)),
             ("ragged n", 3, 1000, (-3, 0, 7)),
             ("|offset| >= n", 2, 300, (-400, -1, 0, 350)),
             ("single diagonal", 5, 777, (0,)),
             ("single shifted diagonal", 2, 513, (9,)),
             ("n below one block", 3, 40, (-2, 0, 1)),
             ("odd n below one block", 2, 37, (-3, 0, 2)),
             ("odd n, 5 diagonals", 4, 1001, (-33, -1, 0, 1, 33)),
             ("one subdomain", 1, 4356, (-64, -1, 0, 1, 64)),
             ("wide offset span", 2, 20000, (-9000, -1, 0, 1, 9000))]
# the panel widths of phase 9: odd ones and ones that are not a multiple
# of the 16-byte vector or of B3's chunk of right-hand sides; 640 (the
# coarse panel) at the card cell only
SPMM_MUS = (2, 3, 4, 5, 8, 9, 31, 33, 65, 640)


def phase_kernels():
    import torch
    from hpddm_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_reference

    rng = np.random.default_rng(1234)
    worst = 0.0
    for name, S, n, offs in DIA_CASES:
        vals_np = rng.normal(size=(S, len(offs), n))
        x_np = rng.normal(size=(S, n))
        for dt in (torch.float64, torch.float32):
            vals = torch.as_tensor(vals_np, device="cuda").to(dt)
            x = torch.as_tensor(x_np, device="cuda").to(dt)
            y = dia_spmv(vals, x, offs)
            ref = dia_spmv_reference(vals, x, offs)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            same = torch.equal(y, ref)
            print(f"  kernel vs plain [{name}, S={S}, n={n}, offsets={offs}, "
                  f"{dt}]: max|err| = {err:.3e}, bitwise equal: {same}")
            check(same, f"kernel differs from plain: {name} {dt}")
            worst = max(worst, err)
    for name, S, n, offs in DIA_CASES:
        for mu in COMPLEX_MUS:
            worst = max(worst, check_complex_dia(name, S, n, offs, mu, rng))
    return worst


# the panel widths of phase 3's complex128 checks: B1 and B2 at odd mu
COMPLEX_MUS = (1, 3, 5)


def same_bits(y, ref):
    """y and ref hold NaN at the same entries (real or imaginary part) and
    the same bits everywhere else."""
    import torch

    yr, rr = torch.view_as_real(y), torch.view_as_real(ref)
    nan = torch.isnan(rr)
    return torch.equal(torch.isnan(yr), nan) and torch.equal(yr[~nan],
                                                            rr[~nan])


def check_complex_dia(name, S, n, offs, mu, rng):
    """B1 (mu = 1) or B2 in complex128 against the plain version, bitwise:
    on normal random values and x, then with a NaN and an inf in the
    imaginary parts of two entries of x (NaN where the plain version has
    it, the same bits elsewhere). Returns the largest |difference|."""
    import torch
    from hpddm_tpu_torch.ops import dia_spmv as kmod

    def cplx(*shape):
        return torch.complex(*(torch.as_tensor(rng.normal(size=shape),
                                               device="cuda")
                               for _ in range(2)))
    vals = cplx(S, len(offs), n)
    x = cplx(S, n) if mu == 1 else cplx(S, n, mu)
    fn = kmod.dia_spmv if mu == 1 else kmod.dia_spmm
    y, ref = fn(vals, x, offs), kmod.dia_spmv_reference(vals, x, offs)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    same = torch.equal(y, ref)
    x[0, n // 2] = complex(0.5, float("nan"))
    x[-1, n - 1] = complex(-1.5, float("inf"))
    yi, ri = fn(vals, x, offs), kmod.dia_spmv_reference(vals, x, offs)
    same_nf = same_bits(yi, ri)
    print(f"  kernel vs plain [{name}, S={S}, n={n}, mu={mu}, complex128]: "
          f"max|err| = {err:.3e}, bitwise equal: {same}; with a NaN and an "
          f"inf imaginary part in x: "
          f"{int(torch.isnan(torch.view_as_real(ri)).sum())} NaN parts, "
          f"equal: {same_nf}")
    check(same and same_nf, f"complex kernel differs from plain: {name} "
          f"mu={mu}")
    return err


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
    from hpddm_tpu_torch.examples.library_ops import dia_csr
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.ops.spmv import spmm_dia
    from hpddm_tpu_torch.parallel.ops import scaled_exchange
    from hpddm_tpu_torch.precond.schwarz import gmv
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import cold_events_ms, events_ms, timed

    S, N = 64, 512
    print(f"phase 5: card scale ({N}x{N}, S={S}, overlap 1, nu=10, f64, "
          "tol 1e-6)")
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kmod.launches = kmod.spmm_launches = 0   # the main path's counts from here
    plain[0] = 0
    timings = {}
    sch = []
    opt, state, f = build_problem(S, N, 10, np.float64, "cuda", timings,
                                  schwarz=sch)
    # phase 22 (b) rebuilds this setup (its GenEO vectors kept) for the
    # reuse sequence; the object keeps no factors (no reuse option here)
    grid = dict(sch=sch[0], timings=dict(timings))
    after_setup = kmod.launches
    spmm_setup = kmod.spmm_launches          # the coarse assembly's panel
    opt["tol"] = 1e-6
    best, solve_s, res = timed(lambda: solve(state, f, opt=opt), reps=3,
                               warmup=1)
    launches = kmod.launches                 # read just after the main path
    spmm_launches = kmod.spmm_launches
    plain_calls = plain[0]
    rel = checked_residual(state, f, res)
    grid.update(its=res.iterations, f=f)
    peak = torch.cuda.max_memory_allocated()
    per_solve = (launches - after_setup) // 4
    check(bool(res.converged.all()) and res.iterations < int(opt.val("max_it")),
          f"card scale did not converge in {res.iterations} iterations")
    check(rel <= 1e-5, f"card-scale recomputed rel. residual {rel:.3e}")
    check(per_solve > 0 and launches > after_setup,
          f"kernel launches: setup {after_setup}, after 4 solves {launches}")
    check(spmm_setup > 0 and spmm_launches == spmm_setup,
          f"dia_spmm launches: setup {spmm_setup}, in all {spmm_launches}")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")
    print(f"  n_max {state.dec.n_max}, coarse size "
          f"{state.coarse.N_c}, DIA offsets {state.A.offsets}")
    print("  setup seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in timings.items()))
    print(f"  solve: {res.iterations} iterations, recomputed rel. residual "
          f"{rel:.3e}, best of 3 after a warm-up {best:.4f} s "
          f"({', '.join(f'{t:.4f}' for t in solve_s)})")
    print(f"  peak device memory {peak / 2**30:.2f} GiB "
          "(torch.cuda.max_memory_allocated)")
    print(f"  dia_spmv launches: {after_setup} in setup, {per_solve} per "
          f"solve, {launches} in all; dia_spmm launches: {spmm_setup} in "
          f"setup (the coarse assembly's panel, mu = "
          f"{state.coarse.N_c}; its time is the 'coarse' setup "
          f"phase), {spmm_launches} in all; plain-version calls on the card "
          f"{plain_calls}")

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
    b_ms, b_by = bound(nbytes, 2 * int(torch.count_nonzero(vals)),
                       vals.dtype)
    csr = dia_csr(vals, offs)
    lib_ms = library_ms(csr, xs.reshape(-1, 1))
    lib_txt = "not timed" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
    print(f"  dia_spmv at (S={state.dec.S}, nd={len(offs)}, "
          f"n={state.dec.n_max}) f64: "
          f"kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
          f"torch.sparse.mm {lib_txt} with L2 "
          f"flushed; {k_warm * 1e3:.2f} / {p_warm * 1e3:.2f} us back to back; "
          f"{nbytes / 1e6:.2f} MB moved -> kernel "
          f"{nbytes / (k_ms * 1e-3) / 1e9:.0f} GB/s (L2 flushed), bound "
          f"{b_ms * 1e3:.2f} us ({b_by}) = {100 * b_ms / k_ms:.1f}% of it")
    print(f"  gmv: {g_k * 1e3:.2f} us through the kernel, {g_p * 1e3:.2f} us "
          "through the plain version (best of 5 x 50)")
    return kernel_record(
        "dia_spmv", "hpddm_tpu_torch/csrc/dia_spmv.cu",
        "hpddm_tpu/ops/pallas_spmv.py:98", launches, None, k_ms, p_ms,
        b_ms, b_by, lib_ms), g_k, (opt, state, best, spmm_setup), grid


def random_ell(rng, S, n, w, band, pad_row=False):
    """Slot-major (S, w, n) ELL values and int32 columns, each row's
    columns within +-band of the row, each row of a random length in
    [1, w] followed by padding (value 0, column 0); with pad_row, row 0 of
    subdomain 0 is all padding."""
    rows = np.arange(n)[None, None, :]
    cols = np.clip(rows + rng.integers(-band, band + 1, size=(S, w, n)),
                   0, n - 1).astype(np.int32)
    vals = rng.normal(size=(S, w, n))
    pad = np.arange(w)[None, :, None] >= rng.integers(1, w + 1,
                                                      size=(S, 1, n))
    vals[pad] = 0.0
    cols[pad] = 0
    if pad_row:
        vals[0, :, 0] = 0.0
        cols[0, :, 0] = 0
    return vals, cols


def check_ell(name, A, mus, rng):
    """B4 against its plain version on the ELL batch A (with its payload),
    bitwise, in f32 and f64 for each mu in mus; returns the largest
    |difference|."""
    import torch
    from hpddm_tpu_torch.ops import ell_spmv as ek

    S, w, n = A.values.shape
    worst = 0.0
    for mu in mus:
        x64 = torch.as_tensor(rng.normal(size=(S, n, mu)), device="cuda")
        for dt in (torch.float64, torch.float32):
            B, x = A.astype(dt), x64.to(dt, copy=True)
            y = ek.ell_spmv(B.values, B.cols, x, B.payload)
            ref = ek.ell_spmv_payload_reference(B.values, B.payload, x)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            same = torch.equal(y, ref)
            # x[0, 0] = inf: NaN where the plain version (and the full slot
            # sum) has it, the same bits elsewhere
            x[0, 0] = float("inf")
            yi = ek.ell_spmv(B.values, B.cols, x, B.payload)
            ri = ek.ell_spmv_payload_reference(B.values, B.payload, x)
            nan = torch.isnan(ri)
            same_inf = torch.equal(torch.isnan(yi), nan) and \
                torch.equal(yi[~nan], ri[~nan])
            print(f"  ell_spmv vs plain [{name}, S={S}, w={w}, n={n}, "
                  f"mu={mu}, {dt}, columns {B.payload.cols.dtype}]: "
                  f"max|err| = {err:.3e}, bitwise equal: {same}; with "
                  f"x[0, 0] = inf: {int(nan.sum())} NaN, equal: {same_inf}")
            check(same and same_inf,
                  f"ell_spmv differs from plain: {name} mu={mu} {dt}")
            worst = max(worst, err)
            del y, ref, yi, ri
    return worst


def check_pexchange(name, dec, rng, mus=(1, 3)):
    """B5 against its plain version and the port's plain exchange, bitwise,
    in f32 and f64 for each mu in mus; returns the largest |difference|."""
    import dataclasses

    import torch
    from hpddm_tpu_torch.parallel import pexchange as pk
    from hpddm_tpu_torch.parallel.ops import exchange

    plan = dec.pexch if dec.pexch is not None else pk.build_plan(dec)
    plain_dec = dataclasses.replace(dec, pexch=None)
    worst = 0.0
    for mu in mus:
        x_np = rng.normal(size=(dec.S, dec.n_max, mu))
        for dt in (torch.float64, torch.float32):
            x = torch.as_tensor(x_np, device="cuda").to(dt)
            y = pk.pexchange(plan, x)
            ref = pk.pexchange_reference(plan, x)
            plain = exchange(plain_dec, x)
            torch.cuda.synchronize()
            err = max(float((y - ref).abs().max()),
                      float((y - plain).abs().max()))
            same = torch.equal(y, ref) and torch.equal(y, plain)
            print(f"  pexchange vs plain [{name}, S={dec.S}, n={dec.n_max}, "
                  f"m_max={dec.m_max}, k_max={dec.k_max}, mu={mu}, {dt}]: "
                  f"max|err| = {err:.3e}, bitwise equal: {same}")
            check(same, f"pexchange differs from plain: {name} mu={mu} {dt}")
            worst = max(worst, err)
    return worst


def phase_kernels_unstructured():
    import torch
    from hpddm_tpu_torch.core.formats import BatchedELL, pack_local_matrices
    from hpddm_tpu_torch.models import unstructured
    from hpddm_tpu_torch.parallel.decomposition import Decomposition

    print("phase 6: kernels vs plain, ELL SpMV (B4) and exchange (B5)")
    gen = unstructured.generate(8, 60, 60, overlap=2, with_neumann=False)
    rng = np.random.default_rng(4321)
    cases = [("test size", pack_local_matrices(gen.mats, device="cuda"))]
    for name, shape, pad in (("card", (64, 4640, 11, 132), False),
                             ("ragged n, all-padding row", (3, 1000, 7, 40),
                              True),
                             ("int32 columns", (1, 70000, 2, 40), False)):
        vals, cols = random_ell(rng, *shape, pad_row=pad)
        cases.append((name, BatchedELL.from_slot_major(
            torch.as_tensor(vals, device="cuda"),
            torch.as_tensor(cols, device="cuda"), shape[1])))
    worst = 0.0
    for name, A in cases:
        worst = max(worst, check_ell(name, A, (1, 3, 4), rng))
    dec = Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                        gen.n_loc, d=gen.d, device="cuda")
    return worst, check_pexchange("test size", dec, rng, mus=(1, 3, 4))


def build_unstructured(S, nx, nu, partition, device, dtype=np.float64,
                       timings=None, schwarz=None):
    """(generated problem, options, state, rhs) of the P1-FEM path: the
    mesh and its decomposition in f64, the operator in dtype. With
    ``schwarz`` a list, the Schwarz setup object is appended to it."""
    import torch
    from hpddm_tpu_torch.core.csr import MatrixCSR
    from hpddm_tpu_torch.models import unstructured
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz

    t = time.perf_counter()
    gen = unstructured.generate(S, nx, nx, overlap=2, with_neumann=True,
                                partition=partition)
    t_gen = time.perf_counter() - t
    mats, neumann = gen.mats, gen.neumann
    if dtype != np.float64:
        mats = [MatrixCSR(m.scipy().astype(dtype)) for m in mats]
        neumann = [MatrixCSR(m.scipy().astype(dtype)) for m in neumann]
    t = time.perf_counter()
    opt = Options(schwarz_coarse_correction="deflated", geneo_nu=nu)
    sch = Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d, options=opt,
                  device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    sch.solve_gevp(neumann)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    if timings is not None:
        timings.update(generate=t_gen, decomposition=t_dec, **sch.timings)
    if schwarz is not None:
        schwarz.append(sch)
    return gen, opt, state, torch.as_tensor(f, device=device)


def true_residual(gen, x):
    """Relative residual of x on the assembled global system, in f64."""
    xs = x.double().cpu().numpy()
    xg = np.zeros(gen.A_global.shape[0])
    for s in range(len(gen.n_loc)):
        xg[gen.gids[s]] = xs[s, : gen.n_loc[s], 0]
    fg = np.where(gen.boundary, 0.0, 1.0)
    r = gen.A_global.astype(np.float64) @ xg - fg
    return float(np.linalg.norm(r) / np.linalg.norm(fg))


def phase_unstructured_parity():
    import hashlib

    from hpddm_tpu_torch.solvers.krylov import solve

    print("phase 7: unstructured parity (60x60 Delaunay mesh, S=8, overlap "
          "2, k-way, nu=8, deflated)")
    its = {}
    for device in ("cuda", "cpu"):
        gen, opt, state, f = build_unstructured(8, 60, 8, "kway", device)
        if device == "cuda":
            print("  mesh: {} points, {} triangles, sha256 of the triangles "
                  "{}".format(len(gen.points), len(gen.triangles),
                              hashlib.sha256(gen.triangles.tobytes())
                              .hexdigest()[:16]))
        for tol, want in UNSTR_ITS.items():
            opt["tol"] = tol
            res = solve(state, f, opt=opt)
            rel = true_residual(gen, res.x)
            its[(device, tol)] = res.iterations
            print(f"  {device} f64 tol {tol:g}: {res.iterations} iterations "
                  f"(JAX CPU f64: {want}), true global rel. residual "
                  f"{rel:.3e}")
            check(bool(res.converged.all()), f"{device} tol {tol:g} did not "
                  "converge")
            if device == "cuda":
                check(res.iterations == want,
                      f"unstructured f64 at tol {tol:g}: {res.iterations} "
                      f"!= {want}")
                if tol == 1e-6:
                    check(rel <= 1e-6, f"true residual {rel:.3e} at 1e-6")
    for tol in UNSTR_ITS:
        check(its[("cuda", tol)] == its[("cpu", tol)],
              f"card and CPU iteration counts differ at tol {tol:g}")
    gen, opt, state, f = build_unstructured(8, 60, 8, "kway", "cuda",
                                            dtype=np.float32)
    opt["tol"] = 1e-6
    res = solve(state, f, opt=opt)
    rel = true_residual(gen, res.x)
    print(f"  cuda f32 tol 1e-06: {res.iterations} iterations, true global "
          f"rel. residual {rel:.3e}")
    check(res.iterations <= 60 and rel <= 1e-4, "f32 unstructured gates")


def phase_unstructured_card(grid_gmv_ms):
    import dataclasses

    import torch
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.examples.library_ops import ell_csr, exchange_csr
    from hpddm_tpu_torch.parallel import pexchange as pk
    from hpddm_tpu_torch.parallel.ops import exchange, scaled_exchange
    from hpddm_tpu_torch.precond.schwarz import gmv
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import cold_events_ms, events_ms, timed

    S, N = 64, 512
    print(f"phase 8: unstructured card scale ({N}x{N} mesh, S={S}, overlap "
          "2, geometric partition, nu=10, f64, tol 1e-6)")
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in (ek, pk):                     # the main path's counts from here
        mod.launches = 0
        mod.launches_by_mu.clear()
    plain[0] = 0
    timings = {}
    sch = []
    gen, opt, state, f = build_unstructured(S, N, 10, "geometric", "cuda",
                                            timings=timings, schwarz=sch)
    after_setup = (ek.launches, pk.launches)
    opt["tol"] = 1e-6
    best, solve_s, res = timed(lambda: solve(state, f, opt=opt), reps=3,
                               warmup=1)
    after_mu1 = (ek.launches, pk.launches)
    # then pseudo-block gmres over 4 consistent random right-hand sides
    dec = state.dec
    f4 = np.random.default_rng(8).uniform(0.0, 1.0, size=(S, dec.n_max, 4))
    f4[np.arange(dec.n_max)[None, :] >=
       dec.n_loc.cpu().numpy()[:, None]] = 0.0
    f4 = scaled_exchange(dec, torch.as_tensor(f4, device="cuda"))
    t4 = time.perf_counter()
    res4 = solve(state, f4, opt=opt)
    torch.cuda.synchronize()
    t4 = time.perf_counter() - t4
    launches = (ek.launches, pk.launches)    # read just after the main path
    by_mu = (dict(ek.launches_by_mu), dict(pk.launches_by_mu))
    plain_calls = plain[0]
    rel = checked_residual(state, f, res)
    rel4 = checked_residual_per_rhs(state, f4, res4)
    true_rel = true_residual(gen, res.x)
    peak = torch.cuda.max_memory_allocated()
    check(bool(res.converged.all()) and res.iterations < int(opt.val("max_it")),
          f"unstructured card scale did not converge in {res.iterations} "
          "iterations")
    check(rel <= 1e-5, f"recomputed rel. residual {rel:.3e}")
    check(true_rel <= 1e-5, f"true global rel. residual {true_rel:.3e}")
    check(bool(res4.converged.all()) and max(rel4) <= 1e-5,
          f"unstructured card scale at mu=4: iterations "
          f"{res4.it_per_rhs.tolist()}, residual {max(rel4):.3e}")
    n_c = state.coarse.N_c
    for name, before, mid, counts in zip(("ell_spmv", "pexchange"),
                                         after_setup, after_mu1, by_mu):
        check(before > 0 and mid > before and all(
                  counts.get(mu, 0) > 0 for mu in (1, 4, n_c)),
              f"{name} launches: setup {before}, after 4 solves {mid}, by "
              f"the panel width {counts}")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")
    print(f"  n_max {dec.n_max}, m_max {dec.m_max}, k_max {dec.k_max}, ELL "
          f"width {state.A.values.shape[1]}, coarse size "
          f"{state.coarse.N_c}")
    print("  setup seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in timings.items()))
    print(f"  solve: {res.iterations} iterations, recomputed rel. residual "
          f"{rel:.3e}, true global rel. residual {true_rel:.3e}, best of 3 "
          f"after a warm-up {best:.4f} s "
          f"({', '.join(f'{t:.4f}' for t in solve_s)})")
    print(f"  gmres at mu=4 (4 consistent random right-hand sides): "
          f"iterations per RHS {res4.it_per_rhs.tolist()}, recomputed rel. "
          f"residual per RHS {', '.join(f'{r:.3e}' for r in rel4)}, "
          f"{t4:.4f} s")
    print(f"  peak device memory {peak / 2**30:.2f} GiB "
          "(torch.cuda.max_memory_allocated)")
    for name, before, mid, after, counts in zip(
            ("ell_spmv", "pexchange"), after_setup, after_mu1, launches,
            by_mu):
        print(f"  {name} launches: {before} in setup, {(mid - before) / 4:g}"
              f" per solve at mu=1, {after - mid} in the mu=4 solve, {after} "
              f"in all; by the panel width {counts}")
    print(f"  plain-version calls on the card: {plain_calls}")

    # comparisons and timings: not counted as main-path launches. B4 and B5
    # at mu=1 (the solve), 4 and the coarse width n_c (the setup's panel),
    # each against its plain version and torch.sparse.mm on the matrix of
    # the same linear map
    A, plan = state.A, dec.pexch
    plain_dec = dataclasses.replace(dec, pexch=None)
    n = dec.n_max
    w = A.values.shape[1]
    E4 = ell_csr(A.values, A.cols)
    E5 = exchange_csr(plan, A.values.dtype)
    # the bounds: B4 the matrix's nonzeros (value and column once each, the
    # column at the width the payload stores), B5 the plan's maps (a byte
    # per dof, a 4-byte row per interface slot and per valid partner), x
    # read and y written; a product and a sum per nonzero, a sum per
    # partner. The padded ELL arrays the kernel reads are printed beside
    nnz = int(torch.count_nonzero(A.values))
    maps5 = plan.interior.numel() + 4 * int((plan.dst >= 0).sum()) + \
        4 * int((plan.rows >= 0).sum())
    padded = A.values.numel() * 8 + A.payload.cols.numel() * \
        A.payload.cols.element_size()
    rng = np.random.default_rng(98)
    recs = []
    for mu in (1, 4, n_c):
        x = (dec.d[:, :, None] * torch.ones_like(f)).contiguous() if mu == 1 \
            else torch.as_tensor(rng.normal(size=(S, n, mu)), device="cuda")
        xs = x.reshape(-1, mu)
        reps = 30 if mu <= 4 else 10
        y4 = ek.ell_spmv(A.values, A.cols, x, A.payload)
        err4 = float((y4 - ek.ell_spmv_payload_reference(
            A.values, A.payload, x)).abs().max())
        check(torch.equal(y4, ek.ell_spmv_payload_reference(
            A.values, A.payload, x)) and torch.equal(
                y4, ek.ell_spmv_reference(A.values, A.cols, x)),
            f"ell_spmv differs from plain on the card operator at mu={mu}")
        y5 = pk.pexchange(plan, x)
        err5 = float((y5 - pk.pexchange_reference(plan, x)).abs().max())
        check(torch.equal(y5, pk.pexchange_reference(plan, x)) and
              torch.equal(y5, exchange(plain_dec, x)),
              f"pexchange differs from plain on the card plan at mu={mu}")
        l5_err = float((torch.sparse.mm(E5, xs).reshape(x.shape) - y5)
                       .abs().max())
        del y4, y5
        k4 = cold_events_ms(lambda: ek.ell_spmv(A.values, A.cols, x,
                                                A.payload), reps)
        p4 = cold_events_ms(lambda: ek.ell_spmv_payload_reference(
            A.values, A.payload, x), reps)
        l4 = library_ms(E4, xs)
        k5 = cold_events_ms(lambda: pk.pexchange(plan, x), reps)
        p5 = cold_events_ms(lambda: pk.pexchange_reference(plan, x), reps)
        g5 = cold_events_ms(lambda: exchange(plain_dec, x), reps)
        l5 = library_ms(E5, xs)
        b4_ms, b4_by = bound(
            nnz * (x.element_size() + A.payload.cols.element_size()) +
            2 * x.numel() * x.element_size(), 2 * nnz * mu, x.dtype)
        b5_ms, b5_by = bound(maps5 + 2 * x.numel() * x.element_size(),
                             int((plan.rows >= 0).sum()) * mu, x.dtype)
        warm = ""
        if mu == 1:
            warm = (f"; back to back: kernel "
                    f"{events_ms(lambda: ek.ell_spmv(A.values, A.cols, x, A.payload), 200) * 1e3:.2f}"
                    f" / {events_ms(lambda: pk.pexchange(plan, x), 200) * 1e3:.2f}"
                    " us (B4 / B5)")

        def txt(ms):
            return "not timed" if ms is None else f"{ms * 1e3:.2f} us"
        print(f"  ell_spmv (B4) at (S={S}, w={w}, n={n}) f64, mu={mu}: kernel "
              f"{k4 * 1e3:.2f} us, plain {p4 * 1e3:.2f} us, torch.sparse.mm "
              f"{txt(l4)} (L2 flushed by a write); bound {b4_ms * 1e3:.2f} "
              f"us ({b4_by}; {nnz} nonzeros) = {100 * b4_ms / k4:.1f}% of "
              f"the kernel's time; kernel / library "
              f"{'-' if l4 is None else f'{k4 / l4:.3f}'}; the padded "
              f"arrays ({padded / 1e6:.2f} MB of values and "
              f"{A.payload.cols.dtype} columns) read at "
              f"{(padded + 2 * x.numel() * 8) / (k4 * 1e-3) / 1e9:.0f} GB/s "
              f"with x and y; bitwise equal to plain (and to the full slot "
              f"sum), max|kernel - plain| {err4:.3e}")
        print(f"  pexchange (B5) at (S={S}, n={n}, m_max={dec.m_max}, "
              f"k_max={dec.k_max}) f64, mu={mu}: kernel {k5 * 1e3:.2f} us, "
              f"plain version {p5 * 1e3:.2f} us, the port's plain exchange "
              f"{g5 * 1e3:.2f} us, torch.sparse.mm on I + P ({E5._nnz()} "
              f"nonzeros) {txt(l5)} (L2 flushed by a write); bound "
              f"{b5_ms * 1e3:.2f} us ({b5_by}) = {100 * b5_ms / k5:.1f}% of "
              f"the kernel's time; kernel / library "
              f"{'-' if l5 is None else f'{k5 / l5:.3f}'}; bitwise equal to "
              f"plain, max|kernel - plain| {err5:.3e}, max|(I + P) x - "
              f"kernel| {l5_err:.3e} (the library sums in its own order)"
              + warm)
        # launches: the kernel's in all on the main path, and at mu=4 and
        # the coarse width n_c those at that panel width
        counts = launches if mu == 1 else (by_mu[0][mu], by_mu[1][mu])
        tag = "" if mu == 1 else f" mu={mu}"
        recs += [kernel_record(
                     "ell_spmv" + tag, "hpddm_tpu_torch/csrc/ell_spmv.cu",
                     "hpddm_tpu/ops/pallas_ell.py:133", counts[0], err4, k4,
                     p4, b4_ms, b4_by, l4),
                 kernel_record(
                     "pexchange" + tag, "hpddm_tpu_torch/csrc/pexchange.cu",
                     "hpddm_tpu/parallel/pexchange.py:149", counts[1], err5,
                     k5, p5, b5_ms, b5_by, l5)]
        del x, xs
    del E4, E5
    # f32 and the remaining widths, bitwise
    b4_err = check_ell("card operator", A, (3, n_c),
                       np.random.default_rng(97))
    b5_err = check_pexchange("card", dec, np.random.default_rng(99),
                             mus=(1, 3, n_c))
    for rec in recs:
        rec["max_abs_err"] = max(rec["max_abs_err"], b4_err if
                                 rec["name"].startswith("ell") else b5_err)
    x1 = (dec.d[:, :, None] * torch.ones_like(f)).contiguous()
    g_ms1 = events_ms(lambda: gmv(state, x1), 50)
    print(f"  gmv: {g_ms1 * 1e3:.2f} us (best of 5 x 50); grid gmv at the "
          f"same 262,144 dofs (phase 5) {grid_gmv_ms * 1e3:.2f} us; "
          f"unstructured / grid = {g_ms1 / grid_gmv_ms:.2f}")
    # what phase 13 builds on: the problem, the setup with its dense-GenEO
    # vectors, the inv state and the reference's numbers
    cell = dict(gen=gen, sch=sch[0], state=state, f=f, its=res.iterations,
                solve_s=best, geneo_s=timings["geneo"], peak=peak)
    return recs, cell


def phase_kernels_spmm():
    """Phase 9: B2 (dia_spmm, x of shape (S, n, mu)) and B3 (dia_spmm_muT,
    (S, mu, n)) against the plain version on the card, bitwise; returns the
    largest |difference|."""
    import torch
    from hpddm_tpu_torch.ops import dia_spmv as kmod

    print("phase 9: kernel vs plain, DIA SpMM (B2 and B3 layouts)")
    rng = np.random.default_rng(5678)
    worst = 0.0
    for name, S, n, offs in DIA_CASES:
        vals_np = rng.normal(size=(S, len(offs), n))
        mus = [mu for mu in SPMM_MUS if mu != 640 or name == "card"]
        x_np = {mu: rng.normal(size=(S, n, mu)) for mu in mus}
        for dt in (torch.float64, torch.float32):
            vals = torch.as_tensor(vals_np, device="cuda").to(dt)
            errs = []
            for mu in mus:
                x = torch.as_tensor(x_np[mu], device="cuda").to(dt)
                xT = x.transpose(1, 2).contiguous()
                y = kmod.dia_spmm(vals, x, offs)
                yT = kmod.dia_spmm_muT(vals, xT, offs)
                ref = kmod.dia_spmv_reference(vals, x, offs)
                torch.cuda.synchronize()
                errs.append(max(float((y - ref).abs().max()),
                                float((yT - ref.transpose(1, 2)).abs().max())))
                same = torch.equal(y, ref) and \
                    torch.equal(yT, ref.transpose(1, 2))
                check(same, f"dia_spmm / dia_spmm_muT differ from plain: "
                      f"{name} mu={mu} {dt}")
                del y, yT, ref, x, xT
            print(f"  dia_spmm / dia_spmm_muT vs plain [{name}, S={S}, n={n}, "
                  f"offsets={offs}, {dt}], mu {', '.join(map(str, mus))}: "
                  f"bitwise equal, max|err| = {max(errs):.3e}")
            worst = max(worst, max(errs))
    return worst


def multi_case(name, state, rhs, opts, want):
    """Run one MULTI_ITS sequence on the card: its counts must equal the
    JAX package's per right-hand side (one iteration of slack for
    MULTI_SLACK methods, printed when used)."""
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.krylov import solve

    method = opts.get("krylov_method", "gmres")
    slack = 1 if method in MULTI_SLACK else 0
    opt = Options(tol=1e-6, **opts)
    t = time.perf_counter()
    for k, want_k in enumerate(want):
        res = solve(state, rhs, opt=opt)
        rel = checked_residual_per_rhs(state, rhs, res)
        its = res.it_per_rhs.tolist()
        limit = MULTI_RES.get(name, 1e-5)
        print(f"  {name}, solve {k + 1}: iterations per RHS {its} (JAX CPU "
              f"f64: {want_k}), recomputed rel. residual per RHS "
              f"{', '.join(f'{r:.3e}' for r in rel)} (limit {limit:.3e})")
        diff = max(abs(a - b) for a, b in zip(its, want_k))
        check(diff <= slack, f"{name} solve {k + 1}: {its} != {want_k}")
        if diff:
            print(f"    differs by {diff} from the JAX package's count "
                  "(allowed for this method)")
        check(max(rel) <= limit * (1.1 if name in MULTI_RES else 1.0),
              f"{name} solve {k + 1}: residual {max(rel):.3e}")
    print(f"    ({time.perf_counter() - t:.2f} s)")


def checked_residual_per_rhs(state, f, res):
    """Recomputed relative residual of every right-hand side of a solve,
    after checking that the solution is finite and of f's shape."""
    import torch
    from hpddm_tpu_torch.precond.schwarz import compute_residual

    check(tuple(res.x.shape) == tuple(f.shape),
          f"x shape {tuple(res.x.shape)}")
    check(bool(torch.isfinite(res.x).all()), "non-finite solution")
    nb, nr = compute_residual(state, res.x, f)
    return (nr / nb).tolist()


def phase_multi_parity():
    """Phase 10: every MULTI_ITS sequence at the oracle on the card in f64,
    then f32 gmres and bgmres at mu=4."""
    import torch
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.krylov import solve

    print("phase 10: multi-RHS and block Krylov parity (100x100, S=4, nu=10, "
          "deflated, f64, tol 1e-6)")
    sch = []
    _, state4, f4 = build_problem(4, 100, 10, np.float64, "cuda", mu=4,
                                  schwarz=sch)
    gen = diffusion2d.generate(4, 100, 100, overlap=1)
    f1 = torch.zeros_like(f4[:, :, :1])
    for s, fs in enumerate(gen.f):
        f1[s, : gen.n_loc[s]] = torch.as_tensor(fs, device="cuda")
    rhs = {"f4": f4, "f1": f1}
    for name, (which, opts, setup, want) in MULTI_ITS.items():
        state = state4
        if setup:
            for k, v in setup.items():
                sch[0].opt[k] = v
            state = sch[0].build()
            for k in setup:
                sch[0].opt.remove(k)
        multi_case(name, state, rhs[which], opts, want)
    # f32: pseudo-block gmres is held to the oracle's gates (<= 45
    # iterations, residual <= 1e-2); bgmres's regularized normal equations
    # (10 eps trace(G)) cannot resolve tol 1e-6 in f32, and the JAX package
    # itself runs to max_it there (100 iterations, residual 6.5e-3 on the
    # CPU), so bgmres is held to the residual gate only
    _, state, f = build_problem(4, 100, 10, np.float32, "cuda", mu=4)
    for method in ("gmres", "bgmres"):
        res = solve(state, f, opt=Options(tol=1e-6, krylov_method=method))
        rel = checked_residual(state, f, res)
        print(f"  f32 {method} mu=4 tol 1e-06: {res.it_per_rhs.tolist()} "
              f"iterations per RHS, recomputed rel. residual {rel:.3e}")
        check(rel <= 1e-2 and (method == "bgmres" or res.iterations <= 45),
              f"f32 {method} gates")


_PLAIN_CALLS = []


def count_plain_calls():
    """Wrap the kernels' plain versions where the port reaches them (once),
    counting the calls on CUDA tensors: a run through the kernels makes
    none. Returns the counter (a one-element list)."""
    import torch
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.ops import spmv
    from hpddm_tpu_torch.parallel import pexchange as pk

    if _PLAIN_CALLS:
        return _PLAIN_CALLS
    _PLAIN_CALLS.append(0)

    def counted(plain):
        def call(*args):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                _PLAIN_CALLS[0] += 1
            return plain(*args)
        return call

    for mods, name in (((kmod, spmv), "dia_spmv_reference"),
                       ((kmod, spmv), "dia_spmm_muT_reference"),
                       ((spmv,), "spmm_dia_canvas"),
                       ((spmv,), "spmm_dia_canvas_muT"),
                       ((ek, spmv), "ell_spmv_reference"),
                       ((ek,), "ell_spmv_payload_reference"),
                       ((pk,), "pexchange_reference")):
        wrapped = counted(getattr(mods[0], name))
        for mod in mods:
            setattr(mod, name, wrapped)
    return _PLAIN_CALLS


def phase_multi_card(card):
    """Phase 11: slice 4's main path at card scale on phase 5's state
    (512x512, S=64, nu=10, f64, tol 1e-6): pseudo-block gmres and bgmres
    over 4 consistent random right-hand sides, a recycled gcrodr sequence
    at mu=1, then B2's times at mu=4 and at the coarse panel and one gmv at
    mu=4. Returns the B2/B3 kernel record."""
    import torch
    from hpddm_tpu_torch.examples.library_ops import dia_csr
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.parallel.ops import scaled_exchange
    from hpddm_tpu_torch.precond.schwarz import gmv
    from hpddm_tpu_torch.solvers.block import _block_ls, _chol_qr
    from hpddm_tpu_torch.solvers.krylov import make_operator, solve
    from hpddm_tpu_torch.timing import cold_events_ms, events_ms, timed

    # phase 5's state, solve time and coarse-panel launches in setup
    _, state, single_best, panel_launches = card
    dec = state.dec
    S, n = dec.S, dec.n_max
    print(f"phase 11: multi-RHS card scale (512x512, S={S}, nu=10, f64, "
          "tol 1e-6, mu=4)")
    rng = np.random.default_rng(11)
    f = rng.uniform(0.0, 1.0, size=(S, n, 4))
    f[np.arange(n)[None, :] >= dec.n_loc.cpu().numpy()[:, None]] = 0.0
    f = scaled_exchange(dec, torch.as_tensor(f, device="cuda"))
    f1 = f[:, :, :1].contiguous()
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kmod.launches = kmod.spmm_launches = 0   # the main path's counts from here
    plain[0] = 0
    out = {}
    for method in ("gmres", "bgmres"):
        opt = Options(tol=1e-6, krylov_method=method)
        best, times, res = timed(lambda: solve(state, f, opt=opt), reps=3,
                                 warmup=1)
        out[method] = (best, times, res)
    seq = []
    opt = Options(tol=1e-6, krylov_method="gcrodr", recycle=20)
    for _ in range(2):
        t = time.perf_counter()
        res = solve(state, f1, opt=opt)
        torch.cuda.synchronize()
        seq.append((res, time.perf_counter() - t))
    launches = (kmod.launches, kmod.spmm_launches)   # just after the path
    plain_calls = plain[0]
    peak = torch.cuda.max_memory_allocated()
    for method, (best, times, res) in out.items():
        rel = checked_residual_per_rhs(state, f, res)
        print(f"  {method}: iterations per RHS {res.it_per_rhs.tolist()}, "
              f"recomputed rel. residual per RHS "
              f"{', '.join(f'{r:.3e}' for r in rel)}, best of 3 after a "
              f"warm-up {best:.4f} s ({', '.join(f'{t:.4f}' for t in times)})"
              f", {best / res.iterations * 1e3:.2f} ms per iteration, "
              f"{best / 4:.4f} s per RHS against phase 5's single-RHS solve "
              f"{single_best:.4f} s (4 x = {4 * single_best:.4f} s)")
        check(bool(res.converged.all()) and max(rel) <= 1e-5,
              f"{method} at card scale: residual {max(rel):.3e}")
    for k, (res, sec) in enumerate(seq):
        rel = checked_residual_per_rhs(state, f1, res)
        print(f"  gcrodr recycle 20, mu=1, solve {k + 1}: {res.iterations} "
              f"iterations, recomputed rel. residual {rel[0]:.3e}, "
              f"{sec:.4f} s")
        check(rel[0] <= 1e-5, f"gcrodr solve {k + 1}: residual {rel[0]:.3e}")
    print(f"  peak device memory {peak / 2**30:.2f} GiB; launches on this "
          f"path: dia_spmm {launches[1]}, dia_spmv {launches[0]}; "
          f"plain-version calls on the card {plain_calls}")
    check(launches[1] > 0, "no dia_spmm launch on the multi-RHS path")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")

    # B2 and B3 timings and checks: not counted as main-path launches. The
    # library call is torch.sparse.mm on the (S n, mu) panel: the same map
    # as both layouts' kernels
    vals, offs = state.A.values, state.A.offsets
    csr = dia_csr(vals, offs)
    nnz = int(torch.count_nonzero(vals))
    recs = []
    for mu in (4, state.coarse.N_c):
        x = torch.as_tensor(rng.normal(size=(S, n, mu)), device="cuda")
        xT = x.transpose(1, 2).contiguous()
        ref = kmod.dia_spmv_reference(vals, x, offs)
        y = kmod.dia_spmm(vals, x, offs)
        yT = kmod.dia_spmm_muT(vals, xT, offs)
        err = max(float((y - ref).abs().max()),
                  float((yT - ref.transpose(1, 2)).abs().max()))
        check(torch.equal(y, ref) and torch.equal(yT, ref.transpose(1, 2)),
              f"dia_spmm / dia_spmm_muT differ from plain at mu={mu}")
        del y, yT, ref
        reps = 10 if mu > 4 else 30
        k_ms = cold_events_ms(lambda: kmod.dia_spmm(vals, x, offs))
        t_ms = cold_events_ms(lambda: kmod.dia_spmm_muT(vals, xT, offs))
        p_ms = cold_events_ms(lambda: kmod.dia_spmv_reference(vals, x, offs),
                              reps=reps)
        pT_ms = cold_events_ms(
            lambda: kmod.dia_spmm_muT_reference(vals, xT, offs), reps=reps)
        k_warm = events_ms(lambda: kmod.dia_spmm(vals, x, offs), 20)
        t_warm = events_ms(lambda: kmod.dia_spmm_muT(vals, xT, offs), 20)
        lib_ms = library_ms(csr, x.reshape(-1, mu))
        nbytes = vals.numel() * 8 + 2 * x.numel() * 8
        b_ms, b_by = bound(nbytes, 2 * nnz * mu, vals.dtype)
        lib_txt = "not timed" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
        print(f"  dia_spmm (B2) / dia_spmm_muT (B3) at (S={S}, nd={len(offs)}, "
              f"n={n}) f64, mu={mu}: kernel {k_ms * 1e3:.2f} / "
              f"{t_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} / "
              f"{pT_ms * 1e3:.2f} us, torch.sparse.mm {lib_txt}, all with L2 "
              f"flushed; kernel {k_warm * 1e3:.2f} / {t_warm * 1e3:.2f} us "
              f"back to back; bound {b_ms * 1e3:.2f} us ({b_by}; "
              f"{nbytes / 1e6:.2f} MB) = {100 * b_ms / k_ms:.1f}% / "
              f"{100 * b_ms / t_ms:.1f}% of the kernels' cold times, "
              f"{nbytes / (k_ms * 1e-3) / 1e9:.0f} / "
              f"{nbytes / (t_ms * 1e-3) / 1e9:.0f} GB/s; kernel / library "
              f"{'-' if lib_ms is None else f'{k_ms / lib_ms:.3f}'} / "
              f"{'-' if lib_ms is None else f'{t_ms / lib_ms:.3f}'}; bitwise "
              f"equal to plain, max|kernel - plain| {err:.3e}")
        src = "hpddm_tpu_torch/csrc/dia_spmv.cu"
        if mu == 4:                # the multi-RHS path's launches
            recs.append(kernel_record(
                "dia_spmm", src, "hpddm_tpu/ops/pallas_spmv.py:167",
                launches[1], err, k_ms, p_ms, b_ms, b_by, lib_ms))
        else:                      # the coarse panel: one launch in setup;
            recs.append(kernel_record(   # no solver path calls B3
                f"dia_spmm mu={mu}", src, "hpddm_tpu/ops/pallas_spmv.py:167",
                panel_launches, err, k_ms, p_ms, b_ms, b_by, lib_ms))
            recs.append(kernel_record(
                f"dia_spmm_muT mu={mu}", src,
                "hpddm_tpu/ops/pallas_spmv.py:253", 0, err, t_ms, pT_ms,
                b_ms, b_by, lib_ms))
        del x, xT
    x4 = (dec.d[:, :, None] * torch.ones_like(f)).contiguous()
    g4 = events_ms(lambda: gmv(state, x4), 50)
    print(f"  gmv at mu=4: {g4 * 1e3:.2f} us (best of 5 x 50)")
    # bgmres's per-iteration small algebra: the block least squares (eigh
    # of the (restart mu)^2 Gram) and the CholQR of the new block
    m = int(Options().val("gmres_restart"))
    H = torch.as_tensor(rng.normal(size=(m + 1, m, 4, 4)), device="cuda")
    R0 = torch.as_tensor(rng.normal(size=(4, 4)), device="cuda")
    ls_ms = events_ms(lambda: _block_ls(H, R0, m), 5)
    qr_ms = events_ms(lambda: _chol_qr(make_operator(state), x4), 5)
    print(f"  bgmres's block least squares ({m * 4}x{m * 4} eigh) "
          f"{ls_ms * 1e3:.1f} us and CholQR of one block {qr_ms * 1e3:.1f} us "
          "per call (best of 5 x 5)")
    return recs


def device_busy_ms(fn, cpu_ops=True, warmup=True):
    """(wall ms, device-busy ms) of one call of ``fn()`` under
    torch.profiler: the kernels' and copies' device time against the
    synchronized wall time of the call (the profiler's own overhead is
    in the wall time). Device busy is None where the profiler records no
    device time. ``cpu_ops=False`` records the device activity only (a
    call of tens of thousands of launches, where the host operators'
    events would cost the profiler's post-processing many seconds);
    ``warmup=False`` leaves out the call before the profiled one (for a
    path that has just run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if cpu_ops:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall * 1e3, (busy * 1e-3 if busy > 0 else None)


def local_solve_times(name, solver, dec, rng, mus=(1, 4)):
    """{mu: (cold ms, back-to-back ms)} of one local solve of ``solver``
    on a random consistent panel, printed with ``name``."""
    import torch
    from hpddm_tpu_torch.timing import cold_events_ms, events_ms

    out = {}
    for mu in mus:
        x = torch.as_tensor(rng.normal(size=(dec.S, dec.n_max, mu)),
                            device="cuda") * dec.d[:, :, None]
        out[mu] = (cold_events_ms(lambda: solver.solve(x), reps=10),
                   events_ms(lambda: solver.solve(x), reps=5, blocks=3))
        print(f"  one local solve, {name}, mu={mu}: {out[mu][0]:.3f} ms "
              f"with the L2 flushed, {out[mu][1]:.3f} ms back to back")
    return out


def factor_txt(solver):
    """The banded solver's memory: the inverse factors, and everything it
    keeps for a solve (the coupling blocks and their products too)."""
    d = solver.Dinv
    return (f"Dinv {tuple(d.shape)} {d.numel() * d.element_size() / 1e6:.2f}"
            f" MB, {solver.nbytes / 1e6:.2f} MB in all")


def banded_record(rec, name, launches):
    """A copy of a kernel's record (times, errors and bound from this run)
    with the launches of a banded path."""
    out = dict(rec)
    out.update(name=name, launches=launches)
    return out


def phase_banded_grid(dia_rec):
    """Phase 12: banded local solves and Lanczos GenEO at the grid card
    cell (generate_uniform 512x512, S=64, overlap 1: n_max 4356, 66x66
    boxes, f64): (a) the main path, banded + Lanczos; (b) dense GenEO once,
    inv and banded states on its vectors (equal counts); (c) local solve
    times, banded_block_rows 1, 2, 4 and the host / device factor; (d) the
    f32 device factor. Returns the B1 record of the path."""
    import torch
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.ops.banded_solve import build_banded_solver
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import cold_events_ms, timed

    S, N = 64, 512
    print(f"phase 12: banded grid card cell (generate_uniform {N}x{N}, "
          f"S={S}, overlap 1, nu=10, f64, tol 1e-6)")
    t = time.perf_counter()
    gen = diffusion2d.generate_uniform(S, N, N, overlap=1, with_neumann=True)
    n_max = max(gen.n_loc)
    f_np = np.zeros((S, n_max, 1))
    for s in range(S):
        f_np[s, : gen.n_loc[s]] = gen.f[s]
    print(f"  generate_uniform {time.perf_counter() - t:.3f} s; n_max "
          f"{n_max}, boxes {gen.boxes[0][1] - gen.boxes[0][0]}x"
          f"{gen.boxes[0][3] - gen.boxes[0][2]}")

    def setup(kind, **extra):
        opt = Options(schwarz_coarse_correction="deflated", geneo_nu=10,
                      local_solver=kind, tol=1e-6, **extra)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt, device="cuda")
        sch.set_grid_geometry(gen.boxes, N, N)
        return opt, sch

    # (a) the main path: banded + Lanczos GenEO ("auto"), counts from here
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kmod.launches = kmod.spmm_launches = 0
    plain[0] = 0
    opt, sch = setup("banded")
    f = torch.as_tensor(f_np, device="cuda")
    sch.solve_gevp(gen.neumann)
    b1_geneo = kmod.launches
    state = sch.build()
    b1_setup = kmod.launches
    best, times, res = timed(lambda: solve(state, f, opt=opt), reps=3,
                             warmup=1)
    b1_all, b2_all, plain_calls = kmod.launches, kmod.spmm_launches, plain[0]
    peak = torch.cuda.max_memory_allocated()
    rel = checked_residual(state, f, res)
    its_a = res.iterations
    b1_solve = (b1_all - b1_setup) / 4
    check(bool(res.converged.all()) and rel <= 1e-5,
          f"banded + Lanczos: {its_a} iterations, residual {rel:.3e}")
    check(its_a == BANDED_GRID_ITS,
          f"banded + Lanczos: {its_a} != {BANDED_GRID_ITS} (JAX CPU f64)")
    check(b1_geneo > 0 and b1_solve > 0,
          f"dia_spmv launches: {b1_geneo} in GenEO, {b1_solve} per solve")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")
    tm = dict(sch.timings)
    print(f"  (a) banded + Lanczos GenEO: {its_a} iterations (JAX CPU f64: "
          f"{BANDED_GRID_ITS}), recomputed "
          f"rel. residual {rel:.3e}; solve best of 3 after a warm-up "
          f"{best:.4f} s ({', '.join(f'{x:.4f}' for x in times)}), "
          f"{best / its_a * 1e3:.3f} ms per iteration")
    print("  setup seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in tm.items())
          + " (factorize = the banded factor, host f64; neumann_factor = "
          "the host banded factor of the regularized Neumann matrices)")
    print(f"  factor: {factor_txt(state.solver)}; peak device memory "
          f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above "
          f"the {held / 2**30:.2f} GiB held by earlier phases")
    print(f"  dia_spmv launches: {b1_geneo} in GenEO (Lanczos apply_B and "
          f"the Neumann product), {b1_setup - b1_geneo} in build, "
          f"{b1_solve:g} per solve, {b1_all} in all; dia_spmm {b2_all} (the "
          f"coarse panel); plain-version calls on the card {plain_calls}")

    # Lanczos at BANDED_NCV steps: the vectors of the dense pencil
    sch.opt["lanczos_ncv"] = BANDED_NCV
    sch.solve_gevp(gen.neumann)
    t_ncv = sch.timings["geneo"]
    res = solve(sch.build(), f, opt=opt)
    its_ncv = res.iterations
    sch.opt.remove("lanczos_ncv")
    print(f"  Lanczos at ncv {BANDED_NCV}: GenEO {t_ncv:.3f} s, "
          f"{its_ncv} iterations")

    # (b) dense GenEO once; inv and banded on its vectors: equal counts
    opt_d, sch_d = setup("inv")
    t = time.perf_counter()
    sch_d.solve_gevp(gen.neumann, method="dense")
    t_dense = time.perf_counter() - t
    vecs = sch_d._deflation_vectors
    st_inv = sch_d.build()
    sch.set_vectors(vecs)
    st_band = sch.build()
    its = {}
    for name, st in (("inv", st_inv), ("banded", st_band)):
        b, ts, r = timed(lambda: solve(st, f, opt=opt), reps=3, warmup=1)
        rel = checked_residual(st, f, r)
        its[name] = r.iterations
        print(f"  (b) {name} on the dense-GenEO vectors: {r.iterations} "
              f"iterations, recomputed rel. residual {rel:.3e}, best of 3 "
              f"{b:.4f} s, {b / r.iterations * 1e3:.3f} ms per iteration")
        check(rel <= 1e-5, f"{name} residual {rel:.3e}")
    print(f"  dense GenEO {t_dense:.3f} s against Lanczos "
          f"{tm['geneo']:.3f} s (ncv {2 * 10 + 1}) and {t_ncv:.3f} s (ncv "
          f"{BANDED_NCV}); Lanczos counts {its_a} and {its_ncv} against the "
          f"dense vectors' {its['inv']}")
    check(its["banded"] == its["inv"],
          f"banded {its['banded']} != inv {its['inv']} on the same vectors")
    check(abs(its_ncv - its["inv"]) <= 2,
          f"Lanczos count at ncv {BANDED_NCV} {its_ncv} not within 2 of "
          f"{its['inv']}")
    dec = state.dec
    rng = np.random.default_rng(12)
    x4 = torch.as_tensor(rng.normal(size=(S, n_max, 4)), device="cuda")
    ya, yb = st_band.solver.solve(x4), st_inv.solver.solve(x4)
    err = float(torch.linalg.norm(ya - yb) / torch.linalg.norm(yb))
    print(f"  banded solve against the inverse's bmm on a random (S, n, 4) "
          f"panel: relative difference {err:.3e}")
    check(err <= 1e-10, f"banded and inv solves differ by {err:.3e}")

    # (c) times: one local solve, banded_block_rows 1/2/4, host/device
    band_t = local_solve_times("banded", st_band.solver, dec, rng)
    inv_t = local_solve_times("inv bmm", st_inv.solver, dec, rng)
    x1 = (dec.d[:, :, None] * torch.ones_like(f)).contiguous()
    wall, busy = device_busy_ms(lambda: st_band.solver.solve(x1))
    print(f"  one banded solve at mu=1 under torch.profiler: wall "
          f"{wall:.3f} ms, device busy "
          + ("not recorded" if busy is None else
             f"{busy:.3f} ms ({100 * busy / wall:.1f}%)")
          + f"; banded / inv bmm {band_t[1][0] / inv_t[1][0]:.3f} (mu=1, "
          f"L2 flushed), {band_t[4][0] / inv_t[4][0]:.3f} (mu=4)")
    del st_inv, yb
    counts = {}
    for r in (1, 2, 4):
        sch.opt["banded_block_rows"] = r
        st = st_band if r == 1 else sch.build()
        res_r = solve(st, f, opt=opt)
        counts[r] = res_r.iterations
        ms = cold_events_ms(lambda: st.solver.solve(x1), reps=10)
        print(f"  banded_block_rows {r}: factor {factor_txt(st.solver)}, "
              f"one solve at mu=1 "
              f"{ms:.3f} ms (L2 flushed), {res_r.iterations} iterations")
        del st
    sch.opt["banded_block_rows"] = 1
    check(len(set(counts.values())) == 1,
          f"banded_block_rows 1/2/4 counts differ: {counts}")
    facs = {}
    for method in ("host", "device"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        facs[method] = build_banded_solver(
            gen.mats, gen.boxes, n_max, dtype=torch.float64, method=method,
            device="cuda")
        torch.cuda.synchronize()
        facs[method + " s"] = time.perf_counter() - t
    xh, xd = facs["host"].solve(x4), facs["device"].solve(x4)
    agree = float((xd - xh).abs().max() / xh.abs().max())
    print(f"  f64 factor: host {facs['host s']:.3f} s, device "
          f"{facs['device s']:.3f} s; solves agree to {agree:.3e}")
    check(agree <= 1e-12, f"host and device factors differ by {agree:.3e}")
    del facs, xh, xd

    # (d) f32: the auto (device) factor solves every local system < 5e-4
    f32 = build_banded_solver(gen.mats, gen.boxes, n_max,
                              dtype=torch.float32, device="cuda")
    b32 = np.zeros((S, n_max, 1), dtype=np.float32)
    for s in range(S):
        b32[s, : gen.n_loc[s], 0] = rng.normal(size=gen.n_loc[s])
    x32 = f32.solve(torch.as_tensor(b32, device="cuda")).double().cpu()
    worst = 0.0
    for s in range(S):
        K = gen.mats[s].scipy(expand=True)
        n = gen.n_loc[s]
        bs_ = b32[s, :n, 0].astype(np.float64)
        worst = max(worst, float(np.linalg.norm(K @ x32[s, :n, 0].numpy()
                                                - bs_) / np.linalg.norm(bs_)))
    print(f"  f32 auto (device) factor: largest local relative residual "
          f"{worst:.3e} (limit 5e-4)")
    check(worst < 5e-4, f"f32 device factor residual {worst:.3e}")
    return [banded_record(dia_rec, "dia_spmv banded grid path", b1_all)]


def phase_banded_unstructured(cell, unstr_recs):
    """Phase 13: the unstructured card cell (phase 8's 512x512 mesh,
    S=64, overlap 2, geometric partition, nu=10, f64) through RCM: (a) a
    banded state on phase 8's dense-GenEO vectors, (b) banded + Lanczos
    GenEO. Returns the B4 and B5 records of the path."""
    import torch
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.parallel import pexchange as pk
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import timed

    gen, sch, f = cell["gen"], cell["sch"], cell["f"]
    want = cell["its"]
    dec = sch.dec
    print(f"phase 13: unstructured card cell through RCM (512x512 mesh, "
          f"S={dec.S}, overlap 2, geometric partition, nu=10, f64, tol 1e-6)")
    rng = np.random.default_rng(13)
    inv_t = local_solve_times("inv bmm", cell.pop("state").solver, dec, rng)
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for mod in (ek, pk):                     # the path's counts from here
        mod.launches = 0
        mod.launches_by_mu.clear()
    plain[0] = 0
    opt = sch.opt
    opt["local_solver"] = "banded"
    opt["tol"] = 1e-6
    cell["dense_vecs"] = list(sch._deflation_vectors)   # for phase 22 (a)
    # (a) banded on phase 8's dense-GenEO vectors
    state = sch.build()
    t_fac = sch.timings["factorize"]
    best_a, times_a, res = timed(lambda: solve(state, f, opt=opt), reps=3,
                                 warmup=1)
    true_a = true_residual(gen, res.x)
    its_a = res.iterations
    solver = state.solver
    band_t = local_solve_times("banded (RCM)", solver, dec, rng)
    nbk, fac = solver.wy_max, factor_txt(solver)
    del state, solver
    # (b) banded + Lanczos GenEO ("auto")
    sch.solve_gevp(gen.neumann)
    state = sch.build()
    best_b, times_b, res_b = timed(lambda: solve(state, f, opt=opt), reps=3,
                                   warmup=1)
    launches = (ek.launches, pk.launches)   # read just after the path
    by_mu = (dict(ek.launches_by_mu), dict(pk.launches_by_mu))
    plain_calls = plain[0]
    peak = torch.cuda.max_memory_allocated()
    true_b = true_residual(gen, res_b.x)
    rel_b = checked_residual(state, f, res_b)
    tm = sch.timings
    print(f"  RCM bandwidths: max {max(sch.rcm_bandwidths)}, min "
          f"{min(sch.rcm_bandwidths)}; nbk {nbk}; factor {fac} (dense "
          f"coupling blocks); banded factor (host f64) {t_fac:.3f} s")
    print(f"  (a) banded on phase 8's dense-GenEO vectors: {its_a} iterations "
          f"(phase 8: {want}), true global rel. residual {true_a:.3e}; solve "
          f"best of 3 {best_a:.4f} s ({', '.join(f'{x:.4f}' for x in times_a)}"
          f"), {best_a / its_a * 1e3:.3f} ms per iteration; phase 8 (inv) "
          f"{cell['solve_s']:.4f} s, {cell['solve_s'] / want * 1e3:.3f} ms "
          "per iteration")
    print(f"  (b) banded + Lanczos GenEO: {res_b.iterations} iterations, "
          f"recomputed rel. residual {rel_b:.3e}, true global rel. residual "
          f"{true_b:.3e}; solve best of 3 {best_b:.4f} s "
          f"({', '.join(f'{x:.4f}' for x in times_b)}), "
          f"{best_b / res_b.iterations * 1e3:.3f} ms per iteration")
    print(f"  Lanczos GenEO {tm['geneo']:.3f} s (neumann_factor "
          f"{tm['neumann_factor']:.3f}, lanczos_steps "
          f"{tm['lanczos_steps']:.3f}, lanczos_eig {tm['lanczos_eig']:.3f}) "
          f"against phase 8's dense GenEO {cell['geneo_s']:.3f} s")
    print(f"  banded / inv bmm, one local solve: "
          f"{band_t[1][0] / inv_t[1][0]:.3f} (mu=1, L2 flushed), "
          f"{band_t[4][0] / inv_t[4][0]:.3f} (mu=4)")
    print(f"  peak device memory {peak / 2**30:.2f} GiB, "
          f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB "
          f"held by earlier phases (phase 8 with inv: "
          f"{cell['peak'] / 2**30:.2f} GiB)")
    print(f"  launches on this path: ell_spmv {launches[0]}, pexchange "
          f"{launches[1]}; by the panel width {by_mu[0]} / {by_mu[1]}; "
          "plain-version calls on the card "
          f"{plain_calls}")
    check(its_a == want, f"banded on phase 8's vectors: {its_a} != {want}")
    check(true_a <= 1e-5, f"(a) true residual {true_a:.3e}")
    check(abs(res_b.iterations - want) <= 2 and true_b <= 1e-5,
          f"banded + Lanczos: {res_b.iterations} iterations (phase 8: "
          f"{want}), true residual {true_b:.3e}")
    check(min(launches) > 0, f"launches on the path: {launches}")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")
    cell["its_b"] = res_b.iterations
    recs = {r["name"]: r for r in unstr_recs}
    return [banded_record(recs["ell_spmv"], "ell_spmv banded RCM path",
                          launches[0]),
            banded_record(recs["pexchange"], "pexchange banded RCM path",
                          launches[1])]


def canvas_checks(A, rng, mus):
    """B1 (mu=1) and B2 (mu>1) on a canvas-annotated operator against the
    plain canvas form (``spmm_dia_canvas``), with ``torch.equal``: the
    flat kernels read a stored zero where the canvas form reads its zero
    halo, so the sums are the same. Returns the largest difference."""
    import torch
    from hpddm_tpu_torch.ops.spmv import spmm, spmm_dia_canvas

    check(A.canvas_hw is not None, "the operator carries no canvas")
    S, _, n = A.values.shape
    worst = 0.0
    for mu in mus:
        x = torch.as_tensor(rng.normal(size=(S, n, mu)),
                            device="cuda").to(A.values.dtype)
        y, ref = spmm(A, x), spmm_dia_canvas(A, x)
        err = float((y - ref).abs().max())
        same = torch.equal(y, ref)
        print(f"  {'B1' if mu == 1 else 'B2'} on the canvas operator "
              f"(S={S}, n={n}, canvas {A.canvas_hw}, mu={mu}, "
              f"{dtype_name(A.values.dtype)}) vs spmm_dia_canvas: "
              f"max|err| = {err:.3e}, bitwise equal: {same}")
        check(same, f"kernel differs from the plain canvas form at mu={mu}")
        worst = max(worst, err)
    return worst


def muT_checks(A, rng, mus):
    """B3 (the RHS-leading panel) on a canvas operator at each mu against
    its plain version and the plain canvas form, with ``torch.equal``.
    Returns the largest difference."""
    import torch
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.ops.spmv import spmm_dia_canvas_muT, spmm_muT

    S, _, n = A.values.shape
    worst = 0.0
    for mu in mus:
        xT = torch.as_tensor(rng.normal(size=(S, mu, n)),
                             device="cuda").to(A.values.dtype)
        y = spmm_muT(A, xT)
        ref = kmod.dia_spmm_muT_reference(A.values, xT, A.offsets)
        err = float((y - ref).abs().max())
        same = (torch.equal(y, ref),
                torch.equal(y, spmm_dia_canvas_muT(A, xT)))
        print(f"  B3 on the canvas operator (S={S}, n={n}, mu={mu}, RHS "
              f"leading, {dtype_name(A.values.dtype)}) vs its plain version "
              f"and the plain canvas form: bitwise equal {same}, max|err| "
              f"{err:.3e}")
        check(all(same), f"B3 differs from its plain versions at mu={mu}")
        worst = max(worst, err)
    return worst


def canvas_record(name, A, mu, launches, err, muT=False):
    """The record of B1 (mu=1), B2 or, with ``muT``, B3 on a canvas
    operator: the kernel, the plain canvas form and torch.sparse.mm on the
    card with the L2 flushed, and the bound (values, x and y once)."""
    import torch
    from hpddm_tpu_torch.examples.library_ops import dia_csr
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.ops.spmv import spmm_dia_canvas, spmm_dia_canvas_muT
    from hpddm_tpu_torch.timing import cold_events_ms

    vals, offs = A.values, A.offsets
    S, _, n = vals.shape
    x = torch.ones((S, n, mu), dtype=vals.dtype, device="cuda")
    if muT:
        xT = x.transpose(1, 2).contiguous()
        k_ms = cold_events_ms(lambda: kmod.dia_spmm_muT(vals, xT, offs))
        p_ms = cold_events_ms(lambda: spmm_dia_canvas_muT(A, xT), reps=10)
    elif mu == 1:
        xs = x[:, :, 0].contiguous()
        k_ms = cold_events_ms(lambda: kmod.dia_spmv(vals, xs, offs))
    else:
        k_ms = cold_events_ms(lambda: kmod.dia_spmm(vals, x, offs))
    if not muT:
        p_ms = cold_events_ms(lambda: spmm_dia_canvas(A, x), reps=10)
    nbytes = (vals.numel() + 2 * x.numel()) * vals.element_size()
    b_ms, b_by = bound(nbytes, 2 * int(torch.count_nonzero(vals)) * mu,
                       vals.dtype)
    lib = library_ms(dia_csr(vals, offs), x.reshape(-1, mu))
    print(f"  {name} (S={S}, n={n}, mu={mu}"
          + (", RHS leading" if muT else "")
          + f", {dtype_name(vals.dtype)}): kernel {k_ms * 1e3:.2f} us, plain "
          "canvas form "
          f"{p_ms * 1e3:.2f} us, torch.sparse.mm "
          + ("not timed" if lib is None else f"{lib * 1e3:.2f} us")
          + f" (L2 flushed); bound {b_ms * 1e3:.2f} us ({b_by}) = "
          f"{100 * b_ms / k_ms:.1f}% of the kernel's time; {launches} "
          "launches on the path")
    return kernel_record(
        name, "hpddm_tpu_torch/csrc/dia_spmv.cu",
        "hpddm_tpu/ops/pallas_spmv.py:253" if muT else
        "hpddm_tpu/ops/pallas_spmv.py:98" if mu == 1 else
        "hpddm_tpu/ops/pallas_spmv.py:167", launches, err, k_ms, p_ms,
        b_ms, b_by, lib)


def muT_gmv_path(state, rng, mu=4):
    """The multi-RHS gmv's RHS-leading branch at mu on a canvas grid state
    (phase 14): a chain of gmv calls (the path; B3 launches counted from
    here, no B2, no plain-version call), then B3 against its plain version
    and the plain canvas form (at mu and at 2 and 3), and the gmv against
    the trailing-mu path, all with ``torch.equal``; then the times
    (``bench_gmv.measure_muT``).
    Returns (B3 launches on the path, largest difference)."""
    import torch
    from hpddm_tpu_torch.examples import bench_gmv
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.ops.spmv import spmm, spmm_dia_canvas_muT, spmm_muT
    from hpddm_tpu_torch.parallel.ops import scaled_exchange
    from hpddm_tpu_torch.precond.schwarz import gmv

    plain = count_plain_calls()
    A, dec = state.A, state.dec
    x = torch.as_tensor(rng.normal(size=(dec.S, dec.n_max, mu)),
                        device="cuda")
    kmod.launches = kmod.spmm_launches = kmod.muT_launches = 0
    plain[0] = 0
    bench_gmv.chain_ms(state, x)
    b3, b2 = kmod.muT_launches, kmod.spmm_launches - kmod.muT_launches
    b1, plain_calls = kmod.launches, plain[0]
    print(f"  gmv at mu={mu} (RHS leading): the chain launched dia_spmm_muT "
          f"(B3) {b3} times, dia_spmm (B2) {b2}, dia_spmv {b1}; plain-version "
          f"calls on the card {plain_calls}")
    check(b3 > 0 and b2 == 0 and b1 == 0,
          f"gmv at mu={mu}: B3 {b3}, B2 {b2}, B1 {b1} launches")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")
    err3 = muT_checks(A, rng, (2, 3))
    xT = x.transpose(1, 2).contiguous()
    yT = spmm_muT(A, xT)
    ref = kmod.dia_spmm_muT_reference(A.values, xT, A.offsets)
    canvas = spmm_dia_canvas_muT(A, xT)
    y, trailing = gmv(state, x), scaled_exchange(dec, spmm(A, x))
    err = max(err3, float((yT - ref).abs().max()),
              float((y - trailing).abs().max()))
    same = (torch.equal(yT, ref), torch.equal(yT, canvas),
            torch.equal(y, trailing))
    print(f"    B3 vs its plain version, vs the plain canvas form, gmv vs "
          f"the trailing-mu path: bitwise equal {same}, max|err| {err:.3e}")
    check(all(same), f"the RHS-leading gmv differs: {same}")
    bench_gmv.report_muT(bench_gmv.measure_muT(state, x))
    return b3, err


def phase_gmv_cells():
    """Phase 14: the GMV cells on the slab exchange and the canvas
    operator (examples/bench_gmv.py), f64: bench.py's 2048x2048/16 and the
    banded grid card cell's 512x512/64. Per cell: a chain of gmv calls
    (the path, counts from here), then its time, nonzeros per second,
    share of the bound and device operations, the SpMM and the three
    exchanges (slab, plain general, B5) back to back, B1/B2 against the
    plain canvas form (bitwise) and the slab exchange against the general
    one; at 2048x2048/16 also the gmv of four right-hand sides through
    its RHS-leading branch (``muT_gmv_path``). Returns the B1 and B3
    records of the paths."""
    import torch
    from hpddm_tpu_torch.examples import bench_gmv
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.parallel.ops import exchange

    print("phase 14: GMV cells (generate_uniform, overlap 1, slab exchange, "
          "canvas operator, f64)")
    plain = count_plain_calls()
    rng = np.random.default_rng(14)
    rec = None
    for S, N in ((16, 2048), (64, 512)):
        state, x, t = bench_gmv.cell(S, N)
        dec = state.dec
        check(dec.grid is not None and state.A.canvas_hw is not None,
              f"{N}x{N}/{S}: no slab plan or canvas")
        kmod.launches = kmod.spmm_launches = 0
        plain[0] = 0
        bench_gmv.chain_ms(state, x)
        b1, b2, plain_calls = kmod.launches, kmod.spmm_launches, plain[0]
        print(f"  {N}x{N}/{S}: setup {t:.2f} s, n_max {dec.n_max}, canvas "
              f"{state.A.canvas_hw}, slab strips t={dec.grid.t}; the gmv "
              f"chain launched dia_spmv {b1} times, dia_spmm {b2}, "
              f"plain-version calls on the card {plain_calls}")
        check(b1 > 0, f"{N}x{N}/{S}: dia_spmv never launched on the path")
        check(plain_calls == 0, f"{plain_calls} plain-version calls on "
              "the card")
        r = bench_gmv.measure(state, x)
        bench_gmv.report(S, N, r)
        err = canvas_checks(state.A, rng, (1, 4, 8))
        y = torch.as_tensor(rng.normal(size=(S, dec.n_max, 3)), device="cuda")
        ex = {k: exchange(d, y) for k, d in bench_gmv.exchanges(dec).items()}
        d_gen = float((ex["slab"] - ex["general"]).abs().max())
        d_b5 = float((ex["B5"] - ex["general"]).abs().max())
        print(f"  exchanges at mu=3: slab - general {d_gen:.3e}, B5 - "
              f"general {d_b5:.3e} (max |y| {float(y.abs().max()):.2f})")
        check(d_gen <= 1e-13 and d_b5 == 0.0,
              f"exchanges disagree: slab {d_gen:.3e}, B5 {d_b5:.3e}")
        if rec is None:
            rec = [canvas_record("dia_spmv canvas GMV path", state.A, 1, b1,
                                 err)]
            b3, err3 = muT_gmv_path(state, rng)
            rec.append(canvas_record("dia_spmm_muT canvas gmv path mu=4",
                                     state.A, 4, b3, err3, muT=True))
        del state, x, y, ex
    return rec


def phase_flagship():
    """Phase 15: flagship512 (examples/flagship.py): f32 with the host
    refinement and the double-word refinement, then f64 with no
    refinement; the launches of the path; B2 at mu = nu = 8 on the
    flagship's canvas operator against the plain canvas form. Returns
    the B2 record of the path."""
    import torch
    from hpddm_tpu_torch.examples import flagship
    from hpddm_tpu_torch.ops import dia_spmv as kmod

    print(f"phase 15: flagship512 (generate_uniform({flagship.FLAGSHIP_N}, "
          f"{flagship.FLAGSHIP_NX}, {flagship.FLAGSHIP_NX}), contrast 1e4 "
          "channel, Jacobi-scaled, banded, Lanczos GenEO nu=8, bsr coarse, "
          "deflated)")
    plain = count_plain_calls()
    kmod.launches = kmod.spmm_launches = 0
    plain[0] = 0
    r32, _ = flagship.run(np.float32)
    r64, st64 = flagship.run(np.float64)
    b1, b2, plain_calls = kmod.launches, kmod.spmm_launches, plain[0]
    for r in (r32, r64):
        flagship.report(r)
    want64 = flagship.FLAGSHIP_ITS["float64"]
    want32 = flagship.FLAGSHIP_ITS["float32, GenEO op by op"]
    print(f"  JAX package's CPU counts: f64 {want64}; f32 "
          f"{flagship.FLAGSHIP_ITS['float32']} with its f32 Lanczos "
          f"jitted, {want32} with it op by op; dia_spmv launches "
          f"{b1}, dia_spmm {b2} (the bsr assembly's mu=8 panels), "
          f"plain-version calls on the card {plain_calls}")
    print(f"  f32 + refinement against f64: time to true 1e-8 "
          f"{r32['time_to_1e-8_s']} s against {r64['time_to_1e-8_s']} s; "
          f"setup {r32['setup_s']:.3f} s against {r64['setup_s']:.3f} s")
    for r in (r32, r64):
        check(r["true_relres"] <= 1e-8,
              f"{r['dtype']}: true rel. residual {r['true_relres']:.3e}")
    check(r64["iterations"] == want64,
          f"f64: {r64['iterations']} != {want64} (JAX CPU f64)")
    # f32: within one of the JAX package's f32 count with its Lanczos run
    # op by op, the arithmetic of the port's eager operations (jitted, XLA
    # rounds the inner solve's noisy refinement residual otherwise: 27);
    # the card's f32 sums are ordered otherwise than the CPU's
    check(abs(r32["iterations"] - want32) <= 1,
          f"f32: {r32['iterations']} not within 1 of {want32}")
    check(b1 > 0 and b2 > 0, f"launches on the path: dia_spmv {b1}, "
          f"dia_spmm {b2}")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")
    err = canvas_checks(st64.A, np.random.default_rng(15), (1, 8))
    return canvas_record("dia_spmm canvas flagship bsr assembly", st64.A, 8,
                         b2, err)


def phase_ladder():
    """Phase 16: ladder256 (examples/ladder.py: generate_uniform(256,
    2048, 2048), contrast-1e4 channel, Jacobi-scaled once in f64 and cast
    for f32, banded, Lanczos GenEO nu=8, block-sparse coarse assembly with
    the nested level-2 CG and a direct level 3, deflated, flexible GMRES):
    f32 solved at tol 2e-3 then refined on the host to 1e-10, f64 solved
    at tol 1e-8 alone; each must reach a true relative residual <= 1e-8
    within 80 GB of device memory, in mode bsr with a direct level 3;
    outer and inner iterations, setup phases, solve, refine, time to true
    1e-8 and peak memory; B1/B2 launches and plain-version calls (0); the
    time of one coarse solve and one apply against an outer iteration;
    B1 and B2 at mu=8 and B3 at mu=2, 3, 4 on the ladder's canvas operator
    against their plain versions (bitwise). Returns the B1 and B2 records
    of the path."""
    import torch
    from hpddm_tpu_torch.examples import bench_gmv, ladder
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.precond.schwarz import _coarse_solve_bsr, apply

    print(f"phase 16: ladder256 (generate_uniform({ladder.LADDER_N}, "
          f"{ladder.LADDER_NX}, {ladder.LADDER_NX}), contrast 1e4 channel, "
          "Jacobi-scaled, banded, Lanczos GenEO nu=8, bsr coarse, level-2 CG "
          "+ direct level 3, deflated)")
    prob = ladder.problem()
    print(f"  generate and scale (f64, once): {prob['seconds']:.3f} s")
    plain = count_plain_calls()
    kmod.launches = kmod.spmm_launches = kmod.muT_launches = 0
    plain[0] = 0
    r32, st32 = ladder.run(prob, np.float32, reps=1)
    del st32
    r64, st64 = ladder.run(prob, np.float64, reps=1)
    b1, b2, b3 = (kmod.launches, kmod.spmm_launches - kmod.muT_launches,
                  kmod.muT_launches)
    plain_calls = plain[0]
    del prob
    for r in (r32, r64):
        ladder.report(r)
    print(f"  dia_spmv launches {b1}, dia_spmm {b2} (the bsr assembly's mu=8 "
          f"panels), dia_spmm_muT {b3}; plain-version calls on the card "
          f"{plain_calls}")
    print(f"  f32 + refinement against f64: time to true 1e-8 "
          f"{r32['time_to_1e-8_s']} s against {r64['time_to_1e-8_s']} s; "
          f"setup {r32['setup_s']:.3f} s against {r64['setup_s']:.3f} s")
    # the nested coarse solve's and the apply's wall time against an
    # outer iteration (f64 state), each synchronized, best of 5
    co = st64.coarse
    rng = np.random.default_rng(16)
    c = torch.as_tensor(rng.normal(size=(st64.dec.S, co.nu_max, 1)),
                        device="cuda")
    x = torch.as_tensor(rng.normal(size=(st64.dec.S, st64.dec.n_max, 1)),
                        device="cuda")
    walls = {}
    for name, fn in (("coarse", lambda: _coarse_solve_bsr(co, c,
                                                          return_its=True)),
                     ("apply", lambda: apply(st64, x))):
        out = fn()
        best = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        walls[name] = (best, out)
    it_s = r64["solve_s"] / r64["iterations"]
    inner_its = walls["coarse"][1][1]
    ops = bench_gmv.device_ops(lambda: _coarse_solve_bsr(co, c))
    print(f"  f64: one coarse solve {walls['coarse'][0] * 1e3:.3f} ms "
          f"({inner_its} inner iterations, random right-hand side; "
          f"{ops} device operations, "
          + ("not recorded" if ops is None else
             f"{ops / max(inner_its, 1):.1f}")
          + f" an inner iteration), one apply "
          f"{walls['apply'][0] * 1e3:.3f} ms, an outer iteration "
          f"{it_s * 1e3:.3f} ms (solve / iterations): the coarse solve is "
          f"{100 * walls['coarse'][0] / it_s:.1f}% of it")
    for r in (r32, r64):
        check(r["true_relres"] <= 1e-8,
              f"{r['dtype']}: true rel. residual {r['true_relres']:.3e}")
        check(r["peak_bytes"] < 80e9,
              f"{r['dtype']}: peak {r['peak_bytes'] / 1e9:.1f} GB")
        check(r["mode"] == "bsr" and r["lvl3"] == "direct",
              f"{r['dtype']}: coarse mode {r['mode']}, level 3 {r['lvl3']}")
    check(b1 > 0 and b2 > 0, f"launches on the path: dia_spmv {b1}, "
          f"dia_spmm {b2}")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")
    err = canvas_checks(st64.A, rng, (1, 8))
    muT_checks(st64.A, rng, (2, 3, 4))
    recs = [canvas_record("dia_spmv canvas ladder256 path", st64.A, 1, b1,
                          err),
            canvas_record("dia_spmm canvas ladder256 bsr assembly", st64.A,
                          8, b2, err)]
    del st64
    return recs


def dia_model_record(name, A, launches, mu=1):
    """B1 (mu=1), or B2 on an (S, n, mu) panel, on a model's flat DIA
    operator A (its own offsets): the kernel against its plain version,
    bitwise, in f64 and f32 on a random x; the f64 kernel, plain version
    and torch.sparse.mm timed with the L2 flushed beside the bound (values,
    x and y once; a product and a sum per stored nonzero and column)."""
    import torch
    from hpddm_tpu_torch.examples.library_ops import dia_csr
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.timing import cold_events_ms

    offs = A.offsets
    S, nd, n = A.values.shape
    fn = kmod.dia_spmv if mu == 1 else kmod.dia_spmm
    x64 = torch.as_tensor(np.random.default_rng(nd).normal(
        size=(S, n) if mu == 1 else (S, n, mu)), device="cuda")
    err = 0.0
    for dt in (torch.float64, torch.float32):
        vals, x = A.values.to(dt).contiguous(), x64.to(dt)
        y, ref = fn(vals, x, offs), kmod.dia_spmv_reference(vals, x, offs)
        check(torch.equal(y, ref), f"{name}: {fn.__name__} differs from "
              f"plain ({dtype_name(dt)})")
        err = max(err, float((y - ref).abs().max()))
    del y, ref
    vals = A.values
    k_ms = cold_events_ms(lambda: fn(vals, x64, offs))
    p_ms = cold_events_ms(lambda: kmod.dia_spmv_reference(vals, x64, offs))
    b_ms, b_by = bound((vals.numel() + 2 * x64.numel()) * 8,
                       2 * int(torch.count_nonzero(vals)) * mu, vals.dtype)
    lib = library_ms(dia_csr(vals, offs), x64.reshape(-1, mu))
    print(f"  {name} (S={S}, nd={nd}, n={n}, mu={mu}, f64): kernel "
          f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, torch.sparse.mm "
          + ("not timed" if lib is None else f"{lib * 1e3:.2f} us")
          + f" (L2 flushed); bound {b_ms * 1e3:.2f} us ({b_by}) = "
          f"{100 * b_ms / k_ms:.1f}% of the kernel's time; bitwise equal to "
          f"plain in f64 and f32; {launches} launches on the path")
    return kernel_record(name, "hpddm_tpu_torch/csrc/dia_spmv.cu",
                         "hpddm_tpu/ops/pallas_spmv.py:98" if mu == 1 else
                         "hpddm_tpu/ops/pallas_spmv.py:167", launches, err,
                         k_ms, p_ms, b_ms, b_by, lib)


def phase_elasticity():
    """Phase 17: the elasticity flagship (examples/bench_elasticity.py:
    elasticity2d.generate(8, 512, 512), contrast 1e3, overlap 2, 2D box
    partition, Jacobi-scaled, banded local solves with dense coupling on
    the node rows, Lanczos GenEO nu=16, deflated, GMRES(60), f64, tol
    1e-8). Gates: recomputed relative residual <= 1e-8, the true one of
    the unscaled global system <= 1e-6, converged, the classical
    Gram-Schmidt count at most 2 above the JAX package's range, the
    modified Gram-Schmidt solve's count within 2 of the JAX package's
    (``ELAST_ITS``), its recomputed residual <= 1e-6 (the JAX package's
    own: 3.1e-7), dense coupling engaged, peak < 80 GB, B1 launches and
    no plain-version call. Then one banded solve and one gmv
    against an iteration, and B1 at nd=21 against its plain version.
    Returns the B1 record of the path."""
    import torch
    from hpddm_tpu_torch.examples import bench_elasticity as be
    from hpddm_tpu_torch.examples.bench_gmv import device_ops
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.precond.schwarz import gmv
    from hpddm_tpu_torch.timing import events_ms

    print(f"phase 17: elasticity flagship (elasticity2d.generate("
          f"{be.ELAST_S}, {be.ELAST_NN}, {be.ELAST_NN}), contrast "
          f"{be.ELAST_CONTRAST:g}, overlap 2, box partition, Jacobi-scaled, "
          f"banded dense coupling, Lanczos GenEO nu={be.ELAST_NU}, "
          "deflated, GMRES(60), f64, tol 1e-8)")
    prob = be.problem()
    print(f"  generate, partition and scale (host f64): "
          f"{prob['seconds']:.3f} s; ndof {prob['gen'].A_global.shape[0]}, "
          f"banded shapes {sorted(set(prob['shapes']))}")
    plain = count_plain_calls()
    kmod.launches = kmod.spmm_launches = 0
    plain[0] = 0
    r, sch, state, f = be.run(prob, np.float64)
    its_m, rel_m = be.mgs_solve(state, f, sch.opt)
    b1, b2, plain_calls = kmod.launches, kmod.spmm_launches, plain[0]
    be.report(prob, r)
    print(f"    the same solve with modified Gram-Schmidt: {its_m} "
          f"iterations, recomputed rel. residual {rel_m:.3e}")
    print(f"  JAX package's CPU counts {be.ELAST_ITS}; recomputed rel. "
          f"residual {r['relres']:.4e} = {100 * r['relres'] / 1e-8:.1f}% of "
          f"its gate 1e-8; dia_spmv launches "
          f"{b1} in all ({r['b1_setup']} in setup: Lanczos apply_B and the "
          f"Neumann refinement residual), dia_spmm {b2} (the coarse "
          f"assembly's panel); plain-version calls on the card {plain_calls}")
    check(r["relres"] <= 1e-8, f"recomputed rel. residual {r['relres']:.3e}")
    check(r["true_relres"] <= 1e-6,
          f"true rel. residual of the global system {r['true_relres']:.3e}")
    check(r["converged"], f"not converged in {r['iterations']} iterations")
    check(r["iterations"] <= max(be.ELAST_ITS["cgs"]) + 2,
          f"classical Gram-Schmidt: {r['iterations']} iterations, more "
          f"than 2 above {be.ELAST_ITS['cgs']}")
    check(abs(its_m - be.ELAST_ITS["mgs"]) <= 2,
          f"modified Gram-Schmidt: {its_m} iterations not within 2 of "
          f"{be.ELAST_ITS['mgs']}")
    check(rel_m <= 1e-6, f"modified Gram-Schmidt: recomputed rel. "
          f"residual {rel_m:.3e}")
    check(r["dense_coupling"], "the banded factor has no dense coupling")
    check(r["peak_bytes"] < 80e9, f"peak {r['peak_bytes'] / 1e9:.1f} GB")
    check(b1 > 0, f"dia_spmv launches on the path: {b1}")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")
    dec = state.dec
    rng = np.random.default_rng(17)
    solve_t = local_solve_times("banded dense coupling", state.solver, dec,
                                rng, mus=(1,))
    x1 = (dec.d[:, :, None] * torch.ones_like(f)).contiguous()
    g_ms = events_ms(lambda: gmv(state, x1), 20)
    ops = device_ops(lambda: state.solver.solve(x1))
    nbk = state.solver.Dinv.shape[0]
    print(f"  one banded solve {solve_t[1][0]:.3f} ms (L2 flushed), "
          f"{ops} device operations (2 nbk + 3 = {2 * nbk + 3} at nbk "
          f"{nbk}); one gmv {g_ms:.3f} ms; an iteration "
          f"{r['ms_per_it']:.3f} ms")
    return dia_model_record("dia_spmv elasticity flagship (nd=21)", state.A,
                            b1)


def phase_diffusion3d():
    """Phase 18: 3D diffusion (diffusion3d.generate_uniform(64, 64, 64, 64,
    overlap 1), checkerboard kappa contrast 1e3, 18^3 boxes, f64, tol
    1e-8): Lanczos GenEO nu=8 once (banded inner solve on the plane
    shapes), then on its vectors (a) inv and (b) plane-blocked banded,
    which must take (a)'s count, and a one-level inv solve, which must take
    no fewer. Gates: recomputed residuals <= 1e-8, B1 launches, no plain-version
    call. Returns the B1 record of the path."""
    import torch
    from hpddm_tpu_torch.models import diffusion3d
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import timed

    S, N = 64, 64
    print(f"phase 18: 3D diffusion (generate_uniform({S}, {N}, {N}, {N}), "
          "overlap 1, checkerboard contrast 1e3, Lanczos GenEO nu=8, inv "
          "and plane-blocked banded, f64, tol 1e-8)")

    def kappa(x, y, z):
        return np.where((np.floor(x / 2.5) + np.floor(y / 2.5)
                         + np.floor(z / 2.5)) % 2 == 0, 1.0, 1.0e3)
    t = time.perf_counter()
    gen = diffusion3d.generate_uniform(S, N, N, N, overlap=1, kappa=kappa,
                                       with_neumann=True)
    shapes = [(k1 - k0, (i1 - i0) * (j1 - j0))
              for (i0, i1, j0, j1, k0, k1) in gen.boxes]
    n_max = max(gen.n_loc)
    print(f"  generate_uniform {time.perf_counter() - t:.3f} s; n_max "
          f"{n_max}, plane shapes {sorted(set(shapes))}")
    f_np = np.zeros((S, n_max, 1))
    for s in range(S):
        f_np[s, : gen.n_loc[s]] = gen.f[s]

    def setup(kind, two_level=True):
        kw = dict(schwarz_coarse_correction="deflated", geneo_nu=8) \
            if two_level else {}
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=Options(local_solver=kind, tol=1e-8,
                                      max_it=200, **kw), device="cuda")
        if kind == "banded":
            sch.set_banded_shapes(shapes)
        return sch

    plain = count_plain_calls()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kmod.launches = kmod.spmm_launches = 0
    plain[0] = 0
    f = torch.as_tensor(f_np, device="cuda")
    sch_b = setup("banded")
    sch_b.solve_gevp(gen.neumann, method="lanczos")
    b1_geneo = kmod.launches
    runs = {}
    for name, sch in (("inv", setup("inv")), ("banded", sch_b),
                      ("one-level inv", setup("inv", False))):
        if name == "inv":
            sch.set_vectors(sch_b._deflation_vectors)
        state = sch.build()
        best, times, res = timed(lambda: solve(state, f, opt=sch.opt),
                                 reps=2, warmup=1)
        rel = checked_residual(state, f, res)
        runs[name] = (res.iterations, rel, best, dict(sch.timings))
        print(f"  {name}: {res.iterations} iterations, recomputed rel. "
              f"residual {rel:.3e}, solve best of 2 after a warm-up "
              f"{best:.4f} s ({best / res.iterations * 1e3:.3f} ms per "
              "iteration); setup seconds " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sch.timings.items())
              + ("" if name != "banded" else f"; factor "
                 f"{factor_txt(state.solver)}"))
        if name == "banded":
            keep = state
        del state
    b1, plain_calls = kmod.launches, plain[0]
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {peak / 2**30:.2f} GiB; dia_spmv launches "
          f"{b1_geneo} in GenEO, {b1} in all; dia_spmm {kmod.spmm_launches};"
          f" plain-version calls on the card {plain_calls}")
    for name, (its, rel, _, _) in runs.items():
        check(rel <= 1e-8, f"{name}: recomputed rel. residual {rel:.3e}")
    check(runs["banded"][0] == runs["inv"][0],
          f"banded {runs['banded'][0]} != inv {runs['inv'][0]} on the same "
          "vectors")
    # the checkerboard's 2.5-wide cells are 16^3 points, the boxes' cores
    # too: every coefficient jump lies on a subdomain interface, where the
    # one-level method already resolves it, so GenEO may gain nothing here
    check(runs["one-level inv"][0] >= runs["inv"][0],
          f"one-level {runs['one-level inv'][0]} below two-level "
          f"{runs['inv'][0]}")
    check(b1_geneo > 0 and b1 > b1_geneo, f"dia_spmv launches: {b1_geneo} "
          f"in GenEO, {b1} in all")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")
    return dia_model_record("dia_spmv 3D diffusion path (nd=7)", keep.A, b1)


def phase_elasticity3d():
    """Phase 19: 3D elasticity (elasticity3d.generate(8, 24, 24, 24),
    contrast 1e3, overlap 2, k-way partition, ELL, inv, f64, tol 1e-6):
    one-level, then GenEO nu=10 deflated, by Lanczos ("auto": n_max >
    6000) and by the dense pencil. Gates: recomputed residuals <= 1e-6,
    two-level (both eigensolvers) below one-level, the one-level and
    Lanczos counts within 2 of the CPU counts (``E3_ITS``), B4 and
    B5 launches, no plain-version call; B4 and B5 at this operator against
    their plain versions on a random x (bitwise, f64 and f32), timed
    beside the bound and torch.sparse.mm. Returns the B4 and B5 records of
    the path."""
    import torch
    from hpddm_tpu_torch.examples.elasticity import E3_ITS
    from hpddm_tpu_torch.models import elasticity3d
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.parallel import pexchange as pk
    from hpddm_tpu_torch.precond.schwarz import Schwarz
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import timed

    S, N = 8, 24
    print(f"phase 19: 3D elasticity (elasticity3d.generate({S}, {N}, {N}, "
          f"{N}), contrast 1e3, overlap 2, k-way, ELL, inv, GenEO nu=10, "
          "deflated, f64, tol 1e-6)")
    t = time.perf_counter()
    gen, neumann, _ = elasticity3d.generate(S, N, N, N, contrast=1e3,
                                            overlap=2)
    print(f"  generate (assembly, k-way partition, overlap, Neumann "
          f"matrices) {time.perf_counter() - t:.3f} s; ndof "
          f"{gen.A_global.shape[0]}, n_loc {min(gen.n_loc)}-{max(gen.n_loc)}")
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in (ek, pk):
        mod.launches = 0
        mod.launches_by_mu.clear()
    plain[0] = 0
    runs = {}
    for nu, method in ((0, None), (10, "auto"), (10, "dense")):
        kw = dict(schwarz_coarse_correction="deflated", geneo_nu=nu) \
            if nu else {}
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=Options(tol=1e-6, max_it=300,
                                      gmres_restart=150, **kw),
                      device="cuda")
        f = np.zeros((S, sch.n_max, 1))
        for s in range(S):
            f[s, : gen.n_loc[s], 0] = gen.f[s][:, 0]
        f = sch.exchange_rhs(torch.as_tensor(f, device="cuda"))
        if nu:
            sch.solve_gevp(neumann, method=method)
        state = sch.build()
        best, _, res = timed(lambda: solve(state, f, opt=sch.opt), reps=2,
                             warmup=1)
        rel = checked_residual(state, f, res)
        runs[method] = (res.iterations, rel)
        print(f"  nu={nu}" + ("" if not nu else ", dense pencil"
                              if method == "dense" else
                              ", Lanczos (auto: n_max > 6000)")
              + f": {res.iterations} iterations, recomputed rel. "
              f"residual {rel:.3e}, solve best of 2 after a warm-up "
              f"{best:.4f} s ({best / res.iterations * 1e3:.3f} ms per "
              "iteration); setup seconds " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sch.timings.items()))
    launches, plain_calls = (ek.launches, pk.launches), plain[0]
    peak = torch.cuda.max_memory_allocated()
    A, dec = state.A, state.dec
    print(f"  n_max {dec.n_max}, ELL width {A.values.shape[1]}, payload "
          f"columns {A.payload.cols.dtype}; peak device memory "
          f"{peak / 2**30:.2f} GiB; ell_spmv launches {launches[0]}, "
          f"pexchange {launches[1]} (by the panel width "
          f"{dict(ek.launches_by_mu)}, {dict(pk.launches_by_mu)}); "
          f"plain-version calls on the card {plain_calls}")
    for method, (its, rel) in runs.items():
        check(rel <= 1e-6, f"GenEO {method}: recomputed rel. residual "
              f"{rel:.3e}")
    # Lanczos's shift-invert inner solve here is 25 CG steps on the
    # shifted Neumann matrix preconditioned by the inverse of the assembled
    # one (the JAX package's algorithm); the shift leaves the clamped
    # face's penalty rows out of its scale (neumann_regularization: the
    # JAX package's shift loses the rigid-body modes, and its vectors take
    # more iterations than one level, ROADMAP C10). Two levels below one
    # by both eigensolvers (the JAX test's own assertion), one level
    # within 2 of the JAX package's count, Lanczos within 2 of the port's
    # CPU count (E3_ITS)
    two, one, lz = runs["dense"][0], runs[None][0], runs["auto"][0]
    check(two < one and lz < one, f"two-level {two} (dense pencil) / {lz} "
          f"(Lanczos) not below one-level {one}")
    for key, its in (("one level", one), ("lanczos", lz)):
        check(abs(its - E3_ITS[key]) <= 2, f"{key}: {its} iterations not "
              f"within 2 of the CPU count {E3_ITS[key]}")
    check(min(launches) > 0, f"ell_spmv / pexchange launches {launches}")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")

    return ell_path_records("3D elasticity", A, dec, launches,
                            np.random.default_rng(19))


def ell_path_records(label, A, dec, launches, rng):
    """B4 and B5 at a path's ELL operator A and its exchange plan: against
    their plain versions on a normal random x (with a non-finite entry, mu
    1 and 4 / 1 and 3), f64 and f32 bitwise; f64 timed on a random x beside
    the bound and torch.sparse.mm. ``launches``: (B4, B5) on the path.
    Returns their two kernel records."""
    import torch
    from hpddm_tpu_torch.examples.library_ops import ell_csr, exchange_csr
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.parallel import pexchange as pk
    from hpddm_tpu_torch.timing import cold_events_ms

    S = dec.S
    err4 = check_ell(label, A, (1, 4), rng)
    err5 = check_pexchange(label, dec, rng)
    plan = dec.pexch
    x = torch.as_tensor(rng.normal(size=(S, dec.n_max, 1)), device="cuda")
    nnz = int(torch.count_nonzero(A.values))
    cw = A.payload.cols.element_size()
    k4 = cold_events_ms(lambda: ek.ell_spmv(A.values, A.cols, x, A.payload))
    p4 = cold_events_ms(lambda: ek.ell_spmv_payload_reference(
        A.values, A.payload, x))
    l4 = library_ms(ell_csr(A.values, A.cols), x.reshape(-1, 1))
    b4_ms, b4_by = bound(nnz * (8 + cw) + 2 * x.numel() * 8, 2 * nnz,
                         x.dtype)
    k5 = cold_events_ms(lambda: pk.pexchange(plan, x))
    p5 = cold_events_ms(lambda: pk.pexchange_reference(plan, x))
    l5 = library_ms(exchange_csr(plan, x.dtype), x.reshape(-1, 1))
    maps5 = plan.interior.numel() + 4 * int((plan.dst >= 0).sum()) + \
        4 * int((plan.rows >= 0).sum())
    b5_ms, b5_by = bound(maps5 + 2 * x.numel() * 8,
                         int((plan.rows >= 0).sum()), x.dtype)

    def txt(ms):
        return "not timed" if ms is None else f"{ms * 1e3:.2f} us"
    print(f"  ell_spmv (B4) at (S={S}, w={A.values.shape[1]}, n={dec.n_max})"
          f" f64, mu=1: kernel {k4 * 1e3:.2f} us, plain {p4 * 1e3:.2f} us, "
          f"torch.sparse.mm {txt(l4)} (L2 flushed); bound {b4_ms * 1e3:.2f} "
          f"us ({b4_by}; {nnz} nonzeros) = {100 * b4_ms / k4:.1f}% of the "
          f"kernel's time; kernel / library "
          f"{'-' if l4 is None else f'{k4 / l4:.3f}'}; bitwise equal to "
          "plain in f64 and f32")
    print(f"  pexchange (B5) at (S={S}, n={dec.n_max}, m_max={dec.m_max}, "
          f"k_max={dec.k_max}) f64, mu=1: kernel {k5 * 1e3:.2f} us, plain "
          f"{p5 * 1e3:.2f} us, torch.sparse.mm {txt(l5)} (L2 flushed); "
          f"bound {b5_ms * 1e3:.2f} us ({b5_by}) = {100 * b5_ms / k5:.1f}% "
          "of the kernel's time; bitwise equal to plain in f64 and f32")
    return [kernel_record(f"ell_spmv {label} path (w="
                          f"{A.values.shape[1]})",
                          "hpddm_tpu_torch/csrc/ell_spmv.cu",
                          "hpddm_tpu/ops/pallas_ell.py:133", launches[0],
                          err4, k4, p4, b4_ms, b4_by, l4),
            kernel_record(f"pexchange {label} path",
                          "hpddm_tpu_torch/csrc/pexchange.cu",
                          "hpddm_tpu/parallel/pexchange.py:149",
                          launches[1], err5, k5, p5, b5_ms, b5_by, l5)]


def phase_sequence():
    """Phase 20: the recycling sequence (examples/driver.py: the 10 systems
    of drifting_diffusion, n=2025, GMRES(40) and GCRODR(40,20) strategy A,
    tol 1e-10, the dense product, f64). Gates: the totals in the
    reference-derived windows and GCRODR below GMRES."""
    import torch
    from hpddm_tpu_torch.examples import driver
    from hpddm_tpu_torch.options import Options

    print("phase 20: recycling sequence (10 systems, n=2025, GMRES(40) and "
          "GCRODR(40,20), tol 1e-10, dense product, f64)")
    t = time.perf_counter()
    total_g, total_r, _ = driver.totals(Options(), torch.device("cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"  totals: GMRES {total_g} (reference {driver.REF_GMRES} +- 10), "
          f"GCRODR {total_r} (reference {driver.REF_GCRODR_A} +- 25); "
          f"{wall:.3f} s for both, "
          f"{wall / (total_g + total_r) * 1e3:.3f} ms per iteration")
    check(abs(total_g - driver.REF_GMRES) <= 10, f"GMRES total {total_g}")
    check(abs(total_r - driver.REF_GCRODR_A) <= 25,
          f"GCRODR total {total_r}")
    check(total_r < total_g, f"GCRODR {total_r} not below GMRES {total_g}")


# phase 21's full cell (models/helmholtz.generate(64, 512, 512, k=25.6,
# eps=0.3): kh = 0.5, 12.6 points per wavelength, about 41 wavelengths
# across, n_max 4356) and the count it is held to: a scipy implementation
# of the same operator, POU, optimized matrices and right-preconditioned
# GMRES(200) takes 41 iterations on the CPU
HELM_S, HELM_N, HELM_K, HELM_EPS = 64, 512, 25.6, 0.3
HELM_FULL_ITS = 41


def helm_solve(gen, method="oras", optimized=True, tol=1e-6, max_it=1000,
               reps=3):
    """The Helmholtz path on the card for ``gen``: Schwarz with the
    optimized matrices (``optimized``), the local inverses, one solve with
    the kernels' counts set to 0 just before it and read just after, then
    (``reps`` > 0) the solve timed, best of ``reps`` after a warm-up.
    Returns (a dict of the run's numbers, the state, the right-hand
    side)."""
    import torch
    from hpddm_tpu_torch.examples import helmholtz as hz
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz, apply, gmv
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import events_ms, timed

    plain = count_plain_calls()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    opt = Options(schwarz_method=method, tol=tol, max_it=max_it,
                  gmres_restart=200)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d, options=opt,
                  optimized_mats=gen.oras_mats if optimized else None,
                  device="cuda")
    f = hz.rhs(gen, sch.n_max, "cuda")
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    state = sch.build()
    kmod.launches = kmod.spmm_launches = 0
    plain[0] = 0
    res = solve(state, f, opt=opt)
    out = dict(b1=kmod.launches, b2=kmod.spmm_launches, plain=plain[0],
               its=res.iterations, converged=bool(res.converged.all()),
               rel=checked_residual(state, f, res), decomposition=t_dec,
               factorize=sch.timings["factorize"],
               inv_bytes=state.solver.factor.numel()
               * state.solver.factor.element_size(),
               n_max=sch.n_max, ndiag=len(state.A.offsets),
               dtype=str(state.A.values.dtype).split(".")[1])
    if reps:
        best, times, _ = timed(lambda: solve(state, f, opt=opt), reps=reps,
                               warmup=1)
        # the pieces of an iteration, back to back: one local solve (the
        # bmm over the inverses), one apply (solve and scaled exchange),
        # one gmv (B1 and the exchange)
        out.update(best=best, times=times,
                   solve_ms=events_ms(lambda: state.solver.solve(f), 5, 3),
                   apply_ms=events_ms(lambda: apply(state, f), 5, 3),
                   gmv_ms=events_ms(lambda: gmv(state, f), 20))
    out["peak"] = torch.cuda.max_memory_allocated()
    return out, state, f


def helm_report(label, r, t_gen=None):
    solve_txt = "" if "best" not in r else (
        f"; solve best of 3 after a warm-up {r['best']:.4f} s ("
        + ", ".join(f"{t:.4f}" for t in r["times"])
        + f"), {r['best'] / r['its'] * 1e3:.3f} ms per iteration: one "
        f"local solve {r['solve_ms']:.3f} ms ("
        f"{r['inv_bytes'] / r['solve_ms'] / 1e9:.2f} TB/s over the "
        f"inverses), one apply {r['apply_ms']:.3f} ms, one gmv "
        f"{r['gmv_ms']:.3f} ms (back to back)")
    print(f"  {label}: {r['its']} iterations (converged: {r['converged']}), "
          f"recomputed rel. residual {r['rel']:.3e}{solve_txt}; setup "
          + (f"generate {t_gen:.3f} s, " if t_gen is not None else "")
          + f"decomposition {r['decomposition']:.3f} s, inverses "
          f"{r['factorize']:.3f} s ({r['inv_bytes'] / 1e9:.2f} GB, n_max "
          f"{r['n_max']}, {r['dtype']}, {r['ndiag']} diagonals); peak "
          f"{r['peak'] / 2**30:.2f} GiB; dia_spmv launches {r['b1']}, "
          f"dia_spmm {r['b2']}, plain-version calls on the card "
          f"{r['plain']}")


def dia_complex_record(name, A, launches, mu=1):
    """B1 (mu = 1) or B2 in complex128 on a model's DIA operator A: the
    kernel against its plain version on a random x, bitwise, then kernel,
    plain version and torch.sparse.mm (the block-diagonal complex CSR)
    timed with the L2 flushed, beside the bound: S n (nd + 2 mu) 16 bytes
    and 8 real flops per stored nonzero and right-hand side."""
    import torch
    from hpddm_tpu_torch.examples.library_ops import dia_csr
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.timing import cold_events_ms

    offs, vals = A.offsets, A.values
    S, nd, n = vals.shape
    rng = np.random.default_rng(nd + mu)
    shape = (S, n) if mu == 1 else (S, n, mu)
    x = torch.complex(*(torch.as_tensor(rng.normal(size=shape), device="cuda")
                        for _ in range(2)))
    fn = kmod.dia_spmv if mu == 1 else kmod.dia_spmm
    y, ref = fn(vals, x, offs), kmod.dia_spmv_reference(vals, x, offs)
    check(torch.equal(y, ref), f"{name}: kernel differs from plain")
    err = float((y - ref).abs().max())
    k_ms = cold_events_ms(lambda: fn(vals, x, offs))
    p_ms = cold_events_ms(lambda: kmod.dia_spmv_reference(vals, x, offs))
    b_ms, b_by = bound((vals.numel() + 2 * x.numel()) * 16,
                       8 * int(torch.count_nonzero(vals)) * mu,
                       torch.float64)
    lib = library_ms(dia_csr(vals, offs), x.reshape(S * n, mu))
    print(f"  {name} (S={S}, nd={nd}, n={n}, mu={mu}, complex128): kernel "
          f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, torch.sparse.mm "
          + ("not timed" if lib is None else f"{lib * 1e3:.2f} us")
          + f" (L2 flushed); bound {b_ms * 1e3:.2f} us ({b_by}) = "
          f"{100 * b_ms / k_ms:.1f}% of the kernel's time; bitwise equal to "
          f"plain; {launches} launches on the path")
    return kernel_record(name, "hpddm_tpu_torch/csrc/dia_spmv.cu",
                         "hpddm_tpu/ops/pallas_spmv.py:"
                         + ("98" if mu == 1 else "167"), launches, err,
                         k_ms, p_ms, b_ms, b_by, lib)


def release():
    """Return the card's cached blocks once the caller has dropped its
    references (the next cell's inverses need the room)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_helmholtz():
    """Phase 21: Helmholtz with ORAS on optimized local matrices
    (models/helmholtz.py, examples/helmholtz.py), native complex128 and the
    real pair. (a) The anchors at 60x60, S=4, k=6, eps=0, tol 1e-6,
    GMRES(200), max_it 500: c128 ORAS, SORAS and the real pair in f64 and
    f32 within 2 of the CPU counts (``helmholtz.ANCHOR_ITS``), c128 RAS
    above ORAS, recomputed residuals <= 1e-5 (f32 <= 1e-4, its floor
    here). (b) The full cell (``HELM_*``): ORAS in native c128 and in the
    real pair f64 (tol 1e-6, max_it 1000), each with setup by phase,
    solve (best of 3), inverse bytes, peak memory, B1 launches and
    plain-version calls (0); c128 within 2 of ``HELM_FULL_ITS``, both
    residuals <= 1e-5, peak < 80 GB; reported only: c128 RAS at eps=0.3
    and c128 ORAS at eps=0 (capped at 1000). (c) The twin's recycling
    sweep at the full cell (3 wavenumbers, GMRES(200) and GCRODR
    recycle 10 on each k's setup): GCRODR at most GMRES + 10. (d) Four
    random c128 right-hand sides on (b)'s state, pseudo-block GMRES: B2
    launches, every column's residual <= 1e-5. Returns the kernel
    records of the path."""
    import torch
    from hpddm_tpu_torch.examples import helmholtz as hz
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.parallel.ops import scaled_exchange
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import timed

    print("phase 21: Helmholtz, ORAS with optimized local matrices "
          "(helmholtz.generate; native complex128 and the real pair)")
    # (a) the anchors
    runs = {}
    for case, as_real, dt, method in (
            ("oras", False, np.complex128, "oras"),
            ("soras", False, np.complex128, "soras"),
            ("real pair f64", True, np.complex128, "oras"),
            ("real pair f32", True, np.complex64, "oras"),
            ("ras", False, np.complex128, "ras")):
        gen, _ = hz.problem(4, 60, 6.0, 0.0, as_real=as_real, dtype=dt)
        r, state, f = helm_solve(gen, method=method,
                                 optimized=method != "ras", max_it=500,
                                 reps=0)
        runs[case] = r
        print(f"  (a) 60x60, S=4, k=6, eps=0, {case}: {r['its']} iterations"
              f" (CPU {hz.ANCHOR_ITS.get(case, 'not gated')}), recomputed "
              f"rel. residual {r['rel']:.3e}, {r['dtype']}, n_max "
              f"{r['n_max']}, {r['ndiag']} diagonals")
        del state, f
        release()
    for case, want in hz.ANCHOR_ITS.items():
        check(abs(runs[case]["its"] - want) <= 2,
              f"{case}: {runs[case]['its']} iterations, not within 2 of {want}")
        check(runs[case]["rel"] <= (1e-4 if case.endswith("f32") else 1e-5),
              f"{case}: recomputed rel. residual {runs[case]['rel']:.3e}")
    check(runs["ras"]["its"] > runs["oras"]["its"],
          f"RAS {runs['ras']['its']} not above ORAS {runs['oras']['its']}")

    # (b) the full cell, native c128
    cell = f"{HELM_N}x{HELM_N}, S={HELM_S}, k={HELM_K}, eps={HELM_EPS}"
    gen, t_gen = hz.problem(HELM_S, HELM_N, HELM_K, HELM_EPS)
    nat, state, f = helm_solve(gen)
    helm_report(f"(b) {cell}, ORAS native complex128", nat, t_gen)
    check(abs(nat["its"] - HELM_FULL_ITS) <= 2, f"native ORAS: {nat['its']} "
          f"iterations, not within 2 of {HELM_FULL_ITS}")

    # (d) four random c128 sources on (b)'s state: pseudo-block GMRES
    rng = np.random.default_rng(21)
    B = torch.complex(*(torch.as_tensor(rng.normal(size=(
        HELM_S, state.dec.n_max, 4)), device="cuda") for _ in range(2)))
    B = scaled_exchange(state.dec, B * (torch.abs(f) > 0))
    opt4 = Options(schwarz_method="oras", tol=1e-6, max_it=1000,
                   gmres_restart=200)
    plain = count_plain_calls()
    kmod.launches = kmod.spmm_launches = 0
    plain[0] = 0
    res4 = solve(state, B, opt=opt4)
    b2_four, plain4 = kmod.spmm_launches, plain[0]
    rel4 = checked_residual_per_rhs(state, B, res4)
    best4, times4, _ = timed(lambda: solve(state, B, opt=opt4), reps=3,
                             warmup=1)
    print(f"  (d) four random complex128 sources, pseudo-block GMRES(200): "
          f"iterations per RHS {res4.it_per_rhs.tolist()}, recomputed rel. "
          f"residual per RHS {', '.join(f'{r:.3e}' for r in rel4)}; solve "
          f"best of 3 after a warm-up {best4:.4f} s ("
          + ", ".join(f"{t:.4f}" for t in times4)
          + f"), {best4 / 4:.4f} s per RHS against (b)'s single-RHS solve "
          f"{nat['best']:.4f} s; dia_spmm launches {b2_four}, plain-version "
          f"calls on the card {plain4}")
    check(max(rel4) <= 1e-5 and bool(res4.converged.all()),
          f"four sources: residuals {rel4}")
    check(b2_four > 0 and plain4 == 0,
          f"four sources: dia_spmm launches {b2_four}, plain calls {plain4}")
    recs = [dia_complex_record("dia_spmv c128 Helmholtz path (nd=5)",
                               state.A, nat["b1"]),
            dia_complex_record("dia_spmm c128 Helmholtz four sources (nd=5,"
                               " mu=4)", state.A, b2_four, mu=4)]
    del state, f, B, res4
    release()

    # c128 RAS at eps=0.3, reported
    ras, state, f = helm_solve(gen, method="ras", optimized=False, reps=0)
    helm_report(f"(b) {cell}, RAS native complex128 (reported)", ras)
    del state, f, gen
    release()

    # (b) the real pair f64
    gen, t_gen_r = hz.problem(HELM_S, HELM_N, HELM_K, HELM_EPS, as_real=True)
    pair, state, f = helm_solve(gen)
    helm_report(f"(b) {cell}, ORAS real pair float64", pair, t_gen_r)
    recs.append(dia_model_record(
        f"dia_spmv real pair Helmholtz path (nd={pair['ndiag']})", state.A,
        pair["b1"]))
    del state, f, gen
    release()
    for name, r in (("native c128", nat), ("real pair f64", pair)):
        check(r["rel"] <= 1e-5, f"{name}: recomputed rel. residual "
              f"{r['rel']:.3e}")
        check(r["peak"] < 80e9, f"{name}: peak {r['peak'] / 1e9:.1f} GB")
        check(r["b1"] > 0 and r["plain"] == 0, f"{name}: dia_spmv launches "
              f"{r['b1']}, plain-version calls {r['plain']}")
    pays = "native complex128" if nat["best"] < pair["best"] \
        else "the real pair"
    print(f"  route: native c128 {nat['best']:.4f} s ({nat['its']} "
          f"iterations, {nat['best'] / nat['its'] * 1e3:.3f} ms each, "
          f"inverses {nat['inv_bytes'] / 1e9:.2f} GB) against the real pair "
          f"{pair['best']:.4f} s ({pair['its']} iterations, "
          f"{pair['best'] / pair['its'] * 1e3:.3f} ms each, "
          f"{pair['inv_bytes'] / 1e9:.2f} GB): {pays} pays, "
          f"{max(nat['best'], pair['best']) / min(nat['best'], pair['best']):.2f}"
          "x per solve")

    # undamped at full size, reported (one-level ORAS is not expected to
    # converge there: no Helmholtz coarse space)
    gen, _ = hz.problem(HELM_S, HELM_N, HELM_K, 0.0)
    und, state, f = helm_solve(gen, reps=0)
    helm_report(f"(b) {HELM_N}x{HELM_N}, S={HELM_S}, k={HELM_K}, eps=0, "
                "ORAS native complex128 (reported, cap 1000)", und)
    del state, f, gen
    release()

    # (c) the recycling sweep of the twin
    base = dict(schwarz_method="oras", tol=1e-6, max_it=1000,
                gmres_restart=200)
    t = time.perf_counter()
    totals, records, ok = hz.sweep(
        HELM_S, HELM_N, hz.wavenumbers(HELM_K, 3), HELM_EPS,
        [Options(krylov_method="gmres", **base),
         Options(krylov_method="gcrodr", recycle=10, **base)],
        torch.device("cuda"), log=lambda msg: print(f"    {msg}"))
    torch.cuda.synchronize()
    print(f"  (c) sweep -N {HELM_S} -Nx {HELM_N} -k {HELM_K} -eps "
          f"{HELM_EPS} -sweep 3: GMRES(200) total {totals[0]}, GCRODR(200, "
          f"10) total {totals[1]}; {time.perf_counter() - t:.1f} s with the "
          "three setups")
    check(ok, "sweep: a recomputed residual above 1e-2")
    check(totals[1] <= totals[0] + 10,
          f"GCRODR total {totals[1]} above GMRES {totals[0]} + 10")
    return recs


def phase_slice_5a(cell, dia_rec, grid):
    """Phase 22: slice 5a on the card. (a) the JAX package's production
    unstructured configuration, the interface-first layout with RCM
    banded factors and Lanczos GenEO on phase 8's mesh (phase 13 (b) in
    that layout), and the layout with phase 8's dense-GenEO vectors and
    inv; (b) the reuse sequence on phase 5's setup; (c) exchange_matrices
    and restriction at 1024x1024/16; (d) the bf16 operator mirror on
    phase 14's 2048x2048/16 GMV cell in f32; (e) the small options at the
    oracle size against their CPU twins. Returns the B4 record of (a)'s
    path and the B1 record of (b)'s."""
    print("phase 22: slice 5a (interface-first layout, reuse, matrix "
          "exchange and POU restriction, bf16 operator mirror, GenEO "
          "estimate, dumps)")
    recs = [phase_22a(cell)]
    recs.append(phase_22b(grid, dia_rec))
    phase_22c()
    phase_22d()
    phase_22e()
    return recs


def phase_22a(cell):
    import torch
    from hpddm_tpu_torch.examples.library_ops import ell_csr
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.parallel import pexchange as pk
    from hpddm_tpu_torch.parallel.ops import exchange
    from hpddm_tpu_torch.precond.schwarz import (Schwarz, apply, deflation,
                                                 gmv)
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import cold_events_ms, events_ms, timed

    gen, f, sch8 = cell["gen"], cell["f"], cell["sch"]
    S = len(gen.n_loc)
    print(f"  (a) the production unstructured configuration: phase 8's "
          f"512x512 mesh, S={S}, renumber=True, local_solver=banded (RCM), "
          "Lanczos GenEO nu=10, deflated GMRES, f64, tol 1e-6")
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for mod in (ek, pk):                        # the path's counts from here
        mod.launches = 0
        mod.launches_by_mu.clear()
    plain[0] = 0
    opt = Options(schwarz_coarse_correction="deflated", geneo_nu=10,
                  local_solver="banded", tol=1e-6)
    t = time.perf_counter()
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt, renumber=True, device="cuda")
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    sch.solve_gevp(gen.neumann)
    state = sch.build()
    best, times, res = timed(lambda: solve(state, f, opt=opt), reps=3,
                             warmup=1)
    launches = (ek.launches, pk.launches)      # read just after the path
    by_mu = dict(ek.launches_by_mu)
    plain_calls = plain[0]
    peak = torch.cuda.max_memory_allocated()
    rel = checked_residual(state, f, res)
    true_rel = true_residual(gen, res.x)
    its, want = res.iterations, cell["its_b"]
    dec = state.dec
    tm = sch.timings
    print(f"    n_max {dec.n_max}, m_max {dec.m_max} (the interface block), "
          f"k_max {dec.k_max}, ELL width {state.A.values.shape[1]}, RCM "
          f"bandwidths max {max(sch.rcm_bandwidths)} / min "
          f"{min(sch.rcm_bandwidths)}, pexchange plan: "
          f"{dec.pexch is not None}")
    print(f"    {its} iterations (phase 13 (b), caller numbering: {want}), "
          f"recomputed rel. residual {rel:.3e}, true global rel. residual "
          f"{true_rel:.3e}; solve best of 3 {best:.4f} s "
          f"({', '.join(f'{x:.4f}' for x in times)}), "
          f"{best / its * 1e3:.3f} ms per iteration")
    print(f"    setup seconds: decomposition + permuted packing {t_dec:.3f}, "
          + ", ".join(f"{k} {v:.3f}" for k, v in tm.items()))
    print(f"    peak device memory {peak / 2**30:.2f} GiB, "
          f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB "
          "held by earlier phases")
    print(f"    launches on this path: ell_spmv (B4) {launches[0]} (by the "
          f"panel width {by_mu}), pexchange (B5) {launches[1]}; "
          f"plain-version calls on the card {plain_calls}")
    check(abs(its - want) <= 1, f"renumbered production configuration: "
          f"{its} iterations, phase 13 (b) {want}")
    check(rel <= 1e-5 and true_rel <= 1e-5,
          f"(a) residuals {rel:.3e} / {true_rel:.3e}")
    check(launches[0] > 0 and launches[1] == 0,
          f"(a) launches B4 {launches[0]}, B5 {launches[1]}")
    check(plain_calls == 0, f"{plain_calls} plain-version calls on the card")

    # B4 on the interface-first batch (its columns lose the RCM locality
    # of the caller's numbering): against its plain version, bitwise, and
    # timed beside its bound and torch.sparse.mm
    A = state.A
    rng = np.random.default_rng(22)
    x1 = torch.as_tensor(rng.normal(size=(S, dec.n_max, 1)), device="cuda")
    y = ek.ell_spmv(A.values, A.cols, x1, A.payload)
    ref = ek.ell_spmv_payload_reference(A.values, A.payload, x1)
    err4 = float((y - ref).abs().max())
    check(torch.equal(y, ref), "ell_spmv differs from plain on the "
          "interface-first batch")
    k4 = cold_events_ms(lambda: ek.ell_spmv(A.values, A.cols, x1, A.payload))
    p4 = cold_events_ms(lambda: ek.ell_spmv_payload_reference(
        A.values, A.payload, x1), reps=10)
    l4 = library_ms(ell_csr(A.values, A.cols), x1.reshape(-1, 1))
    nnz = int(torch.count_nonzero(A.values))
    b4_ms, b4_by = bound(
        nnz * (x1.element_size() + A.payload.cols.element_size()) +
        2 * x1.numel() * x1.element_size(), 2 * nnz, x1.dtype)
    print(f"    ell_spmv (B4) on the interface-first batch (S={S}, w="
          f"{A.values.shape[1]}, n={dec.n_max}) f64, mu=1: kernel "
          f"{k4 * 1e3:.2f} us, plain {p4 * 1e3:.2f} us, torch.sparse.mm "
          + ("not timed" if l4 is None else f"{l4 * 1e3:.2f} us")
          + f" (L2 flushed); bound {b4_ms * 1e3:.2f} us ({b4_by}); bitwise "
          f"equal to plain")
    rec = kernel_record("ell_spmv renumbered production path",
                        "hpddm_tpu_torch/csrc/ell_spmv.cu",
                        "hpddm_tpu/ops/pallas_ell.py:133", launches[0], err4,
                        k4, p4, b4_ms, b4_by, l4)

    # the layout against caller numbering: the exchange and the gmv at
    # mu = 1 and 4, B5 on phase 8's caller-numbered decomposition (as
    # tools/bench_unstructured.py:113-122 times the JAX package's)
    st8 = sch8.operator_state()
    xa = torch.as_tensor(rng.normal(size=(S, dec.n_max, 1)), device="cuda")
    t_apply = events_ms(lambda: apply(state, xa), 20)
    t_local = events_ms(lambda: state.solver.solve(xa), 20)
    t_defl = events_ms(lambda: deflation(state, xa), 20)
    print(f"    one iteration's pieces at mu=1 (back to back): apply "
          f"{t_apply * 1e3:.1f} us, of which the banded local solve "
          f"{t_local * 1e3:.1f} us and a deflation {t_defl * 1e3:.1f} us")
    for mu in (1, 4):
        x = torch.as_tensor(rng.normal(size=(S, dec.n_max, mu)),
                            device="cuda")
        t_ren = events_ms(lambda: exchange(dec, x), 50)
        t_b5 = events_ms(lambda: pk.pexchange(sch8.dec.pexch, x), 50)
        t_g = events_ms(lambda: gmv(state, x), 50)
        t_g8 = events_ms(lambda: gmv(st8, x), 50)
        print(f"    mu={mu}: exchange renumbered {t_ren * 1e3:.2f} us, B5 on "
              f"phase 8's caller numbering {t_b5 * 1e3:.2f} us; gmv "
              f"renumbered {t_g * 1e3:.2f} us, caller numbering (B4 + B5) "
              f"{t_g8 * 1e3:.2f} us (back to back, best of 5 x 50)")
    # the renumbered exchange on the card against the CPU's, bitwise
    from hpddm_tpu_torch.parallel.decomposition import Decomposition
    dec_cpu = Decomposition.from_subdomains(
        gen.neighbors, gen.mappings, gen.n_loc, d=gen.d, renumber=True,
        device="cpu")
    same = torch.equal(exchange(dec, x).cpu(), exchange(dec_cpu, x.cpu()))
    print(f"    renumbered exchange at mu=4 bitwise equal to the CPU's: "
          f"{same}")
    check(same, "the renumbered exchange differs between card and CPU")
    del dec_cpu

    # phase 8's dense-GenEO vectors handed in (caller numbering) with inv
    del state
    opt2 = Options(schwarz_coarse_correction="deflated", geneo_nu=10,
                   tol=1e-6)
    sch2 = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                   options=opt2, renumber=True, device="cuda")
    sch2.set_vectors(cell["dense_vecs"])
    st2 = sch2.build()
    res2 = solve(st2, f, opt=opt2)
    rel2 = checked_residual(st2, f, res2)
    true2 = true_residual(gen, res2.x)
    print(f"    with phase 8's dense-GenEO vectors (set_vectors) and inv: "
          f"{res2.iterations} iterations (phase 8: {cell['its']}), "
          f"recomputed rel. residual {rel2:.3e}, true global rel. residual "
          f"{true2:.3e}; setup seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in sch2.timings.items()))
    check(abs(res2.iterations - cell["its"]) <= 1 and rel2 <= 1e-5 and
          true2 <= 1e-5, f"renumbered inv on phase 8's vectors: "
          f"{res2.iterations} iterations, residuals {rel2:.3e}/{true2:.3e}")
    del st2, sch2, sch
    return rec


def phase_22b(grid, dia_rec):
    import torch
    from hpddm_tpu_torch.core.csr import MatrixCSR
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.krylov import solve

    sch, f, want, t5 = (grid.pop(k) for k in ("sch", "f", "its", "timings"))
    print("  (b) the reuse sequence: phase 5's setup (512x512, S=64, nu=10, "
          "inv, deflated, f64) with reuse_preconditioner=1, three systems "
          "scaled by 1.001, 1.002, 1.003")
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    opt = Options(schwarz_coarse_correction="deflated", geneo_nu=10,
                  reuse_preconditioner=1, tol=1e-6)
    sch.opt = opt
    base = list(sch.mats)
    kmod.launches = kmod.spmm_launches = 0      # the path's counts from here
    plain[0] = 0
    t = time.perf_counter()
    state0 = sch.build()                        # the factorization kept
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t
    lines, ok = [], True
    for c in (1.001, 1.002, 1.003):
        t = time.perf_counter()
        sch.update_matrices([MatrixCSR(m.scipy() * c) for m in base])
        st = sch.build()
        torch.cuda.synchronize()
        t_re = time.perf_counter() - t
        res = solve(st, f, opt=opt)
        rel = checked_residual(st, f, res)
        same = st.solver is state0.solver and st.coarse is state0.coarse
        ok = ok and same and rel <= 1e-5 and abs(res.iterations - want) <= 2
        lines.append(f"    x{c}: update_matrices + build {t_re:.3f} s, "
                     f"factorization reused: {same}, {res.iterations} "
                     f"iterations (phase 5: {want}), recomputed rel. "
                     f"residual {rel:.3e}")
    launches, plain_calls = kmod.launches, plain[0]
    print(f"    full build (inv factors + coarse operator on the kept "
          f"GenEO vectors) {t_full:.3f} s; phase 5's setup: "
          + ", ".join(f"{k} {v:.3f}" for k, v in t5.items()))
    print("\n".join(lines))
    print(f"    dia_spmv (B1) launches on the sequence {launches}, "
          f"dia_spmm {kmod.spmm_launches} (the one full build's coarse "
          f"panel); plain-version calls on the card {plain_calls}")
    check(ok, "the reuse sequence failed its gates:\n" + "\n".join(lines))
    check(launches > 0 and plain_calls == 0,
          f"(b) B1 launches {launches}, plain calls {plain_calls}")
    del state0, st, sch
    return banded_record(dia_rec, "dia_spmv reuse sequence path", launches)


def phase_22c():
    import torch
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz

    S, N = 16, 1024
    t = time.perf_counter()
    gen = diffusion2d.generate_uniform(S, N, N, overlap=2)
    t_gen = time.perf_counter() - t
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options(), device="cuda")
    t = time.perf_counter()
    sch.exchange_matrices()
    torch.cuda.synchronize()
    t_ex = time.perf_counter() - t
    t = time.perf_counter()
    changed = sch.restriction()
    torch.cuda.synchronize()
    t_rs = time.perf_counter() - t
    d = sch.dec.unpermute(sch.dec.d).cpu().numpy()
    dsum = np.zeros(N * N)
    boolean = True
    for s, (i0, i1, j0, j1) in enumerate(gen.boxes):
        vals = d[s, : gen.n_loc[s]]
        boolean = boolean and bool(np.all((vals == 0) | (vals == 1)))
        jj, ii = np.meshgrid(np.arange(j0, j1), np.arange(i0, i1),
                             indexing="ij")
        np.add.at(dsum, (jj * N + ii).ravel(), vals)
    print(f"  (c) exchange_matrices + restriction at generate_uniform({S}, "
          f"{N}, {N}, overlap=2): generation {t_gen:.2f} s, "
          f"exchange_matrices {t_ex:.2f} s, restriction {t_rs:.2f} s (the "
          f"JAX package's budget for the two: 120 s); POU changed "
          f"{changed}, boolean {boolean}, per-dof sum in "
          f"[{dsum.min():g}, {dsum.max():g}]")
    check(t_ex + t_rs < 120.0, f"(c) {t_ex + t_rs:.1f} s over 120 s")
    check(changed and boolean and np.all(dsum == 1.0),
          "(c) the rounded POU is not a boolean partition of unity")
    del sch, gen


def phase_22d():
    import torch
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz, gmv
    from hpddm_tpu_torch.timing import cold_events_ms, events_ms

    S, N = 16, 2048
    gen = diffusion2d.generate_uniform(S, N, N, overlap=1, dtype=np.float32)
    st = {}
    for name, kw in (("f32", {}), ("bf16", dict(gmv_dtype="bfloat16"))):
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=Options(**kw), device="cuda")
        sch.set_grid_geometry(gen.boxes, N, N)
        st[name] = sch.operator_state()
    del gen, sch
    A, Ab = st["f32"].A, st["bf16"].A
    check(Ab.values_lp is not None and Ab.values_lp.dtype == torch.bfloat16
          and Ab.canvas_hw is not None, "(d) no bf16 mirror on the canvas")
    x = torch.as_tensor(np.random.default_rng(23).normal(
        size=(S, A.values.shape[2], 1)).astype(np.float32), device="cuda")
    yb = gmv(st["bf16"], x)
    y32 = gmv(st["f32"], x)
    rel = float(torch.linalg.norm((yb - y32).double())
                / torch.linalg.norm(y32.double()))
    g_bf = events_ms(lambda: gmv(st["bf16"], x), 50)
    g_32 = events_ms(lambda: gmv(st["f32"], x), 50)
    xs = x[:, :, 0].contiguous()
    s_bf = cold_events_ms(lambda: kmod.dia_spmv_reference(
        Ab.values_lp, xs, Ab.offsets))
    s_32 = cold_events_ms(lambda: kmod.dia_spmv(A.values, xs, A.offsets))
    by_bf = Ab.values_lp.numel() * 2 + 2 * xs.numel() * 4
    by_32 = A.values.numel() * 4 + 2 * xs.numel() * 4
    print(f"  (d) -hpddm_gmv_dtype bfloat16 on the 2048x2048/16 GMV cell "
          f"(f32, slab exchange, canvas), a parity and timing check outside "
          f"the main path: no kernel reads the bf16 mirror yet (ROADMAP "
          f"queue B follow-up 8), so its product takes the plain DIA form "
          f"as the JAX package routes it; relative difference from the "
          f"full-precision gmv {rel:.3e}")
    print(f"    gmv {g_bf * 1e3:.2f} us (bf16 mirror, plain form) against "
          f"{g_32 * 1e3:.2f} us (B1 on f32 values), back to back; the SpMV "
          f"alone with the L2 flushed: plain bf16 {s_bf * 1e3:.2f} us, B1 "
          f"f32 {s_32 * 1e3:.2f} us; bytes read and written {by_bf / 1e6:.2f}"
          f" MB (bf16 values) against {by_32 / 1e6:.2f} MB (f32 values)")
    check(0 < rel < 1e-2, f"(d) bf16 gmv relative difference {rel:.3e}")
    del st, A, Ab, x, yb, y32


def host_coarse_matrix(state, mats):
    """The state's coarse matrix, reassembled on the host in f64 from its
    public fields by the setup's formula E = sum_s X_s^H D_s (A_s X_s), X
    the exchanged columns D Z, with scipy's products where the card ran
    B1/B2. Caller numbering (a decomposition that is not renumbered)."""
    import torch
    from hpddm_tpu_torch.parallel.ops import exchange

    dec, co = state.dec, state.coarse
    S, nu = dec.S, co.nu_max
    Z = co.Z.to(torch.float64)
    X0 = Z.new_zeros((S, dec.n_max, S * nu))
    for s in range(S):
        X0[s, :, s * nu:(s + 1) * nu] = dec.d[s, :, None] * Z[s]
    X = exchange(dec, X0).cpu().numpy()
    d = dec.d.double().cpu().numpy()
    E = np.zeros((S * nu, S * nu))
    for s, m in enumerate(mats):
        n = m.n
        E += (d[s, :n, None] * X[s, :n]).T @ (m.scipy() @ X[s, :n])
    active = (np.arange(nu)[None, :]
              < co.nu_loc.cpu().numpy()[:, None]).reshape(-1)
    keep = active[:, None] & active[None, :]
    return np.where(keep, E, np.eye(S * nu))


def phase_22e():
    import tempfile

    import torch
    from hpddm_tpu_torch.core.csr import MatrixCSR
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz
    from hpddm_tpu_torch.solvers.krylov import solve

    S, N = 4, 100
    gen = diffusion2d.generate(S, N, N, overlap=1, with_neumann=True)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            opt = Options(schwarz_coarse_correction="deflated", geneo_nu=10,
                          geneo_threshold=0.3, geneo_estimate_nu=1, tol=1e-6,
                          dump_matrices=f"{tmp}/{dev}_mat",
                          dump_eigenvectors=f"{tmp}/{dev}_eig",
                          level_2_dump_matrix=f"{tmp}/{dev}_E.txt")
            sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                          options=opt, device=dev)
            nu = sch.solve_gevp(gen.neumann)
            st = sch.build()
            f = np.zeros((S, sch.n_max, 1))
            for s in range(S):
                f[s, : gen.n_loc[s]] = gen.f[s]
            res = solve(st, torch.as_tensor(f, device=dev), opt=opt)
            out[dev] = (nu, res.iterations, sch, st)
        nu, its, sch, st = out["cuda"]
        print(f"  (e) oracle size (100x100, S=4), geneo_estimate_nu=1 with "
              f"threshold 0.3: counts {nu.tolist()} on the card, "
              f"{out['cpu'][0].tolist()} on the CPU; {its} iterations on "
              f"the card, {out['cpu'][1]} on the CPU")
        check(np.array_equal(nu, out["cpu"][0]) and its == out["cpu"][1],
              "(e) estimate_nu counts or iterations differ from the CPU")
        # the matrices are printed with 16 significant digits (%.15e, the
        # reference's format), the vectors with np.savetxt's 19
        mat_ok = eig_ok = True
        for s in range(S):
            back = MatrixCSR.from_file(f"{tmp}/cuda_mat_{s}.txt").scipy()
            ref = gen.mats[s].scipy()
            mat_ok = mat_ok and (back != 0).nnz == (ref != 0).nnz and \
                abs(back - ref).max() <= 1e-15 * abs(ref).max()
            V = np.loadtxt(f"{tmp}/cuda_eig_{s}.txt", skiprows=2, ndmin=2)
            eig_ok = eig_ok and np.array_equal(V, sch._deflation_vectors[s])
        E = MatrixCSR.from_file(f"{tmp}/cuda_E.txt").scipy().toarray()
        E_h = host_coarse_matrix(st, sch.mats)
        e_err = float(np.abs(E - E_h).max() / np.abs(E_h).max())
        e_ok = E.shape == E_h.shape and e_err <= 1e-13
        print(f"    dumps read back as the state: matrices (to the print's 16 "
              f"digits) {mat_ok}, eigenvectors (exactly) {eig_ok}, E against "
              f"the state's E reassembled on the host in f64 {e_ok} (max "
              f"difference {e_err:.2e} of max|E|, gate 1e-13)")
        check(mat_ok and eig_ok and e_ok,
              "(e) a dump does not read back as its state")
    print("    statistics():\n" + sch.statistics())


def phase_slice_5d():
    """Phase 23: slice 5d + 5e(ii), the DST and Chebyshev local solvers,
    the dense Schwarz variant and the Stokes saddle-point solver:
    (a) the FFT-RAS oracle; (b) the heterogeneous cell of
    examples/hetero.py (dst_cheby), banded on its GenEO vectors and the
    local solvers' times; (c) fft two-level on the constant coefficient;
    (d) the dense variant; (e) MAC Stokes. Returns the kernel records of
    the new paths."""
    t = time.perf_counter()
    print("phase 23: slice 5d + 5e(ii) (DST and Chebyshev local solvers, "
          "dense Schwarz, Stokes saddle point)")
    phase_23a()
    recs = phase_23b()
    phase_23c()
    recs.append(phase_23d())
    recs += phase_23e()
    print(f"  phase 23 in all {time.perf_counter() - t:.1f} s")
    return recs


def phase_23a():
    """(a) One-level FFT-RAS at the oracle (100x100, S=4, matmul DST mode):
    the JAX package's CPU count ``FFT_ORACLE_ITS`` (<= 45), recomputed
    residual <= 1e-2; the fft and matmul modes agree to 1e-10 on the card
    on mixed boxes (overlap 2)."""
    import torch
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.ops import fft_solve as fs
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz

    S, N = 4, 100
    gen = diffusion2d.generate(S, N, N, overlap=1)
    opt = Options(local_solver="fft")
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt, device="cuda")
    sch.set_grid_geometry(gen.boxes, N, N)
    state = sch.build()
    res, rel = solve_checked(state, torch.as_tensor(diffusion2d.padded_rhs(
        gen.f, sch.n_max), device="cuda"), opt, 1e-6)
    gen2 = diffusion2d.generate(S, N, N, overlap=2)
    n_max = max(gen2.n_loc)
    b = torch.as_tensor(np.random.default_rng(23).normal(
        size=(S, n_max, 3)), device="cuda")
    mm, ff = (fs.build_fft_solver(gen2.boxes, N, N, n_max,
                                  dtype=torch.float64, mode=m,
                                  device="cuda") for m in ("matmul", "fft"))
    err = float((mm.solve(b) - ff.solve(b)).abs().max())
    print(f"  (a) FFT-RAS oracle (100x100, S=4, one level, "
          f"{type(state.solver).__name__}): {res.iterations} iterations "
          f"(the JAX package's CPU count {FFT_ORACLE_ITS}), recomputed rel. "
          f"residual {rel:.3e}; fft mode vs matmul mode on mixed boxes "
          f"(mu=3): max abs difference {err:.3e}")
    check(isinstance(state.solver, fs.DSTMatmulSolver)
          and res.iterations == FFT_ORACLE_ITS and rel <= 1e-2,
          f"(a) {res.iterations} iterations, residual {rel:.3e}")
    check(err <= 1e-10, f"(a) fft and matmul modes differ by {err:.3e}")


def local_solver_of(sch, kind):
    """The one-level local solver ``kind`` of a Schwarz setup (its coarse
    correction left out for the build, then restored)."""
    corr = sch.opt.val("schwarz_coarse_correction")
    sch.opt["local_solver"] = kind
    sch.opt.remove("schwarz_coarse_correction")
    try:
        return sch.build().solver
    finally:
        sch.opt["schwarz_coarse_correction"] = corr


def phase_23b():
    """(b) The heterogeneous cell (examples/hetero.py's defaults:
    generate_uniform(16, 1024, 1024), contrast 1e4, Jacobi-scaled,
    dst_cheby k=32, Lanczos GenEO nu=16 with the DST inner solve, bsr,
    deflated, f64, tol 1e-8): its path (GenEO, build, one solve) with the
    launch counts, then the solve timed once after a warm-up; banded on the
    same GenEO vectors; one local solve at mu=1 and 4 of dst_cheby, cheby,
    fft and banded; where a dst_cheby apply spends its time. Gates:
    recomputed residuals <= 1e-8; on the JAX package's bounds
    (``HETERO_JAX_BOUNDS``) within 1 of its count; on the port's start vectors
    of seeds 7, 1, 2, 3 inside the JAX package's converged counts over
    start vectors (``HETERO_JAX_ITS``) widened by 5 below; banded not above
    dst_cheby; B1 launches, no plain-version call. B1's and B2's records
    at the path's shapes (B2 at the bsr panel's nu columns)."""
    import dataclasses

    import torch
    from hpddm_tpu_torch.examples import hetero
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.ops.cheby_solve import build_cheby_solver
    from hpddm_tpu_torch.ops.spmv import spmm
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import compute_residual
    from hpddm_tpu_torch.solvers.krylov import solve
    from hpddm_tpu_torch.timing import events_ms

    S, N = 16, 1024
    opt = Options(tol=1e-8, **hetero.DEFAULTS)
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kmod.launches = kmod.spmm_launches = 0
    plain[0] = 0
    sch, f, phases = hetero.setup(S, N, opt, np.float64, "cuda")
    geneo_launches = (kmod.launches, kmod.spmm_launches)
    state, phases["build"] = hetero.build_timed(sch)
    build_b2 = kmod.spmm_launches - geneo_launches[1]
    launches0 = kmod.launches
    res = solve(state, f, opt=sch.opt)
    solve_b1 = kmod.launches - launches0
    b1, b2, plain_calls = kmod.launches, kmod.spmm_launches, plain[0]
    r = hetero.solve_report(sch, state, f, reps=1)
    peak = torch.cuda.max_memory_allocated()
    sol = state.solver
    print(f"  (b) heterogeneous cell: generate_uniform({S}, {N}, {N}), "
          f"contrast 1e4, Jacobi-scaled, n_max {sch.n_max}, dst_cheby "
          f"k={sol.k}, Lanczos GenEO nu=16, bsr ({type(state.coarse).__name__}"
          f" mode {state.coarse.mode}), deflated, f64, tol 1e-8")
    print("    setup " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                   phases.items()) + "; of which " +
          ", ".join(f"{k} {v:.3f} s" for k, v in sch.timings.items()))
    print(f"    dst_cheby: {r['iterations']} iterations (the JAX package's "
          f"CPU counts by start vector {HETERO_JAX_ITS}), solve {r['solve_s']:.4f} s (one "
          f"solve after two warm-ups), {r['ms_per_it']:.2f} ms per iteration, "
          f"recomputed rel. residual {r['relres']:.3e}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"    launches on the path: dia_spmv (B1) {geneo_launches[0]} in "
          f"GenEO, {solve_b1} in one solve ({solve_b1 / res.iterations:.1f} "
          f"an iteration), {b1} in all; dia_spmm (B2) {geneo_launches[1]} "
          f"in GenEO, {build_b2} in the build (the bsr coarse panel), {b2} "
          f"in all; plain-version calls on the card {plain_calls}")
    check(r["relres"] <= 1e-8 and r["converged"],
          f"(b) dst_cheby residual {r['relres']:.3e}")
    check(solve_b1 > 0 and plain_calls == 0,
          f"(b) B1 launches {solve_b1} in a solve, plain calls "
          f"{plain_calls}")

    # on the JAX package's bounds (its default start vector) the port
    # takes its count on the CPU (tests/test_torch_fft_cheby.py, -m slow)
    # and within one on the card (rounding on a contrast-1e4 system); the
    # port's own start vectors (its default 7 and
    # seeds 1-3) move lo with rounding (ROADMAP C17), and each count stays
    # inside the JAX package's converged counts over start vectors (a
    # count at max_it is none) widened by 5 below
    dt = sol.lo.dtype
    jb = {k: torch.tensor(v, dtype=dt, device="cuda")
          for k, v in HETERO_JAX_BOUNDS.items()}
    st_j = dataclasses.replace(state, solver=dataclasses.replace(sol, **jb))
    res_j = solve(st_j, f, opt=sch.opt)
    nb, nr = compute_residual(st_j, res_j.x, f)
    rel_j = float(nr[0] / nb[0])
    dev = {k: float((getattr(sol, k) / jb[k] - 1).abs().max()) for k in jb}
    max_it = int(sch.opt.val("max_it"))
    conv = [v for v in HETERO_JAX_ITS.values() if v < max_it]
    lo_its, hi_its = min(conv) - 5, max(conv)
    seeds = {7: r["iterations"]}
    for seed in (1, 2, 3):
        other = build_cheby_solver(sol.A, state.dec.row_mask, inner=sol.inner,
                                   k=sol.k, power_its=int(sch.opt.val(
                                       "local_cheby_power_its")), seed=seed)
        seeds[seed] = solve(dataclasses.replace(state, solver=other), f,
                            opt=sch.opt).iterations
    print(f"    dst_cheby on the JAX package's bounds (HETERO_JAX_BOUNDS): "
          f"{res_j.iterations} iterations (its CPU count "
          f"{HETERO_JAX_ITS[7]}), recomputed rel. residual {rel_j:.3e}; the "
          f"port's own bounds against them: max relative difference lo "
          f"{dev['lo']:.3e}, hi {dev['hi']:.3e}; on the port's start vectors "
          f"of seeds 7 (its default), 1, 2, 3: {list(seeds.values())} "
          f"iterations (gate {lo_its}-{hi_its})")
    check(abs(res_j.iterations - HETERO_JAX_ITS[7]) <= 1 and rel_j <= 1e-8,
          f"(b) dst_cheby on the JAX bounds: {res_j.iterations} iterations, "
          f"residual {rel_j:.3e}")
    check(all(lo_its <= v <= hi_its for v in seeds.values()),
          f"(b) dst_cheby counts by start vector {seeds}, gate "
          f"{lo_its}-{hi_its}")

    # banded on the same GenEO vectors and coarse operator
    t = time.perf_counter()
    banded = local_solver_of(sch, "banded")
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t
    state_b = dataclasses.replace(state, solver=banded)
    rb = hetero.solve_report(sch, state_b, f, reps=3)
    print(f"    banded on the same vectors: {rb['iterations']} iterations, "
          f"solve {rb['solve_s']:.4f} s ({rb['ms_per_it']:.2f} ms per "
          f"iteration), recomputed rel. residual {rb['relres']:.3e}; factor "
          f"{t_b:.2f} s, {factor_txt(banded)}; dst_cheby keeps no factor "
          f"(its operator and DST tables {cheby_bytes(sol) / 1e6:.2f} MB). "
          f"The rule dst_cheby <= banded + 5 (tests/test_cheby.py:51's) "
          f"{'holds' if r['iterations'] <= rb['iterations'] + 5 else 'fails'}"
          f" ({r['iterations']} vs {rb['iterations']})")
    check(rb["relres"] <= 1e-8 and rb["iterations"] <= r["iterations"],
          f"(b) banded {rb['iterations']} iterations, residual "
          f"{rb['relres']:.3e}")

    # one local solve per apply, warm-up 1, best of 3 (CUDA events)
    cheby = local_solver_of(sch, "cheby")
    fft = local_solver_of(sch, "fft")
    rng = np.random.default_rng(231)
    times = {}
    for name, solver in (("dst_cheby", sol), ("cheby", cheby),
                         ("fft", fft), ("banded", banded)):
        for mu in (1, 4):
            x = torch.as_tensor(rng.normal(size=(S, sch.n_max, mu)),
                                device="cuda") * state.dec.d[:, :, None]
            times[name, mu] = events_ms(lambda: solver.solve(x), reps=1,
                                        blocks=3)
    print("    one local solve (warm-up 1, best of 3, CUDA events): " +
          "; ".join(f"{k} mu={mu} {v:.3f} ms" for (k, mu), v in
                    times.items()))

    # where a dst_cheby apply spends its time: k + 1 DST solves, k B1
    # products and the recursion's element-wise work
    x = torch.as_tensor(rng.normal(size=(S, sch.n_max, 1)), device="cuda")
    t_dst = events_ms(lambda: sol.inner.solve(x), reps=5, blocks=3)
    t_b1 = events_ms(lambda: spmm(sol.A, x), reps=5, blocks=3)
    wall, busy = device_busy_ms(lambda: sol.solve(x))
    k = sol.k
    print(f"    a dst_cheby apply (k={k}, mu=1): wall {wall:.3f} ms, device "
          f"busy " + ("not measured" if busy is None else
                      f"{busy:.3f} ms ({100 * busy / wall:.1f}%)")
          + f"; one DST solve {t_dst:.3f} ms x {k + 1} = "
          f"{(k + 1) * t_dst:.3f} ms, one B1 product {t_b1 * 1e3:.2f} us x "
          f"{k} = {k * t_b1:.3f} ms (back to back); an iteration "
          f"{r['ms_per_it']:.2f} ms")
    out = [dia_model_record("dia_spmv hetero dst_cheby path (1024^2/16)",
                            state.A, solve_b1),
           dia_model_record("dia_spmm hetero bsr coarse panel", state.A,
                            build_b2, mu=state.coarse.nu_max)]
    del state, state_b, sch, banded, cheby, fft, sol, f
    return out


def cheby_bytes(sol):
    """Bytes a Chebyshev solver keeps: its operator's values, the scaling
    or Jacobi diagonal, the bounds and the DST solver's tables."""
    import torch

    ts = [sol.A.values, sol.scale, sol.dinv, sol.lo, sol.hi]
    for v in (vars(sol.inner) if sol.inner is not None else {}).values():
        ts += list(v) if isinstance(v, tuple) else [v]
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def phase_23c():
    """(c) fft two-level on the constant coefficient (generate_uniform(16,
    1024, 1024), kappa=None, unscaled: the DST solve of an inner box is
    exact; Lanczos GenEO nu=16 with the DST inner solve, bsr, deflated,
    f64, tol 1e-8), beside banded on the same vectors. Gates: recomputed
    residuals <= 1e-8, each solve converged."""
    import dataclasses

    import torch
    from hpddm_tpu_torch.examples import hetero
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz

    S, N = 16, 1024
    torch.cuda.empty_cache()
    t = time.perf_counter()
    gen = diffusion2d.generate_uniform(S, N, N, overlap=1,
                                       with_neumann=True)
    t_gen = time.perf_counter() - t
    opt = Options(tol=1e-8, **hetero.DEFAULTS)
    opt["local_solver"] = "fft"
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt, device="cuda")
    sch.set_grid_geometry(gen.boxes, N, N)
    sch.solve_gevp(gen.neumann, method="lanczos")
    state, t_build = hetero.build_timed(sch)
    f = torch.as_tensor(diffusion2d.padded_rhs(gen.f, sch.n_max),
                        device="cuda")
    rf = hetero.solve_report(sch, state, f, reps=1)
    banded = local_solver_of(sch, "banded")
    rb = hetero.solve_report(sch, dataclasses.replace(state, solver=banded),
                             f, reps=1)
    print(f"  (c) fft two-level, constant coefficient (1024^2/16, unscaled, "
          f"{type(state.solver).__name__}): generate {t_gen:.3f} s, setup "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sch.timings.items())
          + f", build {t_build:.3f} s")
    for name, r in (("fft", rf), ("banded", rb)):
        print(f"    {name}: {r['iterations']} iterations, solve "
              f"{r['solve_s']:.4f} s ({r['ms_per_it']:.2f} ms per "
              f"iteration), recomputed rel. residual {r['relres']:.3e}, "
              f"converged {r['converged']}")
    check(max(rf["relres"], rb["relres"]) <= 1e-8 and rf["converged"]
          and rb["converged"], f"(c) residuals fft {rf['relres']:.3e}, "
          f"banded {rb['relres']:.3e}")
    del state, sch, banded, f


def phase_23d():
    """(d) The dense Schwarz variant: one level at generate(16, 256, 256)
    (n_max 4,356) with the dense blocks' bmm gmv and with the port's sparse
    ``Schwarz.gmv`` (B1) as the user GMV, equal counts; the standard-EVP
    coarse space (nu=5, deflated) at the test size (30x30, S=4) on the card
    and on the host CPU, equal counts. GMRES(60), tol 1e-8. Returns B1's
    record of the user-GMV path."""
    import torch
    from hpddm_tpu_torch.models import diffusion2d
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond import schwarz as sz
    from hpddm_tpu_torch.precond.dense import DenseSchwarz
    from hpddm_tpu_torch.solvers.gmres import gmres

    def run(gen, opts, user, device, evp=False):
        ds = DenseSchwarz([m.dense() for m in gen.mats], gen.neighbors,
                          gen.mappings, d=gen.d, options=Options(**opts),
                          user_gmv=user, device=device)
        if evp:
            ds.solve_evp()
        t = time.perf_counter()
        op = ds.build()
        f = torch.as_tensor(diffusion2d.padded_rhs(gen.f, ds.n_max),
                            device=device)
        res = gmres(op, f, tol=1e-8, restart=60, max_it=200)
        r = f - op.gmv(res.x)
        w = ds.dec.d[:, :, None]
        rel = float(torch.sqrt(torch.sum(w * r ** 2))
                    / torch.sqrt(torch.sum(w * f ** 2)))
        return res.iterations, rel, time.perf_counter() - t

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    S, N = 16, 256
    gen = diffusion2d.generate(S, N, N, overlap=1)
    its_d, rel_d, t_d = run(gen, {}, None, "cuda")
    peak = torch.cuda.max_memory_allocated()
    plain = count_plain_calls()
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     device="cuda")
    ost = sch.operator_state()
    kmod.launches = 0
    plain[0] = 0
    its_u, rel_u, t_u = run(gen, {}, lambda x: sz.gmv(ost, x), "cuda")
    b1, plain_calls = kmod.launches, plain[0]
    print(f"  (d) dense variant, generate({S}, {N}, {N}) (n_max "
          f"{sch.n_max}; blocks and inverses "
          f"{2 * S * sch.n_max ** 2 * 8 / 1e9:.2f} GB): dense bmm gmv "
          f"{its_d} iterations, residual {rel_d:.3e}, build + solve "
          f"{t_d:.2f} s, peak {peak / 2**30:.2f} GiB; the sparse "
          f"Schwarz.gmv as the user GMV {its_u} iterations, residual "
          f"{rel_u:.3e}, {t_u:.2f} s, B1 launches {b1}, plain-version calls "
          f"{plain_calls}")
    small = diffusion2d.generate(4, 30, 30, overlap=1)
    evp = dict(schwarz_coarse_correction="deflated", geneo_nu=5)
    inner = {dev: DenseSchwarz([m.dense() for m in small.mats],
                               small.neighbors, small.mappings, d=small.d,
                               device=dev) for dev in ("cuda", "cpu")}
    its_c, rel_c, _ = run(small, evp, inner["cuda"].gmv, "cuda", evp=True)
    its_h, rel_h, _ = run(small, evp, inner["cpu"].gmv, "cpu", evp=True)
    print(f"    EVP (nu=5) + deflated, user GMV, 30x30 S=4: {its_c} "
          f"iterations on the card (residual {rel_c:.3e}), {its_h} on the "
          f"host CPU (residual {rel_h:.3e})")
    check(its_d == its_u and rel_d <= 1e-6 and rel_u <= 1e-6,
          f"(d) dense gmv {its_d} vs user gmv {its_u} iterations")
    check(its_c == its_h and rel_c <= 1e-6,
          f"(d) EVP card {its_c} vs CPU {its_h}")
    check(b1 > 0 and plain_calls == 0, f"(d) B1 {b1}, plain {plain_calls}")
    out = dia_model_record("dia_spmv dense-variant user GMV path", ost.A,
                           b1)
    del sch, ost
    return out


def phase_23e():
    """(e) MAC Stokes (stokes2d.generate(16, N=STOKES_N, overlap=2, with
    Neumann matrices), Schur-complement CG with GenEO nu=8 inner solves
    (banded local solves through RCM, inner tol 1e-10; Lanczos with the
    host banded factor; the block-sparse coarse assembly, whose
    pseudo-inverse takes the zero vectors that Lanczos returns on the
    subdomain with no neighbour, ROADMAP C18), outer tol 1e-8). Gates: outer residual <= 1e-8,
    momentum residual <= 1e-6 of ||f||, divergence residual <= 1e-6
    ||u||/h, fewer than 80 outer iterations, the ELL kernels launched, no
    plain-version call. Returns the B4 and B5 records of the path."""
    import torch
    from hpddm_tpu_torch.models import stokes2d
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.parallel import pexchange as pk
    from hpddm_tpu_torch.precond.saddle import SaddleSolver

    N = STOKES_N
    t = time.perf_counter()
    gen, B, f, g, h, neu = stokes2d.generate(16, N=N, overlap=2,
                                             with_neumann=True)
    t_gen = time.perf_counter() - t
    plain = count_plain_calls()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in (ek, pk):
        mod.launches = 0
    plain[0] = 0
    t = time.perf_counter()
    sv = SaddleSolver(gen, B, options=Options(
        tol=1e-10, max_it=400, schwarz_coarse_correction="deflated",
        geneo_nu=8, coarse_assembly="bsr", local_solver="banded"),
        neumann=neu, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t
    t = time.perf_counter()
    res = sv.solve(f, g, tol=1e-8)
    t_solve = time.perf_counter() - t
    launches, plain_calls = (ek.launches, pk.launches), plain[0]
    peak = torch.cuda.max_memory_allocated()
    r1 = np.linalg.norm(gen.A_global @ res.u + B.T @ res.p - f) / \
        np.linalg.norm(f)
    r2 = np.linalg.norm(B @ res.u - g) / (np.linalg.norm(res.u) / h)
    A = sv.state.A
    print(f"  (e) Stokes N={N} ({B.shape[1]} velocity, {B.shape[0]} "
          f"pressure unknowns), S=16, n_max {sv.sch.n_max} "
          f"({type(A).__name__}), GenEO nu=8 inner solves at tol 1e-10, "
          f"banded through RCM (bandwidths {sv.sch.rcm_bandwidths}; "
          f"{factor_txt(sv.state.solver)}): "
          f"generate {t_gen:.2f} s, setup {t_setup:.2f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in sv.sch.timings.items())
          + f"), solve {t_solve:.2f} s; {res.outer_iterations} outer and "
          f"{res.inner_iterations} inner iterations, outer residual "
          f"{res.rel_res:.3e}, momentum residual {r1:.3e}, divergence "
          f"residual {r2:.3e}; peak {peak / 2**30:.2f} GiB; ell_spmv "
          f"launches {launches[0]}, pexchange {launches[1]}, plain-version "
          f"calls {plain_calls}")
    check(res.rel_res <= 1e-8 and r1 <= 1e-6 and r2 <= 1e-6
          and res.outer_iterations < 80,
          f"(e) outer {res.outer_iterations}, residuals {res.rel_res:.3e}, "
          f"{r1:.3e}, {r2:.3e}")
    check(min(launches) > 0 and plain_calls == 0,
          f"(e) B4/B5 launches {launches}, plain {plain_calls}")
    recs = ell_path_records("Stokes", A, sv.state.dec, launches,
                            np.random.default_rng(235))
    del sv
    return recs


# ----------------------------------------------------------------------
# phase 24: slice 5e(i)a, FETI and BDD with exact solves
# ----------------------------------------------------------------------

def averaged(gen, u):
    """The global vector of a substructured solution u (S, n_max, 1): each
    node the mean of its copies."""
    N = gen.A_global.shape[0]
    acc = np.zeros(N)
    cnt = np.zeros(N)
    u = u[:, :, 0].cpu().numpy()
    for s, g in enumerate(gen.gids):
        acc[g] += u[s, : len(g)]
        cnt[g] += 1
    return acc / cnt


def true_rel(gen, x):
    r = gen.A_global @ x - gen.f_global
    return float(np.linalg.norm(r) / np.linalg.norm(gen.f_global))


def phase_slice_5e():
    """Phase 24: slice 5e(i)a, FETI and BDD with exact solves: (a) the
    parity cell, (b) the GenEO cell, (c) the scale cell."""
    t = time.perf_counter()
    print("phase 24: slice 5e(i)a (FETI and BDD: dense pseudo-inverses, "
          "dense and mfree coarse projections, GenEO-substructuring)")
    phase_24a()
    release()
    phase_24b()
    release()
    phase_24c()
    release()
    wall = time.perf_counter() - t
    print(f"  phase 24 in all {wall:.1f} s")
    check(wall <= 180, f"phase 24 took {wall:.1f} s (limit 180)")


def phase_24a(device="cuda"):
    """(a) tools/bench_feti.py's default cell through the port's twin:
    every count within 1 of the JAX package's, solutions within 1e-6 of
    the direct solve."""
    import scipy.sparse.linalg as spla
    import torch
    from hpddm_tpu_torch.examples import bench_feti
    from hpddm_tpu_torch.models import nonoverlap
    from hpddm_tpu_torch.precond.substructure import feti_solve

    args = bench_feti.parser().parse_args(["--device", device])
    gen = nonoverlap.generate(args.S, args.N, args.N)
    x_direct = spla.spsolve(gen.A_global.tocsc(), gen.f_global)
    dev = torch.device(device)
    print(f"  (a) generate({args.S}, {args.N}, {args.N}): "
          f"{gen.A_global.shape[0]} unknowns, n_max {max(gen.n_loc)}")
    for mode in ("dense", "mfree"):
        out = bench_feti.run_mode(gen, mode, args, dev, np.float64,
                                  log=lambda m: print("    " + m))
        st, f = out["state"], out["f"]
        runs = {"feti dirichlet": out["feti"]["res"],
                "bdd": out["bdd"]["res"]}
        for p in ("lumped", "superlumped", "none"):
            runs[f"feti {p}"] = feti_solve(st, f, tol=args.tol,
                                           max_it=args.max_it, precond=p)
        for name, res in runs.items():
            want = FETI_JAX_ITS[f"a {mode} {name}"]
            err = (np.linalg.norm(averaged(gen, res.u) - x_direct)
                   / np.linalg.norm(x_direct))
            print(f"    [{mode}] {name}: {res.iterations} iterations (JAX "
                  f"package on the CPU {want}), rel. residual "
                  f"{float(res.rel_res.max()):.3e}, against the direct "
                  f"solve {err:.3e}")
            check(abs(res.iterations - want) <= 1,
                  f"(a) {mode} {name}: {res.iterations} iterations, the JAX "
                  f"package's {want}")
            check(err <= 1e-6, f"(a) {mode} {name}: {err:.3e} from the "
                  "direct solve")
        del out, st, f, runs


def phase_24b(device="cuda"):
    """(b) the GenEO cell: base counts within 1 of the JAX package's,
    deflated FETI below base, enriched BDD not above it, both converged
    and within 10% of the JAX package's counts."""
    import scipy.sparse.linalg as spla
    import torch
    from hpddm_tpu_torch.device import synchronize
    from hpddm_tpu_torch.examples.bench_feti import rhs
    from hpddm_tpu_torch.models import nonoverlap
    from hpddm_tpu_torch.precond.substructure import (Substructure,
                                                      bdd_solve, feti_solve)

    t = time.perf_counter()
    gen = nonoverlap.generate(64, 256, 256, contrast=1e4, checker=16)
    t_gen = time.perf_counter() - t
    x_direct = spla.spsolve(gen.A_global.tocsc(), gen.f_global)
    t = time.perf_counter()
    sub = Substructure(gen.mats, gen.neighbors, gen.mappings, device=device)
    t_setup = time.perf_counter() - t
    f = torch.as_tensor(rhs(gen, sub.n_max, np.float64), device=device)
    print(f"  (b) generate(64, 256, 256, contrast=1e4, checker=16): "
          f"{gen.A_global.shape[0]} unknowns, n_max {sub.n_max}, generated "
          f"in {t_gen:.2f} s, setup {t_setup:.2f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in sub.timings.items()) + ")")
    tol, max_it = 1e-8, 500
    runs = {"feti": feti_solve(sub.state, f, tol=tol, max_it=max_it),
            "bdd": bdd_solve(sub.state, f, tol=tol, max_it=max_it)}
    t = time.perf_counter()
    st = sub.solve_gevp(nu=6, feti_deflation=True)
    synchronize(sub.device)
    t_gevp = time.perf_counter() - t
    runs["feti deflated"] = feti_solve(st, f, tol=tol, max_it=max_it)
    runs["bdd enriched"] = bdd_solve(st, f, tol=tol, max_it=max_it)
    print(f"    solve_gevp(nu=6, feti_deflation=True) {t_gevp:.2f} s: "
          f"deflation space {st.G_def.shape[1]} columns, balancing ranks "
          f"{int(st.sb_r_loc.min())}-{int(st.sb_r_loc.max())}")
    for name, res in runs.items():
        want = FETI_JAX_ITS[f"b {name}"]
        err = (np.linalg.norm(averaged(gen, res.u) - x_direct)
               / np.linalg.norm(x_direct))
        print(f"    {name}: {res.iterations} iterations (JAX package on the "
              f"CPU {want}), rel. residual {float(res.rel_res.max()):.3e}, "
              f"against the direct solve {err:.3e}")
        if name in ("feti", "bdd"):
            check(abs(res.iterations - want) <= 1,
                  f"(b) {name}: {res.iterations} iterations, the JAX "
                  f"package's {want}")
        else:
            check(float(res.rel_res.max()) <= tol and err <= 1e-5,
                  f"(b) {name} did not converge")
            check(abs(res.iterations - want) <= 0.1 * want,
                  f"(b) {name}: {res.iterations} iterations, more than 10% "
                  f"from the JAX package's {want}")
    check(runs["feti deflated"].iterations < runs["feti"].iterations,
          "(b) deflated FETI not below base")
    check(runs["bdd enriched"].iterations <= runs["bdd"].iterations,
          "(b) enriched BDD above base")
    del sub, st, runs, f


def phase_24c(S=1024, N=1024, device="cuda"):
    """(c) the scale cell generate(1024, 1024, 1024): setup by phase, both
    solvers in both coarse modes, the K^+ bmm against its bound. (Smaller
    S, N and the CPU rehearse it.)"""
    import torch
    from hpddm_tpu_torch.device import synchronize
    from hpddm_tpu_torch.examples.bench_feti import rhs
    from hpddm_tpu_torch.models import nonoverlap
    from hpddm_tpu_torch.precond import substructure as sb
    from hpddm_tpu_torch.timing import cold_events_ms

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def timed(fn, reps=3):
        out = fn()
        synchronize(dev)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            synchronize(dev)
            times.append(time.perf_counter() - t0)
        return min(times), times, out

    t = time.perf_counter()
    gen = nonoverlap.generate(S, N, N)
    t_gen = time.perf_counter() - t
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    sub = sb.Substructure(gen.mats, gen.neighbors, gen.mappings,
                          device=dev)
    t_setup = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    st = sub.state
    S, n = st.K_pinv.shape[:2]
    nb, ni = st.bidx.shape[1], st.iidx.shape[1]
    nbytes = {k: getattr(st, k).numel() * 8 for k in ("K_pinv", "Kii_inv",
                                                       "K_bi", "G")}
    print(f"  (c) generate({S}, {N}, {N}): {gen.A_global.shape[0]} "
          f"unknowns, n_max {n}, nb_max {nb}, ni_max {ni}, "
          f"{st.N_l} multipliers, nc {st.nc} floating; generated in "
          f"{t_gen:.2f} s; setup {t_setup:.2f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in sub.timings.items())
          + f"), setup peak {setup_peak / 2**30:.2f} GiB; "
          + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in nbytes.items()))
    del sub
    f = torch.as_tensor(rhs(gen, n, np.float64), device=dev)
    t = time.perf_counter()
    st_m = sb.with_coarse_mode(st, "mfree")
    synchronize(dev)
    t_mfree = time.perf_counter() - t
    print(f"    mfree coarse projection on the same factors {t_mfree:.2f} s "
          f"(G^H G from the slots; G {nbytes['G'] / 1e9:.2f} GB and W "
          f"{S * nb * S * st.Sb_kernels.shape[2] * 8 / 1e9:.2f} GB not "
          "formed)")
    tol, max_it = 1e-8, 500
    xs, its, ms_it = {}, {}, {}
    for mode, state in (("dense", st), ("mfree", st_m)):
        for name, solve in (("feti", sb.feti_solve), ("bdd", sb.bdd_solve)):
            counts = []

            def run():
                res = solve(state, f, tol=tol, max_it=max_it)
                counts.append(res.iterations)
                return res
            best, times, res = timed(run)
            x = averaged(gen, res.u)
            rel = true_rel(gen, x)
            key = (mode, name)
            xs[key], its[key] = x, res.iterations
            ms_it[key] = 1e3 * best / max(res.iterations, 1)
            print(f"    [{mode}] {name.upper()}: {res.iterations} iterations "
                  f"in each of {len(counts)} solves, rel. residual "
                  f"{float(res.rel_res.max()):.3e}, true rel. residual "
                  f"{rel:.3e}; best of 3 after a warm-up {best:.4f} s ("
                  + ", ".join(f"{x:.4f}" for x in times)
                  + f"), {ms_it[key]:.3f} ms an iteration")
            check(len(set(counts)) == 1,
                  f"(c) {mode} {name}: counts differ across repeats {counts}")
            check(rel <= 1e-6, f"(c) {mode} {name}: true rel. residual "
                  f"{rel:.3e}")
            del res
    for mode in ("dense", "mfree"):
        d = (np.linalg.norm(xs[(mode, "feti")] - xs[(mode, "bdd")])
             / np.linalg.norm(xs[(mode, "feti")]))
        print(f"    [{mode}] FETI and BDD solutions differ by {d:.3e}")
        check(d <= 1e-6, f"(c) {mode}: FETI and BDD differ by {d:.3e}")
    check(its[("mfree", "feti")] == its[("dense", "feti")],
          f"(c) mfree FETI {its[('mfree', 'feti')]} iterations, dense "
          f"{its[('dense', 'feti')]}")
    check(abs(its[("mfree", "bdd")] - its[("dense", "bdd")]) <= 5,
          f"(c) mfree BDD {its[('mfree', 'bdd')]} iterations, dense "
          f"{its[('dense', 'bdd')]}")
    if cuda:
        # the K^+ product of every FETI iteration: the inverses read once
        w = torch.randn((S, n, 1), dtype=torch.float64, device=dev)
        k_ms = cold_events_ms(lambda: sb._k_pinv_apply(st, w), reps=10)
        b_ms, b_by = bound(nbytes["K_pinv"] + 2 * w.numel() * 8,
                           2 * S * n * n, torch.float64)
        print(f"    K^+ bmm (S={S}, n={n}, mu=1): {k_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}; {100 * b_ms / k_ms:.1f}% of it), "
              f"{100 * k_ms / ms_it[('dense', 'feti')]:.1f}% of a dense "
              "FETI iteration")
        peak = torch.cuda.max_memory_allocated()
        print(f"    peak device memory {peak / 2**30:.2f} GiB "
              "(torch.cuda.max_memory_allocated, setup included)")
        check(peak < 80e9, f"(c) peak {peak / 1e9:.1f} GB")
        del w
    del st, st_m, f


# ----------------------------------------------------------------------
# phase 25: slices 5e(i)b and 5f, banded FETI/BDD, Chebyshev coarse
# solves, least squares, the algebraic splitting and the last twins
# ----------------------------------------------------------------------

def dia_counts():
    """(B1, B2) launches since the last reset."""
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    return kmod.launches, kmod.spmm_launches


def ell_counts():
    """(B4, B5) launches since the last reset."""
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.parallel import pexchange as pk
    return ek.launches, pk.launches


def reset_counts():
    """Every kernel's launch count to 0 (the main path's counts from
    here)."""
    from hpddm_tpu_torch.ops import dia_spmv as kmod
    from hpddm_tpu_torch.ops import ell_spmv as ek
    from hpddm_tpu_torch.parallel import pexchange as pk

    kmod.launches = kmod.spmm_launches = kmod.muT_launches = 0
    ek.launches = pk.launches = 0


def banded_substructure(gen, device, **opts):
    """The port's banded Substructure of a nonoverlap problem."""
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.substructure import Substructure

    return Substructure(gen.mats, gen.neighbors, gen.mappings,
                        options=Options(substructuring_local="banded",
                                        **opts),
                        kernels=gen.kernels, grid_shapes=gen.grid_shapes,
                        slot_maps=gen.slot_maps, device=device)


def phase_slice_5eb():
    """Phase 25: slices 5e(i)b and 5f: (a) the banded parity cell, (b) the
    banded GenEO cell, (c) the banded scale cell, (d) least squares, the
    algebraic SPSD splitting and the new example twins. Returns the B1/B2
    records at the slice's shapes."""
    t = time.perf_counter()
    print("phase 25: slices 5e(i)b and 5f (banded FETI/BDD, Chebyshev "
          "coarse solves, least squares, spsd_neumann, the last twins)")
    launches = {}
    phase_25a(launches=launches)
    release()
    A_b, nd = phase_25b(launches=launches)
    release()
    A_c, ncb = phase_25c(launches=launches)
    release()
    phase_25d()
    release()
    recs = [dia_model_record("dia_spmv banded FETI/BDD scale cell", A_c,
                             launches["c"][0]),
            dia_model_record("dia_spmm banded BDD coarse assembly "
                             "(mfree W^T S W panel)", A_c, launches["c"][1],
                             mu=ncb),
            dia_model_record("dia_spmm banded GenEO deflation block "
                             "(F G_def)", A_b, launches["b"][1], mu=nd)]
    wall = time.perf_counter() - t
    print(f"  phase 25 in all {wall:.1f} s")
    return recs


def phase_25a(device="cuda", launches=None):
    """(a) the banded parity cell, tools/bench_feti.py's default
    generate(64, 128, 128) with --local banded through the port's twin:
    dense, mfree and cheby coarse modes; FETI (dirichlet, lumped, none)
    and BDD against the JAX package's CPU counts ``FETI5B_JAX_ITS``
    (dirichlet exactly, lumped and none within 1: C22; BDD in C21's
    window, the JAX package's spread over start keys, which is 0);
    solutions within 1e-6 of the direct solve."""
    import scipy.sparse.linalg as spla
    import torch
    from hpddm_tpu_torch.device import synchronize
    from hpddm_tpu_torch.examples import bench_feti
    from hpddm_tpu_torch.models import nonoverlap
    from hpddm_tpu_torch.precond.substructure import bdd_solve, feti_solve

    args = bench_feti.parser().parse_args(["--device", device, "--local",
                                           "banded", "--skip-bdd"])
    gen = nonoverlap.generate(args.S, args.N, args.N)
    x_direct = spla.spsolve(gen.A_global.tocsc(), gen.f_global)
    dev = torch.device(device)
    print(f"  (a) generate({args.S}, {args.N}, {args.N}), banded locals: "
          f"{gen.A_global.shape[0]} unknowns, n_max {max(gen.n_loc)}")
    reset_counts()                       # the path's counts from here
    for mode in ("dense", "mfree", "cheby"):
        out = bench_feti.run_mode(gen, mode, args, dev, np.float64,
                                  log=lambda m: print("    " + m))
        st, f = out["state"], out["f"]
        t = time.perf_counter()
        runs = {"feti dirichlet": out["feti"]["res"],
                "bdd": bdd_solve(st, f, tol=args.tol, max_it=args.max_it)}
        synchronize(dev)
        print(f"    [{mode}] BDD solve {time.perf_counter() - t:.2f} s")
        for p in ("lumped", "none"):
            runs[f"feti {p}"] = feti_solve(st, f, tol=args.tol,
                                           max_it=args.max_it, precond=p)
        print(f"    [{mode}] A_loc {type(st.A_loc).__name__} "
              f"{len(getattr(st.A_loc, 'offsets', ()))} diagonals; "
              f"S_b^+ degree {st.sb_degree}, bounds [{st.sb_lo:.6g}, "
              f"{st.sb_hi:.6g}]")
        for name, res in runs.items():
            want = FETI5B_JAX_ITS[f"a {mode} {name}"]
            err = (np.linalg.norm(averaged(gen, res.u) - x_direct)
                   / np.linalg.norm(x_direct))
            slack = 1 if name in ("feti lumped", "feti none") else 0
            print(f"    [{mode}] {name}: {res.iterations} iterations (JAX "
                  f"package on the CPU {want}), rel. residual "
                  f"{float(res.rel_res.max()):.3e}, against the direct "
                  f"solve {err:.3e}")
            check(abs(res.iterations - want) <= slack,
                  f"(a) {mode} {name}: {res.iterations} iterations, the JAX "
                  f"package's {want}")
            check(err <= 1e-6, f"(a) {mode} {name}: {err:.3e} from the "
                  "direct solve")
        del out, st, f, runs
    launches["a"] = dia_counts()           # read just after the path
    print(f"    B1 launches {launches['a'][0]}, B2 {launches['a'][1]}")
    if dev.type == "cuda":
        check(launches["a"][0] > 0, "(a) no B1 launch on the banded path")


def phase_25b(device="cuda", launches=None, args=(64, 256, 256)):
    """(b) the GenEO cell generate(64, 256, 256, contrast=1e4,
    checker=16) with banded locals and the cheby coarse mode, where no
    solve converges in either package (C23): base FETI and, after
    solve_gevp(nu=6, feti_deflation=True) through the Lanczos pencil,
    deflated FETI, at a cap of 150 iterations; BDD base and enriched at a
    cap of 5 (``FETI5B_CAPS``). Base FETI's and both BDD residuals within
    a factor 2 of the JAX package's at the same caps (``FETI5B_JAX_RES``;
    they depend on the Chebyshev bounds only, C21), the deflated FETI
    residual below a tenth of base's (the JAX package's is 0.034 of it).
    Returns (the local matrices, the deflation block's width)."""
    import torch
    from hpddm_tpu_torch.device import synchronize
    from hpddm_tpu_torch.examples.bench_feti import rhs
    from hpddm_tpu_torch.models import nonoverlap
    from hpddm_tpu_torch.precond.substructure import bdd_solve, feti_solve

    t = time.perf_counter()
    gen = nonoverlap.generate(*args, contrast=1e4, checker=16)
    t_gen = time.perf_counter() - t
    reset_counts()                       # the path's counts from here
    t = time.perf_counter()
    sub = banded_substructure(gen, device, substructuring_coarse="cheby")
    t_setup = time.perf_counter() - t
    st = sub.state
    f = torch.as_tensor(rhs(gen, sub.n_max, np.float64), device=device)
    print(f"  (b) generate({', '.join(map(str, args))}, contrast=1e4, "
          f"checker=16), banded locals, cheby coarse: "
          f"{gen.A_global.shape[0]} unknowns, n_max {sub.n_max}, generated "
          f"in {t_gen:.2f} s, setup {t_setup:.2f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in sub.timings.items())
          + f"); S_b^+ degree {st.sb_degree} on [{st.sb_lo:.6g}, "
          f"{st.sb_hi:.6g}], G^T G degree {st.coarse_degree}, W^T S W "
          f"degree {st.bdd_coarse_degree}")
    tol, caps = 1e-8, FETI5B_CAPS
    runs = {}
    t = time.perf_counter()
    runs["feti"] = feti_solve(st, f, tol=tol, max_it=caps["feti"])
    runs["bdd"] = bdd_solve(st, f, tol=tol, max_it=caps["bdd"])
    synchronize(sub.device)
    t_base = time.perf_counter() - t
    t = time.perf_counter()
    st = sub.solve_gevp(nu=6, feti_deflation=True)
    synchronize(sub.device)
    t_gevp = time.perf_counter() - t
    nd = st.G_def.shape[1]
    t = time.perf_counter()
    runs["feti deflated"] = feti_solve(st, f, tol=tol, max_it=caps["feti"])
    runs["bdd enriched"] = bdd_solve(st, f, tol=tol, max_it=caps["bdd"])
    synchronize(sub.device)
    t_enr = time.perf_counter() - t
    launches["b"] = dia_counts()           # read just after the path
    print(f"    solves before GenEO {t_base:.2f} s, solve_gevp(nu=6, "
          f"feti_deflation=True) through the Lanczos pencil {t_gevp:.2f} s "
          f"(deflation space {nd} columns, balancing ranks "
          f"{int(st.sb_r_loc.min())}-{int(st.sb_r_loc.max())}, W^T S W "
          f"degree {st.bdd_coarse_degree}), solves after {t_enr:.2f} s; "
          f"B1 launches {launches['b'][0]}, B2 {launches['b'][1]}")
    for name, res in runs.items():
        rel = float(res.rel_res.max())
        want = FETI5B_JAX_RES[f"b {name}"]
        cap = caps[name.split()[0]]
        print(f"    {name}: {res.iterations} iterations (cap {cap}), rel. "
              f"residual {rel:.3e} (the JAX package on the CPU {want:.3e})")
        check(res.iterations == cap and np.isfinite(rel),
              f"(b) {name}: {res.iterations} iterations, residual {rel}")
        if name != "feti deflated":
            check(0.5 * want <= rel <= 2.0 * want,
                  f"(b) {name}: residual {rel:.3e} at the cap, the JAX "
                  f"package's {want:.3e}")
    check(float(runs["feti deflated"].rel_res.max())
          < 0.1 * float(runs["feti"].rel_res.max()),
          "(b) deflated FETI's residual not below a tenth of base's")
    if torch.device(device).type == "cuda":
        check(min(launches["b"]) > 0, f"(b) B1/B2 launches {launches['b']}")
    A = st.A_loc
    del sub, st, runs, f
    return A, nd


def phase_25c(S=16, N=512, device="cuda", launches=None, reps=3):
    """(c) the banded scale cell: 128^2 local boxes, whose dense local
    factors would take 2.2 GB each, on 16 subdomains (262,144 unknowns;
    generate(64, 1024, 1024), phase 24 (c)'s system on 64 such boxes,
    cut to S=16 at N=512 for the smoke's time limit). Setup by phase and
    its peak; FETI and BDD in the mfree and cheby coarse modes, FETI best
    of ``reps`` with the same count in each, each BDD solve once (0.5-0.9
    s an iteration, host-paced); true residuals; the device-busy share of
    a one-iteration BDD solve; peak memory. Returns (the local matrices,
    the mfree BDD coarse panel's width)."""
    import torch
    from hpddm_tpu_torch.device import synchronize
    from hpddm_tpu_torch.examples.bench_feti import rhs
    from hpddm_tpu_torch.models import nonoverlap
    from hpddm_tpu_torch.precond import substructure as sb

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t = time.perf_counter()
    gen = nonoverlap.generate(S, N, N)
    t_gen = time.perf_counter() - t
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()                       # the path's counts from here
    t = time.perf_counter()
    sub = banded_substructure(gen, dev, substructuring_coarse="mfree")
    t_setup = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    st = sub.state
    n, nb, ni = st.n_max, st.bidx.shape[1], st.iidx.shape[1]
    ncb = st.S_total * st.Sb_kernels.shape[2]
    cut = (" (generate(64, 1024, 1024) cut to 16 subdomains of its "
           "128^2 boxes)" if (S, N) == (16, 512) else "")
    print(f"  (c) generate({S}, {N}, {N}){cut}, banded locals: "
          f"{gen.A_global.shape[0]} unknowns, n_max {n}, nb_max {nb}, "
          f"ni_max {ni}, {st.N_l} multipliers, nc {st.nc} floating; "
          f"generated in {t_gen:.2f} s; setup {t_setup:.2f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in sub.timings.items())
          + f"), setup peak {setup_peak / 2**30:.2f} GiB; factors: K + eps I "
          f"{st.Kb.nbytes / 1e9:.2f} GB, K_ii {st.Kiib.nbytes / 1e9:.2f} GB;"
          f" A_loc {type(st.A_loc).__name__} offsets {st.A_loc.offsets}; "
          f"S_b^+ degree {st.sb_degree} on [{st.sb_lo:.6g}, "
          f"{st.sb_hi:.6g}]; a dense local K would take "
          f"{n * n * 8 / 1e9:.2f} GB a subdomain")
    del sub
    f = torch.as_tensor(rhs(gen, n, np.float64), device=dev)
    t = time.perf_counter()
    st_c = sb.with_coarse_mode(st, "cheby")
    synchronize(dev)
    print(f"    cheby coarse mode on the same factors "
          f"{time.perf_counter() - t:.2f} s: G^T G degree "
          f"{st_c.coarse_degree}, W^T S W degree {st_c.bdd_coarse_degree}")
    tol, max_it = 1e-8, 500
    xs, its = {}, {}
    for mode, state in (("mfree", st), ("cheby", st_c)):
        for name, solve in (("feti", sb.feti_solve), ("bdd", sb.bdd_solve)):
            counts, times = [], []
            n_runs = 1 if name == "bdd" else reps
            for _ in range(n_runs):
                t0 = time.perf_counter()
                res = solve(state, f, tol=tol, max_it=max_it)
                synchronize(dev)
                times.append(time.perf_counter() - t0)
                counts.append(res.iterations)
            x = averaged(gen, res.u)
            rel = true_rel(gen, x)
            xs[mode, name], its[mode, name] = x, res.iterations
            best = min(times)
            print(f"    [{mode}] {name.upper()}: {res.iterations} iterations "
                  f"in each of {len(counts)} solves, rel. residual "
                  f"{float(res.rel_res.max()):.3e}, true rel. residual "
                  f"{rel:.3e}; best of {n_runs} {best:.3f} s ("
                  + ", ".join(f"{x_:.3f}" for x_ in times)
                  + f"), {1e3 * best / max(res.iterations, 1):.2f} ms an "
                  "iteration")
            check(len(set(counts)) == 1,
                  f"(c) {mode} {name}: counts differ across repeats {counts}")
            check(float(res.rel_res.max()) <= tol and rel <= 1e-6,
                  f"(c) {mode} {name}: residuals {float(res.rel_res.max())}"
                  f", true {rel:.3e}")
            del res
    launches["c"] = dia_counts()           # read just after the path
    for mode in ("mfree", "cheby"):
        d = (np.linalg.norm(xs[mode, "feti"] - xs[mode, "bdd"])
             / np.linalg.norm(xs[mode, "feti"]))
        print(f"    [{mode}] FETI and BDD solutions differ by {d:.3e}")
        check(d <= 1e-6, f"(c) {mode}: FETI and BDD differ by {d:.3e}")
    print(f"    B1 launches {launches['c'][0]}, B2 {launches['c'][1]} "
          f"(from setup to the last solve)")
    if cuda:
        check(min(launches["c"]) > 0, f"(c) B1/B2 launches {launches['c']}")
        # one BDD iteration's operator work: S p, the Chebyshev S_b^+ of
        # the preconditioner, and S of its result for the balancing
        ub = sb._gather_b(st, f)
        t = time.perf_counter()
        wall_ms, busy_ms = device_busy_ms(lambda: sb.bdd_operator(
            st, sb.bdd_precond(st, sb.bdd_operator(st, ub))),
            cpu_ops=False, warmup=False)
        t_prof = time.perf_counter() - t
        print(f"    one BDD iteration's operator work (S, the Chebyshev "
              f"S_b^+, S: 130 implicit S_b applies): {wall_ms:.1f} ms of "
              "wall, device busy "
              + ("not measured" if busy_ms is None else
                 f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
              + f"; the profiled run and its post-processing "
              f"{t_prof:.1f} s")
        peak = torch.cuda.max_memory_allocated()
        print(f"    peak device memory {peak / 2**30:.2f} GiB "
              "(torch.cuda.max_memory_allocated, setup included)")
        check(peak < 80e9, f"(c) peak {peak / 1e9:.1f} GB")
    A = st.A_loc
    del st, st_c, f
    return A, ncb


def phase_25d(device="cuda", nx=256):
    """(d) slice 5f: LeastSquaresSolver on tests/test_leastsquares.py's
    gradient problem at nx x nx (S=16, overlap 2), one level and GenEO
    (balanced, coerced to additive, nu=8): both reach 1e-8 and the direct
    solution within 1e-5, two-level below 0.7 of one-level; spsd_neumann
    GenEO at tests/test_fromfile.py:149's configuration; each new twin
    once, on matrix files written here."""
    import tempfile

    import scipy.io
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from hpddm_tpu_torch.examples import (custom_operator, iterative,
                                          least_squares, schwarz_from_file,
                                          solver)
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.leastsquares import LeastSquaresSolver

    A, b = least_squares.gradient_problem(nx, delta=1e-4, seed=1)
    x_ref = spla.spsolve(sp.csr_matrix(A.T @ A).tocsc(), A.T @ b)
    its = {}
    print(f"  (d) least squares: gradient problem {nx}x{nx} "
          f"({A.shape[0]} x {A.shape[1]}), S=16, overlap 2")
    reset_counts()                       # the path's counts from here
    for name, opt in (("one level", Options()),
                      ("GenEO", Options(schwarz_coarse_correction="balanced",
                                        geneo_nu=8))):
        t = time.perf_counter()
        ls = LeastSquaresSolver(A, n_subdomains=16, overlap=2, options=opt,
                                device=device)
        t_setup = time.perf_counter() - t
        t = time.perf_counter()
        res = ls.solve(b, tol=1e-8, max_it=1000)
        t_solve = time.perf_counter() - t
        err = np.linalg.norm(res.x - x_ref) / np.linalg.norm(x_ref)
        its[name] = res.iterations
        print(f"    [{name}] {type(ls.state.A).__name__} local matrices, "
              f"setup {t_setup:.2f} s, CGLS {res.iterations} iterations in "
              f"{t_solve:.2f} s, ||A^T r||/||A^T b|| {res.rel_res:.3e}, "
              f"against the direct solution {err:.3e}")
        check(res.rel_res <= 1e-8 and err <= 1e-5,
              f"(d) {name}: residual {res.rel_res:.3e}, error {err:.3e}")
        del ls
    print(f"    kernel launches on the least-squares path: B1/B2 "
          f"{dia_counts()}, B4/B5 {ell_counts()}")
    check(its["GenEO"] < 0.7 * its["one level"],
          f"(d) GenEO {its['GenEO']} iterations, one level "
          f"{its['one level']}")
    phase_25d_spsd(device)
    with tempfile.TemporaryDirectory() as tmp:
        from hpddm_tpu_torch.models import diffusion2d
        mat = os.path.join(tmp, "diffusion.txt")
        diffusion2d.generate(1, 50, 50).mats[0].dump(mat)
        rect = os.path.join(tmp, "gradient.mtx")
        scipy.io.mmwrite(rect, least_squares.gradient_problem(32)[0])
        dev = ["-device", device]
        for drv, argv in (
                (iterative, ["-matrix_filename", mat]),
                (solver, ["-matrix_filename", mat]),
                (custom_operator, ["-n", "100", "-mu", "2", "-S", "4"]),
                (schwarz_from_file, ["-matrix_filename", mat, "-N", "4",
                                     "-overlap", "2",
                                     "-hpddm_schwarz_coarse_correction",
                                     "deflated", "-hpddm_geneo_nu", "6"]),
                (least_squares, ["-matrix_filename", rect, "-N", "8"])):
            name = drv.__name__.rsplit(".", 1)[1]
            t = time.perf_counter()
            rc = drv.main(argv + dev)
            print(f"    twin {name} exit {rc} in "
                  f"{time.perf_counter() - t:.2f} s")
            check(rc == 0, f"(d) twin {name} exited {rc}")


def phase_25d_spsd(device):
    """spsd_neumann at tests/test_fromfile.py:149's configuration (a 60x60
    5-point matrix, S=8, overlap 2): the prolongated sum is the matrix,
    and GenEO on the splitting (nu=8, deflated) cuts GMRES's count to at
    most 16."""
    import scipy.sparse as sp
    import torch
    from hpddm_tpu_torch.core.csr import MatrixCSR
    from hpddm_tpu_torch.models import diffusion2d, fromfile
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import Schwarz
    from hpddm_tpu_torch.solvers.krylov import solve

    K = diffusion2d.generate(1, 60, 60, overlap=0).mats[0].scipy(expand=True)
    S = 8
    gen = fromfile.decompose(MatrixCSR(sp.csr_matrix(K)), S, overlap=2)
    neu = fromfile.spsd_neumann(gen)
    acc = sp.csr_matrix(K.shape)
    for s, g in enumerate(gen.gids):
        R = sp.csr_matrix((np.ones(len(g)), (np.arange(len(g)), g)),
                          shape=(len(g), K.shape[0]))
        acc = acc + R.T @ neu[s].scipy(expand=True) @ R
    Ksym = (K + K.T) * 0.5
    gap = abs(acc - Ksym).max() / abs(Ksym).max()
    its = {}
    for cc in (None, "deflated"):
        opt = Options(tol=1e-8, **({} if cc is None else dict(
            schwarz_coarse_correction=cc, geneo_nu=8)))
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt, device=device)
        if cc:
            sch.solve_gevp(neu)
        f = np.zeros((S, sch.n_max, 1))
        for s in range(S):
            f[s, : gen.n_loc[s]] = gen.f[s]
        its[cc] = solve(sch.build(), torch.as_tensor(f, device=device),
                        opt=opt).iterations
    print(f"    spsd_neumann (60x60, S=8, overlap 2): prolongated sum within "
          f"{gap:.1e} of the matrix; GMRES one level {its[None]}, GenEO on "
          f"the splitting {its['deflated']} iterations")
    check(gap < 1e-10 and its["deflated"] < its[None]
          and its["deflated"] <= 16, f"(d) spsd_neumann: {gap}, {its}")


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
    libs = _build.build(force=True)
    _build.load()
    print(f"phase 2: built {len(libs)} libraries from "
          f"{len(_build.sources())} sources in parallel in "
          f"{time.perf_counter() - t:.2f} s: "
          + ", ".join(os.path.basename(p) for p in libs))
    spilled = []
    for stem, log in sorted(_build.LOGS.items()):
        for rec in _build.resources(log):
            print(f"  {stem}.cu {rec['kernel']}: {rec['registers']} "
                  f"registers, {rec['smem']} B shared memory, spills "
                  f"{rec['spill_stores']} B stored / {rec['spill_loads']} B "
                  "loaded (ptxas -v)")
            if rec["spill_stores"] or rec["spill_loads"]:
                spilled.append(rec["kernel"])
    print(f"  kernels that spill: {', '.join(spilled) or 'none'}")

    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"  {what}: {now - clock[0]:.1f} s of wall time")
        clock[0] = now

    lap("phases 1-2")
    print("phase 3: kernel vs plain")
    max_err = phase_kernels()
    lap("phase 3")
    phase_oracle()
    lap("phase 4")
    dia, grid_gmv_ms, card, grid5 = phase_card_scale()
    dia["max_abs_err"] = max_err
    lap("phase 5")
    b4_err, b5_err = phase_kernels_unstructured()
    lap("phase 6")
    phase_unstructured_parity()
    lap("phase 7")
    unstr, unstr_cell = phase_unstructured_card(grid_gmv_ms)
    for rec in unstr:
        rec["max_abs_err"] = max(rec["max_abs_err"], b4_err if
                                 rec["name"].startswith("ell") else b5_err)
    lap("phase 8")
    spmm_err = phase_kernels_spmm()
    lap("phase 9")
    phase_multi_parity()
    lap("phase 10")
    spmm = phase_multi_card(card)
    for rec in spmm:
        rec["max_abs_err"] = max(spmm_err, rec["max_abs_err"])
    del card
    lap("phase 11")
    banded = phase_banded_grid(dia)
    lap("phase 12")
    banded += phase_banded_unstructured(unstr_cell, unstr)
    lap("phase 13")
    canvas = phase_gmv_cells()
    lap("phase 14")
    canvas.append(phase_flagship())
    lap("phase 15")
    canvas += phase_ladder()
    lap("phase 16")
    models = [phase_elasticity()]
    lap("phase 17")
    models.append(phase_diffusion3d())
    lap("phase 18")
    models += phase_elasticity3d()
    lap("phase 19")
    phase_sequence()
    lap("phase 20")
    models += phase_helmholtz()
    lap("phase 21")
    slice5a = phase_slice_5a(unstr_cell, dia, grid5)
    del unstr_cell, grid5
    lap("phase 22")
    slice5d = phase_slice_5d()
    lap("phase 23")
    phase_slice_5e()
    lap("phase 24")
    slice5eb = phase_slice_5eb()
    lap("phase 25")

    kernels = {"kernels": [dia, *spmm, *unstr, *banded, *canvas, *models,
                           *slice5a, *slice5d, *slice5eb]}
    wall = time.perf_counter() - t_start
    print(f"wall {wall:.1f} s")
    check(wall < 1100, f"the smoke took {wall:.1f} s (limit 1100)")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
