#!/usr/bin/env python
"""GCRO-DR recycling driver of the port, the twin of ``examples/driver.py``
(the analogue of the reference's examples/driver.cpp): solve a sequence of
related linear systems, recycling the deflation subspace between solves,
and check the *total* iteration windows.

    python -m hpddm_tpu_torch.examples.driver [-hpddm_recycle 20] \
        [-hpddm_recycle_strategy B] [-device cuda|cpu]

Reference scale: restart 40, recycle 20, tol 1e-10 (driver.cpp:69-72) on
the 10-system n=2025 drifting-coefficient diffusion sequence
(``models/sequences.drifting_diffusion``). The operator is the dense
product of each system's matrix, as in the JAX driver; no hand-written
kernel is involved. The recycled (U, C) pair persists between solves in
the Options' per-prefix storage (OptionsPrefix::storage_,
HPDDM_option.hpp:444-461).

The windows are the JAX driver's **reference-derived** ones, recorded from
the HPDDM binary on this sequence: GMRES(40) = 1871 (+-10, driver.cpp:
151-156), GCRODR(40,20) strategy A = 1561 (+-25: across implementations
the recycle-space eigensolves differ in the last digits) and strategy B =
1713 (one-sided: the JAX package's exact pencil rows converge faster).
They hold only at that configuration in f64; every configuration must
take fewer GCRODR than GMRES iterations. Exits non-zero otherwise.
"""

import sys

import numpy as np
import torch

# reference-binary totals on this sequence (examples/driver.py)
REF_GMRES = 1871
REF_GCRODR_A = 1561
REF_GCRODR_B = 1713


def totals(opt, device, n_sys=10, dtype=torch.float64):
    """(GMRES total, GCRODR total, recycle settings) over the first
    ``n_sys`` systems of the sequence, at ``opt``'s restart, recycle size
    and tol (defaults 40, 20, 1e-10)."""
    from hpddm_tpu_torch.models.sequences import drifting_diffusion
    from hpddm_tpu_torch.solvers.base import LinearOperator
    from hpddm_tpu_torch.solvers.krylov import solve

    restart = int(opt.val("gmres_restart", 40))
    recycle = int(opt.val("recycle", 20))
    tol = float(opt.val("tol", 1e-10))
    systems = drifting_diffusion(n_sys=10, nx=45, ny=45)[:n_sys]
    opt_r = opt.copy()
    opt_r["krylov_method"] = "gcrodr"
    opt_r["recycle"] = recycle
    opt_r["tol"], opt_r["max_it"] = tol, 1000
    opt_r["gmres_restart"] = restart
    opt_g = opt_r.copy()
    opt_g["krylov_method"] = "gmres"

    total_g = total_r = 0
    for A, rhs in systems:
        Ad = torch.as_tensor(A.todense(), dtype=dtype, device=device)
        op = LinearOperator(
            gmv=lambda x, Ad=Ad: torch.einsum("nk,skm->snm", Ad, x))
        b = torch.as_tensor(np.asarray(rhs)[None, :, None], dtype=dtype,
                            device=device)
        total_g += int(solve(op, b, opt=opt_g).iterations)
        total_r += int(solve(op, b, opt=opt_r).iterations)
    return total_g, total_r, (restart, recycle, tol)


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.options import Options

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("device=(cuda|cpu)", "Device of the dense products.")]
    opt = Options.parse(argv, display=True, app_options=app)
    device = as_device(opt.app().get("device", DEFAULT))
    total_g, total_r, (restart, recycle, tol) = totals(opt, device)
    print(f"total iterations: GMRES({restart}) = {total_g}, "
          f"GCRODR({restart},{recycle}) = {total_r}")
    if not total_r < total_g:
        return 1
    # the reference-derived windows hold only at the recorded
    # configuration in f64; other configurations still enforce
    # recycling-beats-GMRES
    if not (restart == 40 and recycle == 20 and tol == 1e-10
            and opt.val("variant") in (None, "right")):
        return 0
    if abs(total_g - REF_GMRES) > 10:
        return 1
    if (opt.val("recycle_strategy") or "A") == "A":
        return 0 if abs(total_r - REF_GCRODR_A) <= 25 else 1
    # B: the JAX package's strategy B converges faster; one-sided window
    return 0 if 0.7 * REF_GCRODR_B <= total_r <= REF_GCRODR_B + 10 else 1


if __name__ == "__main__":
    sys.exit(main())
