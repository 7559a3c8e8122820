#!/usr/bin/env python
"""Saddle-point driver of the port, the twin of ``examples/stokes.py``:
lid-driven MAC Stokes solved by the Schur-complement CG with DD inner
solves (PCHPDDM's -pc_hpddm_schur_precondition counterpart,
interface/petsc/pc/pchpddm.cxx:21):

    python -m hpddm_tpu_torch.examples.stokes -N 4 -Nc 32 \
        [-hpddm_schwarz_coarse_correction deflated -hpddm_geneo_nu 8] \
        [-device cuda|cpu]

Exits non-zero unless the outer Schur residual reaches -stol, both block
residuals are below 1e-5 and the outer CG takes fewer than 100
iterations.
"""

import sys

import numpy as np


def main(argv=None):
    from hpddm_tpu_torch.device import DEFAULT
    from hpddm_tpu_torch.models import stokes2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.saddle import SaddleSolver

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<4>", "Number of subdomains."),
           ("Nc=<32>", "Cells per direction."),
           ("stol=<1e-8>", "Outer Schur tolerance."),
           ("device=(cuda|cpu)", "Device of the batched subdomains.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S = int(opt.app()["N"])
    Nc = int(opt.app()["Nc"])
    stol = float(opt.app()["stol"])
    device = opt.app().get("device", DEFAULT)
    if not opt.set("tol"):
        opt["tol"] = 1e-10          # inner solves well below the outer
    if not opt.set("max_it"):
        opt["max_it"] = 400

    geneo = opt.set("schwarz_coarse_correction")
    gen, B, f, g, h, *rest = stokes2d.generate(S, N=Nc, overlap=2,
                                               with_neumann=geneo)
    neumann = rest[0] if rest else None
    sv = SaddleSolver(gen, B, options=opt, neumann=neumann, device=device)
    res = sv.solve(f, g, tol=stol)

    r1 = gen.A_global @ res.u + B.T @ res.p - f
    r2 = B @ res.u - g
    rel1 = np.linalg.norm(r1) / max(np.linalg.norm(f), 1e-30)
    rel2 = np.linalg.norm(r2) / max(np.linalg.norm(res.u) / h, 1e-30)
    print(f"Schur CG: {res.outer_iterations} outer its "
          f"({res.inner_iterations} inner), rel S-res {res.rel_res:.3e}")
    print(f" --- momentum residual = {rel1:.6e}")
    print(f" --- divergence residual = {rel2:.6e}")
    ok = (res.rel_res <= stol and rel1 < 1e-5 and rel2 < 1e-5
          and res.outer_iterations < 100)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
