#!/usr/bin/env python
"""Single-domain direct re-solve of a dumped matrix, the port's twin of
``examples/solver.py`` (the sizeWorld == 1 branch of schwarz.cpp:149-185):
load, factorize with the batched local solver
(``-hpddm_local_solver``), check the residual; exits 0 when it is at most
1e-6 in f64 (1e-2 below).

    python -m hpddm_tpu_torch.examples.solver -matrix_filename dump.txt \\
        [-device cuda|cpu]

With no file argument it generates a 2D diffusion matrix and dumps it
first, to a temporary directory removed at exit.
"""

import os
import sys
import tempfile

import numpy as np
import torch


def main(argv=None):
    from hpddm_tpu_torch.core.csr import MatrixCSR
    from hpddm_tpu_torch.core.formats import (batched_dense_from,
                                              pack_local_matrices)
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.ops.local_solve import factorize
    from hpddm_tpu_torch.options import Options

    argv = list(sys.argv[1:] if argv is None else argv)
    opt = Options.parse(argv, display=True, app_options=[
        ("matrix_filename=<input_file>", "Matrix file."),
        ("device=(cuda|cpu)", "Device of the factorization.")])
    device = as_device(opt.app().get("device", DEFAULT))
    path = opt.app().get("matrix_filename")
    with tempfile.TemporaryDirectory() as tmp:
        if not isinstance(path, str) or not path:
            from hpddm_tpu_torch.models import diffusion2d
            gen = diffusion2d.generate(1, 40, 40)
            path = os.path.join(tmp, "hpddm_tpu_torch_dump.txt")
            gen.mats[0].dump(path)
        A = MatrixCSR.from_file(path)
    Ad = batched_dense_from(pack_local_matrices([A], fmt="dense",
                                                device=device))
    solver = factorize(Ad, kind=opt.val("local_solver"))
    rng = np.random.default_rng(0)
    b = rng.normal(size=(1, A.n, 1))
    x = solver.solve(torch.as_tensor(b, device=device)).cpu().numpy()
    rel = (np.linalg.norm(b[0, :, 0] - A.scipy() @ x[0, :, 0])
           / np.linalg.norm(b))
    print(f"residual: {rel:.3e}")
    tol = 1e-6 if x.dtype == np.float64 else 1e-2
    return 0 if rel <= tol else 1


if __name__ == "__main__":
    sys.exit(main())
