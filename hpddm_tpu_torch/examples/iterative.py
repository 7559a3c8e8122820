#!/usr/bin/env python
"""Krylov with a user host preconditioner, the port's twin of
``examples/iterative.py`` (the reference's examples/iterative.py): load a
dumped matrix and precondition GMRES with scipy's spilu through a host
function (the Python-callback preconditioner path, hpddm.py:118-231);
exits 0 when GMRES takes at most 50 iterations to a residual of at most
1e-4 (iterative.py:100-119).

    python -m hpddm_tpu_torch.examples.iterative -matrix_filename dump.txt \\
        [-device cuda|cpu]

With no file argument it generates the 2D diffusion matrix and dumps it
first (the schwarz.cpp -hpddm_dump_matrices workflow), to a temporary
directory removed at exit. The operator is the dense matrix on the
device; each preconditioner apply copies the vector to the host, runs the
incomplete LU there and copies the result back.
"""

import os
import sys
import tempfile

import numpy as np
import torch


def main(argv=None):
    import scipy.sparse.linalg as spla

    from hpddm_tpu_torch.core.csr import MatrixCSR
    from hpddm_tpu_torch.device import DEFAULT, as_device
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.base import LinearOperator
    from hpddm_tpu_torch.solvers.gmres import gmres

    argv = list(sys.argv[1:] if argv is None else argv)
    opt = Options.parse(argv, display=True, app_options=[
        ("matrix_filename=<input_file>", "Matrix file."),
        ("device=(cuda|cpu)", "Device of the operator.")])
    device = as_device(opt.app().get("device", DEFAULT))
    path = opt.app().get("matrix_filename")
    with tempfile.TemporaryDirectory() as tmp:
        if not isinstance(path, str) or not path:
            # dump-then-reload round trip (-hpddm_dump_matrices)
            from hpddm_tpu_torch.models import diffusion2d
            gen = diffusion2d.generate(1, 50, 50)
            path = os.path.join(tmp, "hpddm_tpu_torch_dump.txt")
            gen.mats[0].dump(path)
            print(f"dumped generated matrix to {path}")
        A = MatrixCSR.from_file(path)
    csr = A.scipy()
    n = A.n
    ilu = spla.spilu(csr.tocsc(), drop_tol=1e-4, fill_factor=10)

    def ilu_apply(x):
        # host preconditioner: the analogue of the reference's Python
        # callback into HPDDM's Krylov loop
        v = x.cpu().numpy()
        out = np.empty_like(v)
        for j in range(v.shape[-1]):
            out[0, :, j] = ilu.solve(v[0, :, j])
        return torch.as_tensor(out, device=x.device)

    Ad = torch.as_tensor(A.dense(), device=device)
    op = LinearOperator(gmv=lambda x: torch.einsum("nk,skm->snm", Ad, x),
                        apply=ilu_apply)
    rng = np.random.default_rng(0)
    b = rng.normal(size=(1, n, 1))
    res = gmres(op, torch.as_tensor(b, device=device), tol=1e-6, restart=40,
                max_it=int(opt.val("max_it", 100)))
    x = res.x.cpu().numpy()[0, :, 0]
    rel = np.linalg.norm(b[0, :, 0] - csr @ x) / np.linalg.norm(b)
    print(f"iterations: {int(res.iterations)}, residual: {rel:.3e}")
    return 0 if (int(res.iterations) <= 50 and rel <= 1e-4) else 1


if __name__ == "__main__":
    sys.exit(main())
