"""2D Helmholtz test problem with ORAS optimized interface conditions
(counterpart of ``hpddm_tpu/models/helmholtz.py``, byte-equal to it).

The reference's ORAS path factorizes a *user-supplied* optimized local
matrix instead of the plain restriction (``Schwarz::callNumfact`` with the
user matrix, HPDDM_schwarz.hpp:337-368); the classic choice for Helmholtz
is a zeroth-order (Robin) absorbing condition i*k on the artificial
interface. This model builds:

* local matrices A_s = (5-point Laplacian) - (k^2 + i*eps*k^2) I on the
  overlapping decomposition of models/diffusion2d, in complex scalars (the
  reference templates over K in {complex<float>, complex<double>});
* optimized ORAS matrices A_s + i*k/h * diag(artificial boundary), where
  the artificial boundary is exactly the zero set of the analytic POU (the
  outermost overlap layer).

``as_real=True`` returns the equivalent real-pair problem: each complex
local system A z = f becomes [[Re A, -Im A], [Im A, Re A]] [Re z; Im z] =
[Re f; Im f], with mappings and POU doubled. The JAX package needs it on
the TPU, which has no complex type; on the card it is the second route,
measured beside the native complex one.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.models import diffusion2d


def generate(size_world: int, Nx: int = 100, Ny: int = 100,
             overlap: int = 1, k: float = 6.0, eps: float = 0.05,
             dtype=np.complex128, as_real: bool = False):
    """A ``diffusion2d.Generated`` with complex matrices and an extra
    attribute ``oras_mats``; with ``as_real`` the real-pair form (module
    docstring) in the corresponding real dtype."""
    gen = diffusion2d.generate(size_world, Nx, Ny, overlap=overlap,
                               dtype=np.float64)
    h = 10.0 / Nx
    shift = k * k * (1.0 + 1j * eps)
    oras_mats = []
    for s in range(size_world):
        A = gen.mats[s].scipy().astype(dtype)
        A = A - shift * sp.identity(A.shape[0], dtype=dtype, format="csr")
        gen.mats[s] = MatrixCSR(A)
        # Robin i*k on the artificial boundary (the POU's zero set):
        # interior subdomain edges only, the physical boundary keeps
        # Dirichlet
        robin = (np.asarray(gen.d[s]) < 1e-12).astype(np.float64)
        Aop = A + 1j * k / h * sp.diags(robin).astype(dtype)
        oras_mats.append(MatrixCSR(sp.csr_matrix(Aop)))
        gen.f[s] = gen.f[s].astype(dtype)
    gen.oras_mats = oras_mats
    if as_real:
        return _realify(gen, size_world,
                        np.float32 if dtype == np.complex64 else np.float64)
    return gen


def _realify(gen, S: int, rdt):
    """The complex decomposition as its real pair: dofs double (block
    layout [Re; Im] per subdomain), every mapping slot m becomes (m,
    m + n_loc), the POU duplicates, and solutions read back as
    z = x[:n] + i x[n:]."""
    def rmat(M):
        A = M.scipy(expand=True).tocsr()
        R = sp.bmat([[A.real, -A.imag], [A.imag, A.real]], format="csr")
        return MatrixCSR(sp.csr_matrix(R, dtype=rdt))

    n_loc = [m.n for m in gen.mats]
    gen.oras_mats = [rmat(m) for m in gen.oras_mats]
    gen.mats = [rmat(m) for m in gen.mats]
    gen.mappings = [[np.concatenate([np.asarray(m),
                                     np.asarray(m) + n_loc[s]])
                     for m in gen.mappings[s]] for s in range(S)]
    gen.d = [np.concatenate([np.asarray(ds), np.asarray(ds)])
             for ds in gen.d]
    gen.f = [np.concatenate([np.real(fv), np.imag(fv)]).astype(rdt)
             for fv in gen.f]
    gen.n_loc = [2 * n for n in n_loc]
    return gen
