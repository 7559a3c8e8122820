"""Sequences of related linear systems (recycling workloads; counterpart
of ``hpddm_tpu/models/sequences.py``, kept byte-equal to it).

The reference's GCRO-DR example workload is a sequence of ~400 related
fracture-mechanics systems solved one after another with subspace
recycling (examples/driver.cpp:9-12). This module synthesizes an analogous
family: 2D heterogeneous diffusion with a smoothly drifting coefficient
field — consecutive systems share spectral structure, so recycled
deflation spaces transfer. Used by the driver twin
hpddm_tpu_torch/examples/driver.py; the JAX package's parity harness
(tools/refparity.py) feeds the *same* matrices to the reference binary.
"""

import numpy as np


def drifting_diffusion(n_sys=10, nx=45, ny=45, seed=7, mass=0.1):
    """SPD 5-point FV diffusion sequence with drifting coefficients.

    Returns a list of ``(A_csr, rhs)`` with ``n = nx * ny`` unknowns.
    Face coefficients are harmonic means of a lognormal field ``base``
    blended toward ``base * (1 + 0.5 * bump)`` as the sequence index
    advances; ``mass`` adds a lumped zeroth-order term that sets the
    conditioning. The RHS is fixed across the sequence (driver.cpp reuses
    one rhs layout per file)."""
    import scipy.sparse as sp

    n = nx * ny
    rng = np.random.default_rng(seed)
    base = np.exp(rng.normal(scale=0.8, size=(ny, nx)))
    bump = np.exp(rng.normal(scale=0.8, size=(ny, nx)))
    rhs = rng.normal(size=n)
    systems = []
    for i in range(n_sys):
        t = i / max(n_sys - 1, 1)
        kappa = base * (1.0 + 0.5 * t * bump)
        kx = 2.0 / (1.0 / kappa[:, :-1] + 1.0 / kappa[:, 1:])   # (ny, nx-1)
        ky = 2.0 / (1.0 / kappa[:-1, :] + 1.0 / kappa[1:, :])   # (ny-1, nx)
        e = np.zeros((ny, nx)); e[:, :-1] = kx
        w = np.zeros((ny, nx)); w[:, 1:] = kx
        s = np.zeros((ny, nx)); s[:-1, :] = ky
        nn = np.zeros((ny, nx)); nn[1:, :] = ky
        diag = (e + w + s + nn).ravel() + mass
        A = sp.diags(
            [-w.ravel()[1:], diag, -e.ravel()[:-1],
             -nn.ravel()[nx:], -s.ravel()[:-nx]],
            [-1, 0, 1, -nx, nx], format="csr")
        systems.append((A, rhs))
    return systems
