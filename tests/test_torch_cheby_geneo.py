"""Port vs JAX package on the CPU in f64: Lanczos GenEO with the DST inner
solve and ORAS on optimized matrices, each with ``dst_cheby`` local solves
(slice 5d), iteration counts, on the cases and rules of
tests/test_torch_fft_cheby_schwarz.py:

* Lanczos GenEO (nu=12) with the DST-preconditioned inner CG and
  ``dst_cheby`` local solves at ``generate_uniform(4, 128, 128)``, contrast
  1e4, 24 steps (``tests/test_cheby.py:66``): the pencil's eigenvalues at
  rtol 1e-8 and the two-level count; ``solve_gevp``'s "auto" takes Lanczos
  for ``dst_cheby``;
* ORAS with ``dst_cheby`` on optimized local matrices (a real Robin term
  on the artificial boundary), whose packed matrices are the Chebyshev
  operator.
"""

import numpy as np
import torch

from hpddm_tpu.precond import schwarz as jax_sz

from hpddm_tpu_torch.precond import schwarz as sz
from test_torch_fft_cheby_schwarz import (_assert_counts,  # noqa: F401
                                          _fast_jax_compiles, _run,
                                          kappa_channel)


def test_lanczos_geneo_with_dst_cheby(monkeypatch):
    """Lanczos GenEO (DST-preconditioned inner CG) with dst_cheby local
    solves: "auto" takes Lanczos, and the pencil's eigenvalues and the
    two-level count are the JAX package's."""
    lams = {}
    for mod in (jax_sz.Schwarz, sz.Schwarz):
        real = mod._solve_gevp_lanczos

        def spy(self, neumann, nu_max, _real=real, _mod=mod):
            lam, V = _real(self, neumann, nu_max)
            lams[_mod] = np.asarray(lam.numpy() if torch.is_tensor(lam)
                                    else lam)
            return lam, V
        monkeypatch.setattr(mod, "_solve_gevp_lanczos", spy)
    out = _run("dst_cheby", kappa_channel, 24, nu=12)
    _assert_counts(out)
    assert out["jits"] <= 25            # tests/test_cheby.py:88
    np.testing.assert_allclose(lams[sz.Schwarz], lams[jax_sz.Schwarz],
                               rtol=1e-8)
    assert "lanczos_steps" in out["sch"].timings


def test_oras_dst_cheby_on_optimized_matrices():
    out = _run("dst_cheby", kappa_channel, 24, variant="oras",
               optimized=True)
    _assert_counts(out)
    st = out["state"]
    # the Chebyshev operator is the packed optimized matrices, not A
    assert not torch.equal(st.solver.A.values, st.A.values)
