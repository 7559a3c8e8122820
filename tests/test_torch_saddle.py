"""Port vs JAX package on the CPU in f64: MAC Stokes and the
Schur-complement saddle-point solver (``models/stokes2d.py``,
``precond/saddle.py``), at ``tests/test_saddle.py``'s sizes (N=24, S=4,
overlap 2, inner tol 1e-10, outer tol 1e-8).

* ``stokes2d.assemble`` and ``generate``'s decomposition and Neumann
  matrices equal the JAX package's arrays exactly.
* ``SaddleSolver`` takes the JAX package's outer and accumulated inner
  counts, with u and p to 1e-8, one-level and with GenEO nu=8 inner
  solves (``tests/test_saddle.py:26,49``); the block residuals hold
  ``tests/test_saddle.py``'s bounds and the bordered direct KKT solve's
  solution.
* The driver twin ``examples/stokes.py`` runs at -device cpu and exits 0.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from hpddm_tpu.models import stokes2d as jax_stokes
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond.saddle import SaddleSolver as JaxSaddle

from hpddm_tpu_torch.examples import stokes as twin
from hpddm_tpu_torch.models import stokes2d
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond.saddle import SaddleSolver

N, S = 24, 4


def _same_csr(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return (np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.fixture(scope="module")
def gens():
    return (jax_stokes.generate(S, N=N, overlap=2, with_neumann=True),
            stokes2d.generate(S, N=N, overlap=2, with_neumann=True))


def test_assembly_and_decomposition_equal_jax(gens):
    A, B, f, g, h = stokes2d.assemble(N)
    jA, jB, jf, jg, jh = jax_stokes.assemble(N)
    assert _same_csr(A, jA) and _same_csr(B, jB) and h == jh
    assert np.array_equal(f, jf) and np.array_equal(g, jg)
    (jgen, *_, jneu), (gen, *_, neu) = gens
    assert gen.n_loc == jgen.n_loc and np.array_equal(gen.owner,
                                                      jgen.owner)
    for s in range(S):
        assert np.array_equal(gen.gids[s], jgen.gids[s])
        assert np.array_equal(gen.d[s], jgen.d[s])
        assert _same_csr(gen.mats[s].scipy(), jgen.mats[s].scipy())
        assert _same_csr(neu[s].scipy(), jneu[s].scipy())


def _direct(A, B, f, g):
    """Bordered KKT solve with the zero-mean pressure constraint."""
    n_vel, n_p = A.shape[0], B.shape[0]
    e = np.ones((n_p, 1))
    K = sp.bmat([[A, B.T, None], [B, None, e], [None, e.T, None]],
                format="csc")
    sol = spla.spsolve(K, np.concatenate([f, g, [0.0]]))
    return sol[:n_vel], sol[n_vel: n_vel + n_p]


@pytest.mark.parametrize("nu", [0, 8])
def test_saddle_counts_and_solution_equal_jax(gens, nu):
    kw = dict(tol=1e-10, max_it=400)
    if nu:
        kw.update(schwarz_coarse_correction="deflated", geneo_nu=nu)
    (jgen, jB, jf, jgg, _, jneu), (gen, B, f, g, h, neu) = gens
    jres = JaxSaddle(jgen, jB, options=JaxOptions(**kw),
                     neumann=jneu if nu else None).solve(jf, jgg, tol=1e-8)
    res = SaddleSolver(gen, B, options=Options(**kw),
                       neumann=neu if nu else None,
                       device="cpu").solve(f, g, tol=1e-8)
    assert (res.outer_iterations, res.inner_iterations) == \
        (jres.outer_iterations, jres.inner_iterations)
    assert res.outer_iterations < 80 and res.rel_res <= 1e-8
    np.testing.assert_allclose(res.u, jres.u, rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.p, jres.p, rtol=0, atol=1e-8)
    r1 = gen.A_global @ res.u + B.T @ res.p - f
    r2 = B @ res.u - g
    assert np.linalg.norm(r1) / np.linalg.norm(f) < 1e-6
    assert np.linalg.norm(r2) < 1e-6 * np.linalg.norm(res.u) / h
    u_d, p_d = _direct(gen.A_global, B, f, g)
    assert np.linalg.norm(res.u - u_d) / np.linalg.norm(u_d) < 1e-6
    pd0 = p_d - p_d.mean()
    assert np.linalg.norm(res.p - pd0) / max(np.linalg.norm(pd0), 1) < 1e-5


def test_stokes_twin_runs_on_cpu(capsys):
    assert twin.main(["-N", "4", "-Nc", "16", "-device", "cpu"]) == 0
    assert "Schur CG" in capsys.readouterr().out
