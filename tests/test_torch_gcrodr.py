"""Port vs JAX package: GCRO-DR with subspace recycling on the CPU in f64.

Pseudo-block ``gcrodr`` (strategies A and B, right and left, mu=4 and
mu=1, ``-hpddm_recycle_same_system``) and the block ``bgcrodr`` (with and
without ``-hpddm_deflation_tol``), each as a sequence of two solves through
one ``Options`` object per package, so that the second solve starts from
the space the first one stored (``Options.storage``). Identical operators
(the JAX-built two-level GenEO-RAS state at 40x40, S=4, carried over by
``interop``) and numpy-seeded right-hand sides. At restart 5 the first
solve runs several cycles and builds the recycled space, and the second
one starts from it. Iteration counts per right-hand side must be equal in
both solves, and the solutions agree at rtol 1e-8 / atol 1e-10.

The recycle sizes are chosen where the JAX package is itself stable: for
strategy B and for the block method at recycle >= 2, the harmonic Ritz
selection at this size is ill-conditioned, and a 1e-15 relative change of
b moves the JAX package's own solution by 1e-8 to 4e-7 and its counts by
up to 5 iterations. There the two packages' rounding differences decide
the counts, so recycle 1 is used; at recycle 1 (and for strategy A at
recycle 3) the same change moves the solution by less than 1e-14.

The sequential ``bgcrodr`` (columns in turn on one recycled space, not
dispatched by ``solve``) is held to the JAX package's at
``tests/test_block_gcrodr.py``'s case.
"""

import numpy as np
import pytest
import torch

from hpddm_tpu.options import Options as JaxOptions

from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.solvers.krylov import solve
from test_torch_krylov import problem  # noqa: F401
from test_torch_krylov import ATOL, RTOL, jax_eager_solve, states


@pytest.fixture(scope="module")
def ras(problem):  # noqa: F811
    sch, f4, f1 = problem
    return states(sch) + (f4, f1)


def sequence(ras, f, **opts):
    """Two solves with one Options object per package; returns the port's
    iteration counts of both."""
    jstate, state, f4, f1 = ras
    f = {"f4": f4, "f1": f1}[f]
    jopt, opt = JaxOptions(**opts), Options(**opts)
    counts = []
    for _ in range(2):
        jres = jax_eager_solve(jstate, f, jopt)
        res = solve(state, torch.as_tensor(f), opt=opt)
        assert res.it_per_rhs.tolist() == \
            np.asarray(jres.it_per_rhs).tolist()
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                                   rtol=RTOL, atol=ATOL)
        assert (opt.storage() is None) == (jopt.storage() is None)
        counts.append(res.iterations)
    return counts


@pytest.mark.parametrize("method,f,recycle,opts", [
    ("gcrodr", "f4", 3, {}),
    ("gcrodr", "f4", 1, {"recycle_strategy": "B"}),
    ("gcrodr", "f4", 3, {"variant": "left"}),
    ("gcrodr", "f1", 3, {}),
    ("gcrodr", "f1", 3, {"recycle_same_system": 1}),
    ("bgcrodr", "f4", 1, {}),
    ("bgcrodr", "f4", 1, {"deflation_tol": 1e-4}),
])
def test_recycled_sequence(ras, method, f, recycle, opts):
    first, second = sequence(ras, f, tol=1e-6, krylov_method=method,
                             gmres_restart=5, recycle=recycle, **opts)
    if opts.get("recycle_strategy") != "B":
        assert second < first        # the recycled space pays off



def test_sequential_bgcrodr():
    """The sequential multi-RHS ``bgcrodr`` (``hpddm_tpu/solvers/
    gcrodr.py:360``) at ``tests/test_block_gcrodr.py:126``'s case: the 1D
    Laplacian (n=100), three right-hand sides solved in turn on one
    recycled space (restart 15, recycle 7, tol 1e-8): the JAX package's
    counts per right-hand side (its solve run op by op), later columns
    warm, solutions within 1e-10 relative of the JAX package's."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from hpddm_tpu.solvers.base import LinearOperator as JaxOperator
    from hpddm_tpu.solvers.gcrodr import bgcrodr as jax_bgcrodr

    from hpddm_tpu_torch.solvers.base import LinearOperator
    from hpddm_tpu_torch.solvers.gcrodr import bgcrodr

    n = 100
    A = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).toarray()
    b = np.random.default_rng(9).normal(size=(1, n, 3))
    kw = dict(tol=1e-8, restart=15, max_it=2000, recycle=7)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    with jax.disable_jit():
        jres = jax_bgcrodr(JaxOperator(
            gmv=lambda x: jnp.einsum("nk,skm->snm", Aj, x)),
            jnp.asarray(b), **kw)
    res = bgcrodr(LinearOperator(
        gmv=lambda x: torch.einsum("nk,skm->snm", At, x)),
        torch.as_tensor(b), **kw)
    its = res.it_per_rhs.tolist()
    assert its == np.asarray(jres.it_per_rhs).tolist()
    assert its[1] < its[0] and its[2] < its[0]
    assert res.iterations == max(its) and bool(res.converged.all())
    x, jx = res.x.numpy(), np.asarray(jres.x)
    assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()
    for j in range(3):
        r = b[0, :, j] - A @ x[0, :, j]
        assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b[0, :, j])
