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

