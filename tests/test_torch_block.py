"""Port vs JAX package: the block Krylov methods on the CPU in f64.

BGMRES (right, left, flexible), BCG and BFBCG, and the ``-hpddm_qr``
cholqr / cgs / mgs sweep of BGMRES and BFBCG (the JAX package's
tests/test_option_sweeps.py:133-157), each on identical operators (the
JAX-built two-level GenEO-RAS state at 40x40, S=4, carried over by
``interop``) with four numpy-seeded consistent right-hand sides. Iteration
counts per right-hand side must be equal, and the solutions agree at rtol
1e-8 / atol 1e-10.
"""

import numpy as np
import pytest
import torch

from hpddm_tpu.solvers.block import _chol_qr as jax_chol_qr
from hpddm_tpu.solvers.block import _gs_qr as jax_gs_qr
from hpddm_tpu.solvers.krylov import make_operator as jax_make_operator

import jax.numpy as jnp

from hpddm_tpu_torch.solvers.block import _chol_qr, _gs_qr
from hpddm_tpu_torch.solvers.krylov import make_operator
from test_torch_krylov import compare, problem, states  # noqa: F401


@pytest.fixture(scope="module")
def ras(problem):  # noqa: F811
    sch, f4, _ = problem
    return states(sch) + (f4,)


@pytest.mark.parametrize("variant", ["right", "left", "flexible"])
def test_bgmres_variants(ras, variant):
    jstate, state, f4 = ras
    compare(jstate, state, f4, tol=1e-6, krylov_method="bgmres",
            variant=variant)


@pytest.mark.parametrize("method", ["bcg", "bfbcg"])
def test_block_cg(ras, method):
    jstate, state, f4 = ras
    compare(jstate, state, f4, tol=1e-6, krylov_method=method)


@pytest.mark.parametrize("qr", ["cholqr", "cgs", "mgs"])
@pytest.mark.parametrize("method", ["bgmres", "bfbcg"])
def test_qr_sweep(ras, method, qr):
    """The QR variants drive both block methods at tol 1e-8 to the JAX
    package's counts and solutions."""
    jstate, state, f4 = ras
    compare(jstate, state, f4, tol=1e-8, max_it=300, krylov_method=method,
            qr=qr)


@pytest.mark.parametrize("kind", ["cholqr", "cgs", "mgs"])
def test_block_qr_matches_jax(ras, kind):
    """The distributed QR of a rank-deficient block (a repeated column):
    Q and R at rtol 1e-10 / atol 1e-12, the dependent column zeroed (or
    neutralized by the pseudo-inverse) by both."""
    jstate, state, f4 = ras
    V = np.concatenate([f4, f4[:, :, :1]], axis=2)
    jop, op = jax_make_operator(jstate), make_operator(state)
    if kind == "cholqr":
        (jq, jr), (q, r) = jax_chol_qr(jop, jnp.asarray(V)), \
            _chol_qr(op, torch.as_tensor(V))
    else:
        (jq, jr), (q, r) = jax_gs_qr(jop, jnp.asarray(V), kind), \
            _gs_qr(op, torch.as_tensor(V), kind)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(jr)).max())
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-10,
                               atol=1e-10)
