"""Port vs JAX package on the CPU in f64: the dense Schwarz variant
(``precond/dense.py``, HPDDM_dense.hpp), at ``tests/test_dense_variant.py``'s
sizes (``diffusion2d.generate(4, 30, 30)``, GMRES(60), tol 1e-8).

* One level through the dense blocks' bmm and scaled exchange: the JAX
  package's count and x to 1e-8.
* A user GMV (another DenseSchwarz's gmv) with the standard-EVP coarse
  space (nu=5) and the deflated correction: the JAX package's count, the
  deflation vectors' spans (principal-angle cosines >= 1 - 1e-10), E to
  1e-12 and x to 1e-8; then the balanced correction, and the port's sparse
  ``Schwarz.gmv`` as the user GMV, in the same count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond.dense import DenseSchwarz as JaxDense
from hpddm_tpu.solvers.gmres import gmres as jax_gmres

from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.precond.dense import DenseSchwarz
from hpddm_tpu_torch.solvers.gmres import gmres

S = 4
GM = dict(tol=1e-8, restart=60, max_it=200)


def _rel(op, d, f, x):
    r = f - op.gmv(x)
    return float(torch.sqrt(torch.sum(d[:, :, None] * r ** 2))
                 / torch.sqrt(torch.sum(d[:, :, None] * f ** 2)))


@pytest.fixture(scope="module")
def gens():
    return (jax_d2.generate(S, 30, 30, overlap=1),
            diffusion2d.generate(S, 30, 30, overlap=1))


def _jax_solve(gen, evp, correction="deflated"):
    kw = dict(schwarz_coarse_correction=correction, geneo_nu=5) \
        if evp else {}
    blocks = [m.dense() for m in gen.mats]
    user = None
    if evp:
        inner = JaxDense(blocks, gen.neighbors, gen.mappings, d=gen.d)
        user = inner.gmv
    ds = JaxDense(blocks, gen.neighbors, gen.mappings, d=gen.d,
                  options=JaxOptions(**kw), user_gmv=user)
    if evp:
        ds.solve_evp()
    op = ds.build()
    res = jax_gmres(op, jnp.asarray(diffusion2d.padded_rhs(gen.f, ds.n_max)),
                    **GM)
    return ds, res


def _port_solve(gen, evp, correction="deflated", sparse_gmv=False):
    kw = dict(schwarz_coarse_correction=correction, geneo_nu=5) \
        if evp else {}
    blocks = [m.dense() for m in gen.mats]
    user = None
    if evp and sparse_gmv:
        state = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                           device="cpu").operator_state()
        user = lambda x: sz.gmv(state, x)                    # noqa: E731
    elif evp:
        user = DenseSchwarz(blocks, gen.neighbors, gen.mappings, d=gen.d,
                            device="cpu").gmv
    ds = DenseSchwarz(blocks, gen.neighbors, gen.mappings, d=gen.d,
                      options=Options(**kw), user_gmv=user, device="cpu")
    if evp:
        ds.solve_evp()
    op = ds.build()
    f = torch.as_tensor(diffusion2d.padded_rhs(gen.f, ds.n_max))
    res = gmres(op, f, **GM)
    assert _rel(op, ds.dec.d, f, res.x) < 1e-6
    return ds, res


def test_one_level_matches_jax(gens):
    _, jres = _jax_solve(gens[0], evp=False)
    ds, res = _port_solve(gens[1], evp=False)
    assert ds._state.coarse is None
    assert int(res.iterations) == int(jres.iterations) <= 60
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-8)


def test_user_gmv_evp_deflated_matches_jax(gens):
    jds, jres = _jax_solve(gens[0], evp=True)
    ds, res = _port_solve(gens[1], evp=True)
    assert int(res.iterations) == int(jres.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-8)
    for v, jv in zip(ds._deflation, jds._deflation):
        cos = np.linalg.svd(v.T @ jv, compute_uv=False)
        assert cos.min() >= 1 - 1e-10
    co = ds._state.coarse
    E = torch.linalg.inv(co.E_inv).numpy()
    jE = np.linalg.inv(np.asarray(jds._state.coarse.E_inv))
    # the EVP's vectors are each package's own eigenvectors (their signs
    # and rotations inside a repeated eigenvalue may differ): compare E on
    # the port's vectors through the JAX package's assembly
    jds.set_vectors(ds._deflation)
    jE_same = np.linalg.inv(np.asarray(jds._build_coarse("deflated").E_inv))
    np.testing.assert_allclose(E, jE_same, rtol=0,
                               atol=1e-12 * np.abs(jE).max())


@pytest.mark.parametrize("correction,sparse", [("balanced", False),
                                               ("deflated", True)],
                         ids=["balanced", "sparse gmv"])
def test_other_corrections_and_gmv(gens, correction, sparse):
    _, ref = _port_solve(gens[1], evp=True)
    ds, res = _port_solve(gens[1], evp=True, correction=correction,
                          sparse_gmv=sparse)
    if sparse:
        assert int(res.iterations) == int(ref.iterations)
    else:
        _, jres = _jax_solve(gens[0], evp=True, correction=correction)
        assert int(res.iterations) == int(jres.iterations)
