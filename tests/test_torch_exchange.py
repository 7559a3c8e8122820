"""Port vs JAX package: the general-path exchange on the CPU.

``exchange`` and ``scaled_exchange`` must be bitwise equal to the JAX
package's general path: bitwise reproducibility is the JAX package's own
contract for the exchange (``parallel/ops.py:184-190``), and the port keeps
its gather / partner-add / scatter order. The weighted reductions only sum
in another order, so they are held at rtol 1e-13 (f64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.parallel import ops as jax_ops
from hpddm_tpu.parallel.decomposition import Decomposition as JaxDec

from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.parallel import ops
from hpddm_tpu_torch.parallel.decomposition import Decomposition

CONFIGS = [(4, 40, 40), (6, 30, 30), (2, 100, 60), (9, 36, 36)]


def _decs(S, Nx, Ny):
    rg = jax_d2.generate(S, Nx, Ny, overlap=1)
    g = diffusion2d.generate(S, Nx, Ny, overlap=1)
    return (JaxDec.from_subdomains(rg.neighbors, rg.mappings, rg.n_loc,
                                   d=rg.d),
            Decomposition.from_subdomains(g.neighbors, g.mappings, g.n_loc,
                                          d=g.d, device="cpu"))


@pytest.mark.parametrize("mu", [1, 3])
@pytest.mark.parametrize("S,Nx,Ny", CONFIGS)
def test_exchange_bitwise(S, Nx, Ny, mu):
    ref, dec = _decs(S, Nx, Ny)
    x = np.random.default_rng(S + 10 * mu).normal(size=(S, dec.n_max, mu))
    for fn, jfn in ((ops.exchange, jax_ops.exchange),
                    (ops.scaled_exchange, jax_ops.scaled_exchange)):
        got = fn(dec, torch.as_tensor(x))
        want = np.asarray(jfn(ref, jnp.asarray(x)))
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,Nx,Ny", CONFIGS[:2])
def test_exchange_of_consistent_vector_is_identity(S, Nx, Ny):
    """sum_q R_q^T D_q R_q = I: the scaled exchange of a consistent vector
    returns it (to rounding: the POU sums to one in f64)."""
    _, dec = _decs(S, Nx, Ny)
    x = np.random.default_rng(0).normal(size=(S, dec.n_max, 2))
    xc = ops.scaled_exchange(dec, torch.as_tensor(x))
    np.testing.assert_allclose(ops.scaled_exchange(dec, xc).numpy(),
                               xc.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("S,Nx,Ny", CONFIGS[:2])
def test_weighted_reductions(S, Nx, Ny):
    ref, dec = _decs(S, Nx, Ny)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(S, dec.n_max, 2))
    y = rng.normal(size=(S, dec.n_max, 2))
    V = rng.normal(size=(3, S, dec.n_max, 2))
    tx, ty, tV = (torch.as_tensor(a) for a in (x, y, V))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(ops.weighted_dot(dec, tx, ty).numpy(),
                               np.asarray(jax_ops.weighted_dot(ref, jx, jy)),
                               rtol=1e-13)
    np.testing.assert_allclose(ops.weighted_norm_sq(dec, tx).numpy(),
                               np.asarray(jax_ops.weighted_norm_sq(ref, jx)),
                               rtol=1e-13)
    # the JAX package's weighted_gram broadcasts d to 4-D and cannot run
    # (ROADMAP queue C, C4); hold the port's against its formula in numpy
    d = np.asarray(ref.d)
    np.testing.assert_allclose(ops.weighted_gram(dec, tV, ty).numpy(),
                               np.einsum("ksnm,snm->km", V, d[:, :, None] * y),
                               rtol=1e-13)


@pytest.mark.parametrize("S,Nx,Ny", CONFIGS[:2])
def test_write_back_matches_merge_scatter(S, Nx, Ny):
    """B6: the JAX package's Pallas write-back kernel (``merge_scatter``,
    interpret mode) and the port's write-back stage of the exchange
    (``_scatter_rows``) put the same slot values at the same positions:
    bitwise. Invalid slots point past the end and are dropped by both."""
    from hpddm_tpu.ops.pallas_exchange import ScatterPlan, merge_scatter
    _, dec = _decs(S, Nx, Ny)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(S, dec.n_max, 1))
    vals = rng.normal(size=(S, dec.m_max, 1))
    total = S * dec.n_max
    pos = (np.arange(S)[:, None] * dec.n_max + dec.if_idx.numpy())
    pos = np.where(dec.if_mask.numpy(), pos, total)
    plan = ScatterPlan.build(pos.reshape(-1), total, block_rows=8)
    want = np.asarray(merge_scatter(plan, jnp.asarray(x.reshape(-1)),
                                    jnp.asarray(vals.reshape(-1)),
                                    interpret=True))
    got = ops._scatter_rows(dec, torch.as_tensor(x), torch.as_tensor(vals))
    assert got.numpy().reshape(-1).tobytes() == want.tobytes()
