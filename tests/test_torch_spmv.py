"""Port vs JAX package: the batched local SpMV on the CPU.

On CPU tensors the port's ``spmm`` runs the DIA kernel's plain version,
so ``dia_spmv.launches`` stays 0. It must match the JAX package's
``spmm`` and its Pallas kernel in interpret mode at atol 1e-11, the
tolerance of tests/test_pallas.py (same products, possibly another
summation order across diagonals: a few ulps of values ~1e3 in f64).
"""

import numpy as np
import pytest
import torch

from hpddm_tpu.core.formats import pack_local_matrices as jax_pack
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.ops.pallas_spmv import spmm_dia_pallas
from hpddm_tpu.ops.spmv import spmm as jax_spmm

from hpddm_tpu_torch.core.formats import (BatchedDIA, batched_dense_from,
                                          pack_local_matrices)
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.ops import dia_spmv as kmod
from hpddm_tpu_torch.ops.spmv import spmm

import jax.numpy as jnp


@pytest.mark.parametrize("mu", [1, 3])
@pytest.mark.parametrize("S,Nx,Ny", [(4, 40, 40), (2, 100, 60)])
def test_spmm_matches_jax_and_pallas(S, Nx, Ny, mu):
    ref_A = jax_pack(jax_d2.generate(S, Nx, Ny, overlap=1).mats)
    A = pack_local_matrices(diffusion2d.generate(S, Nx, Ny, overlap=1).mats,
                            device="cpu")
    n_max = A.n_max
    x = np.random.default_rng(S * 1000 + mu).normal(size=(S, n_max, mu))
    assert kmod.launches == 0
    y = spmm(A, torch.as_tensor(x)).numpy()
    assert kmod.launches == 0                 # CPU: plain version only
    y_ref = np.asarray(jax_spmm(ref_A, jnp.asarray(x)))
    y_pal = np.asarray(spmm_dia_pallas(ref_A, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(y, y_ref, atol=1e-11, rtol=0)
    np.testing.assert_allclose(y, y_pal, atol=1e-11, rtol=0)


@pytest.mark.parametrize("S,n,offsets", [
    (3, 1000, (-3, 0, 7)),            # n not a multiple of a block
    (2, 300, (-400, -1, 0, 350)),     # |offset| >= n
    (5, 77, (0,)),                    # a single diagonal
    (2, 51, (9,)),                    # a single shifted diagonal
    (2, 40, ()),                      # no diagonal
])
def test_dia_spmv_reference_matches_dense(S, n, offsets):
    """The plain version against a dense numpy product built from the same
    diagonals (f64: atol 1e-12 on values of order 1 with at most four
    terms per row)."""
    rng = np.random.default_rng(7)
    vals = rng.normal(size=(S, len(offsets), n))
    x = rng.normal(size=(S, n))
    dense = batched_dense_from(BatchedDIA(values=torch.as_tensor(vals),
                                          offsets=tuple(offsets), n_max=n))
    want = np.einsum("sij,sj->si", dense.numpy(), x)
    got = kmod.dia_spmv(torch.as_tensor(vals), torch.as_tensor(x), offsets)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)


def test_dia_spmv_cpu_is_plain_bitwise():
    rng = np.random.default_rng(3)
    vals = torch.as_tensor(rng.normal(size=(4, 5, 2601)))
    x = torch.as_tensor(rng.normal(size=(4, 2601)))
    offs = (-50, -1, 0, 1, 50)
    y = kmod.dia_spmv(vals, x, offs)
    assert kmod.launches == 0
    assert torch.equal(y, kmod.dia_spmv_reference(vals, x, offs))
    # the (S, n, mu) form of the plain version agrees column by column
    y3 = kmod.dia_spmv_reference(vals, x[:, :, None].repeat(1, 1, 2), offs)
    assert torch.equal(y3[:, :, 1], y)


def test_batched_dense_from_matches_jax():
    from hpddm_tpu.core.formats import batched_dense_from as jax_dense
    gen = diffusion2d.generate(4, 30, 30, overlap=1)
    A = pack_local_matrices(gen.mats, device="cpu")
    ref = np.asarray(jax_dense(jax_pack(jax_d2.generate(4, 30, 30,
                                                        overlap=1).mats)))
    assert batched_dense_from(A).numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(batched_dense_from(A, slice(1, 3)).numpy(),
                                  ref[1:3])


@pytest.mark.parametrize("S,Nx,Ny", [(4, 40, 40), (2, 100, 60)])
def test_dia_spmv_matches_whole_row_pallas_kernel(S, Nx, Ny):
    """B7: the JAX package's whole-row DIA kernel (``_dia_spmv_1rhs``,
    interpret mode) computes B1's function: the port's plain version of B1
    agrees at atol 1e-11, the tolerance of tests/test_pallas.py."""
    from hpddm_tpu.ops.pallas_spmv import _dia_spmv_1rhs
    A = pack_local_matrices(diffusion2d.generate(S, Nx, Ny, overlap=1).mats,
                            device="cpu")
    x = np.random.default_rng(S).normal(size=(S, A.n_max))
    want = np.asarray(_dia_spmv_1rhs(jnp.asarray(A.values.numpy()),
                                     jnp.asarray(x), A.offsets,
                                     interpret=True))
    got = kmod.dia_spmv_reference(A.values, torch.as_tensor(x), A.offsets)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-11, rtol=0)


@pytest.mark.parametrize("mu", [2, 3])
@pytest.mark.parametrize("S,Nx,Ny", [(4, 40, 40), (2, 100, 60)])
def test_dia_spmm_matches_panel_pallas_kernels(S, Nx, Ny, mu):
    """B2 and B3: the JAX package's panel kernels (``_dia_spmv_blocked_mu``
    through ``spmm_dia_pallas``, ``_dia_spmv_blocked_muT`` through
    ``spmm_dia_pallas_muT``, both in interpret mode) against the port's
    ``dia_spmm`` / ``dia_spmm_muT``, which take their plain versions on CPU
    tensors (no launch counted), at atol 1e-11 as B7's test."""
    from hpddm_tpu.ops.pallas_spmv import spmm_dia_pallas_muT
    ref_A = jax_pack(jax_d2.generate(S, Nx, Ny, overlap=1).mats)
    A = pack_local_matrices(diffusion2d.generate(S, Nx, Ny, overlap=1).mats,
                            device="cpu")
    x = np.random.default_rng(S * 100 + mu).normal(size=(S, A.n_max, mu))
    xT = np.ascontiguousarray(x.transpose(0, 2, 1))
    y = kmod.dia_spmm(A.values, torch.as_tensor(x), A.offsets)
    yT = kmod.dia_spmm_muT(A.values, torch.as_tensor(xT), A.offsets)
    assert kmod.spmm_launches == 0
    want = np.asarray(spmm_dia_pallas(ref_A, jnp.asarray(x), interpret=True))
    wantT = np.asarray(spmm_dia_pallas_muT(ref_A, jnp.asarray(xT),
                                           interpret=True))
    np.testing.assert_allclose(y.numpy(), want, atol=1e-11, rtol=0)
    np.testing.assert_allclose(yT.numpy(), wantT, atol=1e-11, rtol=0)
    assert torch.equal(yT, y.transpose(1, 2))
