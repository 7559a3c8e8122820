"""Port vs JAX package on the CPU: the dense local solvers (``lu``,
``chol``, ``qr``, ``inv`` and ``factorize_pinv``) and the complex plain
DIA product, real and complex.

The same batches, made from a numpy seed, go through
``hpddm_tpu.ops.local_solve`` and ``hpddm_tpu_torch.ops.local_solve``:
the solves agree to rtol 1e-10 (two LAPACK factorizations of
well-conditioned matrices, each backward stable). The JAX package's
``factorize_pinv`` takes V^T where the pseudo-inverse of a complex
Hermitian matrix needs V^H (ROADMAP queue C, C12): for real matrices the
port equals it, for complex ones it equals numpy's pinv. The complex plain
DIA product (explicit real operations, ``_complex_reference``) agrees with
the JAX package's ``spmm_dia`` (complex multiply-adds) to rtol 1e-13.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpddm_tpu.core.formats import BatchedDIA as JaxDIA
from hpddm_tpu.ops import local_solve as jax_ls
from hpddm_tpu.ops.spmv import spmm_dia as jax_spmm_dia

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.core.formats import (BatchedELL, batched_dense_from,
                                          pack_local_matrices)
from hpddm_tpu_torch.ops import local_solve as ls
from hpddm_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_reference

S, N, MU = 3, 24, 2


def _batch(rng, dtype, kind):
    """(A (S, N, N), b (S, N, MU)) in dtype: a diagonally dominant general
    matrix, Hermitian positive definite for chol, Hermitian positive
    semidefinite of rank N - 2 for pinv."""
    cplx = np.dtype(dtype).kind == "c"

    def draw(*shape):
        x = rng.normal(size=shape)
        return x + 1j * rng.normal(size=shape) if cplx else x
    M = draw(S, N, N)
    if kind == "chol":
        A = M @ np.conj(M.transpose(0, 2, 1)) + N * np.eye(N)
    elif kind == "pinv":
        B = draw(S, N, N - 2)
        A = B @ np.conj(B.transpose(0, 2, 1))
    else:
        A = M + 2 * N * np.eye(N)
    return A.astype(dtype), draw(S, N, MU).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("kind", ["inv", "lu", "chol", "qr"])
def test_local_solve_follows_jax(kind, dtype):
    A, b = _batch(np.random.default_rng(5), dtype, kind)
    want = np.asarray(jax_ls.factorize(jnp.asarray(A), kind).solve(
        jnp.asarray(b)))
    solver = ls.factorize(torch.as_tensor(A), kind)
    got = solver.solve(torch.as_tensor(b)).numpy()
    assert solver.kind == kind and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(A @ got, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_factorize_pinv(dtype):
    A, _ = _batch(np.random.default_rng(6), dtype, "pinv")
    got = ls.factorize_pinv(torch.as_tensor(A)).factor.numpy()
    np.testing.assert_allclose(got, np.linalg.pinv(A, rcond=1e-10,
                                                   hermitian=True),
                               rtol=1e-8, atol=1e-12)
    jax_pinv = np.asarray(jax_ls.factorize_pinv(jnp.asarray(A)).factor)
    if dtype == np.float64:
        np.testing.assert_allclose(got, jax_pinv, rtol=1e-10, atol=1e-12)
    else:
        # the JAX package's V^T: not a pseudo-inverse of complex A (C12)
        assert not np.allclose(A @ jax_pinv @ A, A, atol=1e-6)
        np.testing.assert_allclose(A @ got @ A, A, rtol=1e-8, atol=1e-8)


def test_mixed_dtype_factor_is_promoted():
    """An f32 factor applied to an f64 panel through inv, lu and qr is
    promoted with b, as the JAX package's products promote."""
    A, b = _batch(np.random.default_rng(7), np.float64, "lu")
    for kind in ("inv", "lu", "qr"):
        solver = ls.factorize(torch.as_tensor(A, dtype=torch.float32), kind)
        x = solver.solve(torch.as_tensor(b))
        assert x.dtype == torch.float64
        np.testing.assert_allclose(A @ x.numpy(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mu", [1, 3])
def test_complex_plain_dia_matches_jax(mu):
    """The plain complex product against the JAX package's spmm_dia, with
    the kernel wrapper taking it on CPU tensors; and against a real
    operator applied to a complex vector."""
    rng = np.random.default_rng(11 + mu)
    S_, n, offs = 3, 257, (-17, -1, 0, 1, 17)
    vals = rng.normal(size=(S_, len(offs), n)) + \
        1j * rng.normal(size=(S_, len(offs), n))
    x = rng.normal(size=(S_, n, mu)) + 1j * rng.normal(size=(S_, n, mu))
    want = np.asarray(jax_spmm_dia(
        JaxDIA(values=jnp.asarray(vals), offsets=offs, n_max=n),
        jnp.asarray(x)))
    got = dia_spmv_reference(torch.as_tensor(vals), torch.as_tensor(x), offs)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)
    if mu == 1:
        y = dia_spmv(torch.as_tensor(vals), torch.as_tensor(x[:, :, 0]),
                     offs)
        assert torch.equal(y, got[:, :, 0])
    real = dia_spmv_reference(torch.as_tensor(vals.real),
                              torch.as_tensor(x), offs)
    np.testing.assert_allclose(
        real.numpy(), np.asarray(jax_spmm_dia(JaxDIA(
            values=jnp.asarray(vals.real), offsets=offs, n_max=n),
            jnp.asarray(x))), rtol=1e-13, atol=1e-13)


def test_complex_ell_pack_keeps_the_imaginary_part():
    """An ELL pack of complex matrices is complex and equals the dense
    pack (the imaginary part is never dropped)."""
    import scipy.sparse as sp

    mats = [MatrixCSR(sp.random(40, 40, density=0.2, random_state=s,
                                dtype=np.float64)
                      + 1j * sp.random(40, 40, density=0.2,
                                       random_state=s + 9)
                      + sp.identity(40)) for s in range(2)]
    ell = pack_local_matrices(mats, n_max=44, fmt="ell", device="cpu")
    dense = pack_local_matrices(mats, n_max=44, fmt="dense", device="cpu")
    assert isinstance(ell, BatchedELL) and ell.values.is_complex()
    assert torch.equal(batched_dense_from(ell), dense.values)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
def test_dtype_helpers_follow_jax(dtype):
    """is_complex, underlying, downscaled and upscaled map each scalar type
    as the JAX package's ``hpddm_tpu/dtypes.py`` does; conj conjugates
    complex tensors only."""
    from hpddm_tpu import dtypes as jax_dt
    from hpddm_tpu_torch import dtypes as dt

    for name in ("is_complex", "underlying", "downscaled", "upscaled"):
        got, want = getattr(dt, name)(dtype), getattr(jax_dt, name)(dtype)
        if name != "is_complex":
            got, want = str(got).split(".")[-1], str(want)
        assert got == want, name
    x = torch.ones(3, dtype=dt.as_torch_dtype(dtype)) * (
        1 + 2j if np.dtype(dtype).kind == "c" else 2)
    np.testing.assert_array_equal(dt.conj(x).resolve_conj().numpy(),
                                  np.conj(x.numpy()))
