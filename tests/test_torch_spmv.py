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
from test_torch_gmres import root_chip_smoke

chip_smoke = root_chip_smoke()


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


def _numpy_dia(vals, x, offsets):
    """y = sum_k vals[:, k] * shift(x, offsets[k]) in numpy, summed in the
    diagonal order from zero, one rounded product and one rounded sum per
    term: the arithmetic of the plain version and of the kernels."""
    S, nd, n = vals.shape
    out = np.zeros_like(x)
    for k, off in enumerate(offsets):
        shifted = np.zeros_like(x)
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            shifted[:, lo:hi] = x[:, lo + off:hi + off]
        out = out + vals[:, k].reshape((S, n) + (1,) * (x.ndim - 2)) * shifted
    return out


@pytest.mark.parametrize("name,S,n,offsets", chip_smoke.DIA_CASES,
                         ids=[c[0] for c in chip_smoke.DIA_CASES])
def test_plain_versions_at_the_smoke_shapes(name, S, n, offsets):
    """The card holds B1, B2 and B3 bitwise to the plain versions at the
    smoke's DIA_CASES (phases 3 and 9); here the plain versions are held
    bitwise to numpy at the same shapes, for one right-hand side and for
    panels in both layouts (mu=5: not a multiple of any vector width)."""
    rng = np.random.default_rng(n)
    vals = rng.normal(size=(S, len(offsets), n))
    x = rng.normal(size=(S, n, 5))
    tv = torch.as_tensor(vals)
    y1 = kmod.dia_spmv(tv, torch.as_tensor(x[:, :, 0].copy()), offsets)
    assert np.array_equal(y1.numpy(), _numpy_dia(vals, x[:, :, 0], offsets))
    want = _numpy_dia(vals, x, offsets)
    assert np.array_equal(kmod.dia_spmm(tv, torch.as_tensor(x), offsets)
                          .numpy(), want)
    xT = torch.as_tensor(np.ascontiguousarray(x.transpose(0, 2, 1)))
    assert np.array_equal(kmod.dia_spmm_muT(tv, xT, offsets).numpy(),
                          want.transpose(0, 2, 1))
    assert kmod.launches == 0 and kmod.spmm_launches == 0


@pytest.mark.parametrize("S,nd,n,mu", [
    (64, 5, 4356, 640),                  # the grid card cell's coarse panel
    (768, 5, 420, 10),                   # S * n * mu = 3.2e6
    (2049, 5, 1024, 1024),               # S * n * mu past 2^31: two launches
    (1, 32, 2 ** 31 - 1, 1),             # B1, the largest subdomain
    (2 ** 31 - 1, 1, 1, 1)])
def test_kernel_limits_take_whole_subdomains(S, nd, n, mu):
    """The kernels' limits are per subdomain (n * mu < 2^31) and on nd,
    not on the whole tensor: a larger S is launched in batches."""
    kmod.check_limits("dia_spmm", S, nd, n, mu)


@pytest.mark.parametrize("S,nd,n,mu", [
    (4, 33, 100, 1), (1, 5, 2 ** 31, 1), (2, 5, 2 ** 16, 2 ** 15),
    (2 ** 31, 5, 10, 1)])
def test_kernel_limits_reject_what_the_launch_cannot_index(S, nd, n, mu):
    with pytest.raises(ValueError, match="limits"):
        kmod.check_limits("dia_spmm", S, nd, n, mu)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15dia_rows_kernelIdLi5ELi2ELi1EEvPKT_S2_PS0_iij7FastDivS4_10DiaOffsets' for 'sm_90a'
ptxas info    : Function properties for _Z15dia_rows_kernelIdLi5ELi2ELi1EEvPKT_S2_PS0_iij7FastDivS4_10DiaOffsets
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 544 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelPd' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPd
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 2048 bytes smem, 360 bytes cmem[0]
"""


def test_ptxas_resources_are_read_from_the_build_log():
    """Phase 2 of the smoke prints each kernel's registers, shared memory
    and spills from the ``ptxas -v`` log of the build."""
    from hpddm_tpu_torch import _build

    recs = _build.resources(PTXAS_LOG)
    assert [(r["registers"], r["smem"], r["spill_stores"], r["spill_loads"])
            for r in recs] == [(30, 0, 0, 0), (255, 2048, 4, 12)]
    assert recs[0]["kernel"] in (
        "dia_rows_kernel<double, 5, 2, 1>",
        "_Z15dia_rows_kernelIdLi5ELi2ELi1EEvPKT_S2_PS0_iij7FastDivS4_10Dia"
        "Offsets")                       # as given where c++filt is missing
    assert _build.resources("") == []
    assert "-v" in _build.NVCC_FLAGS

