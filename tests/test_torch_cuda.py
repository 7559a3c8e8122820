"""The CUDA kernels on the card (skipped without a CUDA GPU): DIA SpMV (B1),
DIA SpMM in both panel layouts (B2/B3), ELL SpMV (B4) and the one-pass
exchange (B5).

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX.) Each kernel sums in
its plain version's order with separately rounded products and sums, so
the two agree bitwise on the card.
"""

import dataclasses


import numpy as np
import pytest
import torch

from hpddm_tpu_torch.core.formats import BatchedDIA
from hpddm_tpu_torch.models import diffusion2d, unstructured
from hpddm_tpu_torch.ops import dia_spmv as kmod
from hpddm_tpu_torch.ops import ell_spmv as ek
from hpddm_tpu_torch.parallel import pexchange as pk
from hpddm_tpu_torch.parallel.ops import exchange, scaled_exchange
from hpddm_tpu_torch.precond.schwarz import Schwarz, gmv
from hpddm_tpu_torch.ops.spmv import spmm, spmm_dia, spmm_ell

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,n,offsets", [
    (4, 2601, (-50, -1, 0, 1, 50)), (64, 4356, (-64, -1, 0, 1, 64)),
    (3, 1000, (-3, 0, 7)), (2, 300, (-400, -1, 0, 350)), (5, 777, (0,))])
def test_kernel_matches_plain_bitwise(cuda, S, n, offsets, dtype):
    rng = np.random.default_rng(S + n)
    vals = torch.as_tensor(rng.normal(size=(S, len(offsets), n)),
                           device=cuda).to(dtype)
    x = torch.as_tensor(rng.normal(size=(S, n)), device=cuda).to(dtype)
    before = kmod.launches
    y = kmod.dia_spmv(vals, x, offsets)
    torch.cuda.synchronize()
    assert kmod.launches == before + 1
    assert torch.equal(y, kmod.dia_spmv_reference(vals, x, offsets))


def test_kernel_rejects_what_it_does_not_take(cuda):
    vals = torch.zeros((2, 3, 64), device=cuda)
    x = torch.zeros((2, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kmod.dia_spmv(vals, x.T.contiguous().T, (0, 1, 2))
    with pytest.raises(TypeError):
        kmod.dia_spmv(vals, x.double(), (0, 1, 2))
    with pytest.raises(ValueError):
        kmod.dia_spmv(vals, x, (0, 1))
    with pytest.raises(ValueError, match="same CUDA device"):
        kmod.dia_spmv(vals, x.cpu(), (0, 1, 2))


def test_spmm_single_rhs_never_runs_plain_on_cuda(cuda):
    """spmm sends every single-RHS DIA product on the card to the kernel:
    a dtype the kernel does not take raises instead of running the plain
    version."""
    A = BatchedDIA(values=torch.ones((2, 3, 64), device=cuda,
                                     dtype=torch.float64),
                   offsets=(-1, 0, 1), n_max=64)
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(TypeError, match="dtypes"):
            spmm(A, torch.ones((2, 64, 1), device=cuda, dtype=dtype))
    before = kmod.launches
    spmm(A, torch.ones((2, 64, 1), device=cuda, dtype=torch.float64))
    assert kmod.launches == before + 1


SPMM_CASES = [(4, 2601, (-50, -1, 0, 1, 50)), (64, 4356, (-64, -1, 0, 1, 64)),
              (3, 1000, (-3, 0, 7)), (2, 300, (-400, -1, 0, 350)),
              (5, 777, (0,)), (2, 513, (9,))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [2, 3, 8, 9])
@pytest.mark.parametrize("S,n,offsets", SPMM_CASES)
def test_spmm_kernel_matches_plain_bitwise(cuda, S, n, offsets, mu, dtype):
    """B2 (x of shape (S, n, mu)) and B3 (xT of shape (S, mu, n)): one
    kernel, the same sums as the plain version; mu=9 leaves a partial tile
    of right-hand sides."""
    rng = np.random.default_rng(S + n + mu)
    vals = torch.as_tensor(rng.normal(size=(S, len(offsets), n)),
                           device=cuda).to(dtype)
    x = torch.as_tensor(rng.normal(size=(S, n, mu)), device=cuda).to(dtype)
    xT = x.transpose(1, 2).contiguous()
    before = kmod.spmm_launches
    y = kmod.dia_spmm(vals, x, offsets)
    yT = kmod.dia_spmm_muT(vals, xT, offsets)
    torch.cuda.synchronize()
    assert kmod.spmm_launches == before + 2
    ref = kmod.dia_spmv_reference(vals, x, offsets)
    assert torch.equal(y, ref)
    assert torch.equal(yT, kmod.dia_spmm_muT_reference(vals, xT, offsets))
    assert torch.equal(yT, ref.transpose(1, 2))


def test_spmm_kernel_rejects_what_it_does_not_take(cuda):
    vals = torch.zeros((2, 3, 64), device=cuda)
    x = torch.zeros((2, 64, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kmod.dia_spmm(vals, x.transpose(0, 1).contiguous().transpose(0, 1),
                      (0, 1, 2))
    with pytest.raises(TypeError, match="dtypes"):
        kmod.dia_spmm(vals, x.double(), (0, 1, 2))
    with pytest.raises(ValueError, match="disagree"):
        kmod.dia_spmm_muT(vals, x, (0, 1, 2))
    with pytest.raises(ValueError, match="limits"):
        kmod.dia_spmm(torch.zeros((2, 33, 64), device=cuda), x,
                      tuple(range(33)))
    with pytest.raises(ValueError, match="same CUDA device"):
        kmod.dia_spmm(vals, x.cpu(), (0, 1, 2))


def test_spmm_multi_rhs_never_runs_plain_on_cuda(cuda):
    """spmm sends every DIA product with mu > 1 on the card to the SpMM
    kernel: a dtype it does not take raises instead of running the plain
    version."""
    A = BatchedDIA(values=torch.ones((2, 3, 64), device=cuda,
                                     dtype=torch.float64),
                   offsets=(-1, 0, 1), n_max=64)
    with pytest.raises(TypeError, match="dtypes"):
        spmm(A, torch.ones((2, 64, 3), device=cuda, dtype=torch.float32))
    before = (kmod.launches, kmod.spmm_launches)
    x = torch.ones((2, 64, 3), device=cuda, dtype=torch.float64)
    y = spmm(A, x)
    assert (kmod.launches, kmod.spmm_launches) == (before[0], before[1] + 1)
    assert torch.equal(y, spmm_dia(A, x))


def test_gmv_through_kernel_matches_plain(cuda):
    gen = diffusion2d.generate(4, 40, 40, overlap=1)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  device=cuda)
    state = sch.build()
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(4, sch.n_max, 1)), device=cuda)
    before = kmod.launches
    y = gmv(state, x)
    assert kmod.launches == before + 1
    assert torch.equal(y, scaled_exchange(sch.dec, spmm_dia(sch.A, x)))
    x4 = torch.as_tensor(np.random.default_rng(1).normal(
        size=(4, sch.n_max, 4)), device=cuda)
    before = kmod.spmm_launches
    y4 = gmv(state, x4)
    assert kmod.spmm_launches == before + 1
    assert torch.equal(y4, scaled_exchange(sch.dec, spmm_dia(sch.A, x4)))


@pytest.fixture(scope="module")
def unstr():
    """The Schwarz setup of a small unstructured problem on the card (ELL
    operator, exchange plan attached)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    gen = unstructured.generate(4, 30, 30, overlap=2, with_neumann=False)
    return Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                   device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,w,n,mu", [(8, 11, 680, 1), (8, 11, 680, 3),
                                      (64, 11, 4640, 1), (3, 7, 1000, 2),
                                      (2, 5, 300, 9)])
def test_ell_kernel_matches_plain_bitwise(cuda, S, w, n, mu, dtype):
    rng = np.random.default_rng(S + n + mu)
    rows = np.arange(n)[None, None, :]
    cols = np.clip(rows + rng.integers(-40, 41, size=(S, w, n)), 0, n - 1)
    vals = rng.normal(size=(S, w, n))
    vals[0, :, 0] = 0.0                       # an all-padding row
    cols[0, :, 0] = 0
    vals = torch.as_tensor(vals, device=cuda).to(dtype)
    cols = torch.as_tensor(cols, device=cuda, dtype=torch.int32)
    x = torch.as_tensor(rng.normal(size=(S, n, mu)), device=cuda).to(dtype)
    before = ek.launches
    y = ek.ell_spmv(vals, cols, x)
    torch.cuda.synchronize()
    assert ek.launches == before + 1
    assert torch.equal(y, ek.ell_spmv_reference(vals, cols, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [1, 3])
def test_pexchange_kernel_matches_plain_bitwise(unstr, mu, dtype):
    dec = unstr.dec
    x = torch.as_tensor(np.random.default_rng(mu).normal(
        size=(dec.S, dec.n_max, mu)), device="cuda").to(dtype)
    before = pk.launches
    y = pk.pexchange(dec.pexch, x)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    assert torch.equal(y, pk.pexchange_reference(dec.pexch, x))
    assert torch.equal(y, exchange(dataclasses.replace(dec, pexch=None), x))


def test_ell_spmm_and_planned_exchange_never_run_plain_on_cuda(unstr):
    """On the card every ELL product goes to the ELL kernel and every
    exchange with a plan to the exchange kernel: the launch counts grow,
    and a dtype the kernels do not take raises instead of running the
    plain version."""
    A, dec = unstr.A, unstr.dec
    x = torch.ones((dec.S, dec.n_max, 2), device="cuda", dtype=torch.float64)
    before = (ek.launches, pk.launches)
    y = spmm(A, x)
    z = exchange(dec, y)
    assert (ek.launches, pk.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, spmm_ell(A, x))
    assert torch.equal(z, exchange(dataclasses.replace(dec, pexch=None), y))
    with pytest.raises(TypeError, match="dtypes"):
        spmm(A, x.float())
    with pytest.raises(TypeError, match="dtype"):
        exchange(dec, x.half())


def test_unstructured_gmv_through_kernels_matches_plain(unstr):
    state = unstr.build()
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(state.dec.S, unstr.n_max, 1)), device="cuda")
    before = (ek.launches, pk.launches)
    y = gmv(state, x)
    assert (ek.launches, pk.launches) == (before[0] + 1, before[1] + 1)
    plain = scaled_exchange(dataclasses.replace(state.dec, pexch=None),
                            spmm_ell(state.A, x))
    assert torch.equal(y, plain)
