"""The CUDA DIA kernel on the card (skipped without a CUDA GPU).

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX.) The kernel sums in
the plain version's order with separately rounded products and sums, so
the two agree bitwise on the card.
"""

import numpy as np
import pytest
import torch

from hpddm_tpu_torch.core.formats import BatchedDIA
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.ops import dia_spmv as kmod
from hpddm_tpu_torch.parallel.ops import scaled_exchange
from hpddm_tpu_torch.precond.schwarz import Schwarz, gmv
from hpddm_tpu_torch.ops.spmv import spmm, spmm_dia

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
