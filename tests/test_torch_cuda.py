"""The CUDA kernels on the card (skipped without a CUDA GPU): DIA SpMV (B1),
DIA SpMM in both panel layouts (B2/B3), ELL SpMM (B4, with its payload;
also with a non-finite x[s, 0]) and the one-pass exchange (B5), at mu 1,
3, 4, 33 and 640; and the banded local solve and Lanczos GenEO on the card
(against the CPU, and with no plain-version call). The slice-5b shapes: B1
at the 21 diagonals of 2D elasticity and the 7 of 3D diffusion, B4 at the
H8 operator's rows of up to 80 slots, and the dense-coupling banded solve
of 2D elasticity node slabs against the CPU. Slice 5c: B1 and B2 in
complex128 (against the plain version's explicit real operations, with
non-finite imaginary parts and offset tensors), the Helmholtz gmv, ORAS
apply and solve on the card against the CPU port with no plain-version
call, and B3, B4 and B5 raising on complex. Slices 5d + 5e(ii): the DST
(both modes) and Chebyshev (DST and Jacobi inner) local solves and their
solves, the dense Schwarz variant and the Stokes saddle-point solver on
the card against the CPU port.

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

from hpddm_tpu_torch.core.formats import (BatchedDIA, BatchedELL,
                                          pack_local_matrices)
from hpddm_tpu_torch.models import diffusion2d, unstructured
from hpddm_tpu_torch.ops import banded_solve as bs
from hpddm_tpu_torch.ops import dia_spmv as kmod
from hpddm_tpu_torch.ops import ell_spmv as ek
from hpddm_tpu_torch.parallel import pexchange as pk
from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.parallel.ops import exchange, scaled_exchange
from hpddm_tpu_torch.precond.schwarz import Schwarz, gmv
from hpddm_tpu_torch.ops.spmv import spmm, spmm_dia, spmm_ell

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


# the edges of the kernels' fast paths: n below one block's rows (even and
# odd), an odd n with the unrolled diagonal count (unaligned value planes),
# one subdomain, and an offset span wider than most of the rows
EDGE_CASES = [(3, 40, (-2, 0, 1)), (2, 37, (-3, 0, 2)),
              (4, 1001, (-33, -1, 0, 1, 33)), (1, 4356, (-64, -1, 0, 1, 64)),
              (2, 20000, (-9000, -1, 0, 1, 9000))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,n,offsets", [
    (4, 2601, (-50, -1, 0, 1, 50)), (64, 4356, (-64, -1, 0, 1, 64)),
    (3, 1000, (-3, 0, 7)), (2, 300, (-400, -1, 0, 350)), (5, 777, (0,)),
    (2, 513, (9,))] + EDGE_CASES)
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
              (5, 777, (0,)), (2, 513, (9,))] + EDGE_CASES


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [2, 3, 8, 9, 4, 5, 31, 33, 65])
@pytest.mark.parametrize("S,n,offsets", SPMM_CASES)
def test_spmm_kernel_matches_plain_bitwise(cuda, S, n, offsets, mu, dtype):
    """B2 (x of shape (S, n, mu)) and B3 (xT of shape (S, mu, n)): the same
    sums as the plain version; an odd mu, or one that is not a multiple of
    the 16-byte vector, takes the kernels' scalar paths, and a mu that is
    not a multiple of B3's chunk of right-hand sides a partial chunk."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmm_kernel_coarse_panel_bitwise(cuda, dtype):
    """B2 and B3 at the grid card cell's coarse panel (mu=640)."""
    S, n, offsets = 64, 4356, (-64, -1, 0, 1, 64)
    gen = torch.Generator(device=cuda).manual_seed(640)
    vals = torch.randn((S, len(offsets), n), generator=gen, device=cuda,
                       dtype=dtype)
    x = torch.randn((S, n, 640), generator=gen, device=cuda, dtype=dtype)
    ref = kmod.dia_spmv_reference(vals, x, offsets)
    assert torch.equal(kmod.dia_spmm(vals, x, offsets), ref)
    xT = x.transpose(1, 2).contiguous()
    assert torch.equal(kmod.dia_spmm_muT(vals, xT, offsets),
                       ref.transpose(1, 2))


def _misaligned(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary, so the kernels cannot use 16-byte vectors on it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_on_misaligned_tensors_bitwise(cuda, dtype):
    """Shapes that take the 16-byte vector paths, given tensors that do not
    start on a 16-byte boundary: the kernels take the scalar paths."""
    S, n, offsets = 3, 4356, (-64, -1, 0, 1, 64)
    rng = np.random.default_rng(16)
    vals = torch.as_tensor(rng.normal(size=(S, len(offsets), n)),
                           device=cuda).to(dtype)
    x = torch.as_tensor(rng.normal(size=(S, n, 4)), device=cuda).to(dtype)
    ref = kmod.dia_spmv_reference(vals, x, offsets)
    mv, mx = _misaligned(vals), _misaligned(x)
    assert torch.equal(kmod.dia_spmm(vals, mx, offsets), ref)
    assert torch.equal(kmod.dia_spmm_muT(mv, _misaligned(
        x.transpose(1, 2).contiguous()), offsets), ref.transpose(1, 2))
    x1 = x[:, :, 0].contiguous()
    assert torch.equal(kmod.dia_spmv(mv, _misaligned(x1), offsets),
                       kmod.dia_spmv_reference(vals, x1, offsets))


@pytest.mark.parametrize("kernel", ["dia_spmv", "dia_spmm", "dia_spmm_muT"])
def test_kernels_past_2_31_elements_bitwise(cuda, kernel):
    """A call whose x holds more than 2^31 elements (f32, 8.6 GB) runs in
    batches of whole subdomains (2047 of 2049 in the first): the first and
    last subdomain of each batch agree bitwise with the plain version."""
    S = 2049
    if kernel == "dia_spmv":
        offsets, shape = (-1, 1), (S, 1 << 20)
    else:
        offsets, shape = (-33, -1, 0, 1, 33), (S, 1024, 1024)
    n = shape[1] if kernel != "dia_spmm_muT" else shape[2]
    gen = torch.Generator(device=cuda).manual_seed(31)
    try:
        vals = torch.randn((S, len(offsets), n), generator=gen, device=cuda)
        x = torch.randn(shape, generator=gen, device=cuda)
        assert x.numel() > 2 ** 31
        fn = getattr(kmod, kernel)
        ref = kmod.dia_spmm_muT_reference if kernel == "dia_spmm_muT" \
            else kmod.dia_spmv_reference
        y = fn(vals, x, offsets)
        for s in (0, 2046, 2047, S - 1):
            assert torch.equal(y[s:s + 1],
                               ref(vals[s:s + 1], x[s:s + 1], offsets)), s
    finally:
        vals = x = y = None
        torch.cuda.empty_cache()


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


def _ragged_ell(rng, S, w, n, band=40):
    """Slot-major values and int32 columns whose rows have random lengths
    in [1, w] (then padding: value 0, column 0); row 0 of subdomain 0 is all
    padding."""
    rows = np.arange(n)[None, None, :]
    cols = np.clip(rows + rng.integers(-band, band + 1, size=(S, w, n)), 0,
                   n - 1)
    vals = rng.normal(size=(S, w, n))
    pad = np.arange(w)[None, :, None] >= rng.integers(1, w + 1,
                                                      size=(S, 1, n))
    pad[0, :, 0] = True
    vals[pad] = 0.0
    cols[pad] = 0
    return vals, cols


ELL_MUS = [1, 3, 4, 33, 640]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", ELL_MUS)
@pytest.mark.parametrize("S,w,n", [(8, 11, 680), (3, 7, 1000), (2, 5, 301),
                                   (4, 6, 256), (1, 17, 500), (64, 11, 4640)])
def test_ell_kernel_matches_plain_bitwise(cuda, S, w, n, mu, dtype):
    """B4 on ragged random batches: at mu=1 w below (5), at (6) and above
    (7, 11) one pass of 6 loaded slots and several passes (17); an odd n
    (301); at mu > 1 the slots walked in order, with warp-per-row chunks
    where a row holds whole warps (mu=640); the card shape."""
    if S == 64 and mu not in (1, 640):
        pytest.skip("the card shape at mu=1 and 640 only")
    rng = np.random.default_rng(S + n + mu)
    vals, cols = _ragged_ell(rng, S, w, n)
    A = BatchedELL.from_slot_major(
        torch.as_tensor(vals, device=cuda),
        torch.as_tensor(cols, device=cuda, dtype=torch.int32), n) \
        .astype(dtype)
    assert A.payload.cols.dtype == torch.uint16
    x = torch.as_tensor(rng.normal(size=(S, n, mu)), device=cuda).to(dtype)
    before = (ek.launches, ek.launches_by_mu[mu])
    y = ek.ell_spmv(A.values, A.cols, x, A.payload)
    torch.cuda.synchronize()
    assert (ek.launches, ek.launches_by_mu[mu]) == (before[0] + 1,
                                                    before[1] + 1)
    assert torch.equal(y, ek.ell_spmv_payload_reference(A.values, A.payload,
                                                        x))
    assert torch.equal(y, ek.ell_spmv_reference(A.values, A.cols, x))
    no_counts = dataclasses.replace(A.payload, counts=None)
    assert torch.equal(ek.ell_spmv(A.values, A.cols, x, no_counts), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [1, 4])
def test_ell_kernel_int32_columns_bitwise(cuda, mu, dtype):
    """n_max = 65,536: the payload keeps int32 columns."""
    rng = np.random.default_rng(65536 + mu)
    vals, cols = _ragged_ell(rng, 1, 3, 65536)
    cols[0, 0, -1] = 65535
    A = BatchedELL.from_slot_major(
        torch.as_tensor(vals, device=cuda),
        torch.as_tensor(cols, device=cuda, dtype=torch.int32), 65536) \
        .astype(dtype)
    assert A.payload.cols.dtype == torch.int32
    x = torch.as_tensor(rng.normal(size=(1, 65536, mu)), device=cuda).to(dtype)
    assert torch.equal(ek.ell_spmv(A.values, A.cols, x, A.payload),
                       ek.ell_spmv_payload_reference(A.values, A.payload, x))


def test_ell_kernel_without_payload_raises(cuda):
    vals = torch.ones((2, 3, 64), device=cuda, dtype=torch.float64)
    cols = torch.zeros((2, 3, 64), device=cuda, dtype=torch.int32)
    x = torch.ones((2, 64, 1), device=cuda, dtype=torch.float64)
    before = ek.launches
    with pytest.raises(ValueError, match="payload"):
        ek.ell_spmv(vals, cols, x)
    with pytest.raises(ValueError, match="payload"):
        spmm(BatchedELL(values=vals, cols=cols, n_max=64), x)
    assert ek.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", ELL_MUS)
def test_ell_kernel_on_the_parity_operator_bitwise(cuda, mu, dtype):
    gen = unstructured.generate(8, 60, 60, overlap=2, with_neumann=False)
    A = pack_local_matrices(gen.mats, device=cuda).astype(dtype)
    x = torch.as_tensor(np.random.default_rng(mu).normal(
        size=(8, A.n_max, mu)), device=cuda).to(dtype)
    assert torch.equal(spmm(A, x), ek.ell_spmv_payload_reference(
        A.values, A.payload, x))


def _isolated():
    """Three subdomains, the last with no interface slot."""
    idx = np.arange(4, 9)
    return Decomposition.from_subdomains([[1], [0], []],
                                         [[idx], [idx - 4], []], [12, 10, 7],
                                         device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", ELL_MUS)
@pytest.mark.parametrize("which", ["unstructured", "isolated"])
def test_pexchange_kernel_matches_plain_bitwise(unstr, which, mu, dtype):
    dec = unstr.dec if which == "unstructured" else _isolated()
    plan = dec.pexch if dec.pexch is not None else pk.build_plan(dec)
    x = torch.as_tensor(np.random.default_rng(mu).normal(
        size=(dec.S, dec.n_max, mu)), device="cuda").to(dtype)
    x[:, ::7] = -0.0
    before = (pk.launches, pk.launches_by_mu[mu])
    y = pk.pexchange(plan, x)
    torch.cuda.synchronize()
    assert (pk.launches, pk.launches_by_mu[mu]) == (before[0] + 1,
                                                    before[1] + 1)
    assert torch.equal(y, pk.pexchange_reference(plan, x))
    plain = exchange(dataclasses.replace(dec, pexch=None), x)
    assert y.cpu().numpy().tobytes() == plain.cpu().numpy().tobytes()


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [1, 3, 4, 32, 33, 640])
@pytest.mark.parametrize("value", [np.inf, np.nan], ids=["inf", "nan"])
def test_ell_kernel_non_finite_x0(cuda, value, mu, dtype):
    """A row with trailing padding adds 0 * x[s, 0]: with a non-finite
    x[s, 0] the kernel has NaN where its plain version has it (and the full
    slot sum), and the same bits everywhere else; at mu=1 after the passes,
    at mu = 3, 4, 33 through the first padding slot, at mu = 32 and 640
    through the flags of the subdomains (one subdomain left finite)."""
    rng = np.random.default_rng(7 + mu)
    vals, cols = _ragged_ell(rng, 3, 7, 1000)
    A = BatchedELL.from_slot_major(
        torch.as_tensor(vals, device=cuda),
        torch.as_tensor(cols, device=cuda, dtype=torch.int32), 1000) \
        .astype(dtype)
    x = torch.as_tensor(rng.normal(size=(3, 1000, mu)), device=cuda).to(dtype)
    x[:2, 0] = value
    y = ek.ell_spmv(A.values, A.cols, x, A.payload)
    ref = ek.ell_spmv_payload_reference(A.values, A.payload, x)
    nan = torch.isnan(ref)
    assert nan.any() and torch.equal(torch.isnan(y), nan)
    assert torch.equal(torch.isnan(ek.ell_spmv_reference(A.values, A.cols,
                                                         x)), nan)
    assert torch.equal(y[~nan], ref[~nan])


def _banded_grid(device):
    gen = diffusion2d.generate_uniform(4, 48, 48, overlap=2,
                                       with_neumann=True)
    return gen, bs.build_banded_solver(gen.mats, gen.boxes, max(gen.n_loc),
                                       dtype=torch.float64, device=device)


@pytest.mark.parametrize("mu", [1, 4])
def test_banded_solve_on_card_matches_cpu(cuda, mu):
    """The sweeps on the card (cuBLAS batched products) against the same
    solve on the CPU, f64."""
    gen, card = _banded_grid(cuda)
    _, cpu = _banded_grid("cpu")
    assert torch.equal(card.Dinv.cpu(), cpu.Dinv)        # host factors
    b = np.random.default_rng(mu).normal(size=(4, max(gen.n_loc), mu))
    x = card.solve(torch.as_tensor(b, device=cuda)).cpu().numpy()
    want = cpu.solve(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def _count_plain_on_cuda(monkeypatch):
    """Count calls of the kernels' plain versions on CUDA tensors."""
    from hpddm_tpu_torch.ops import spmv

    calls = [0]

    def counted(plain):
        def call(*args):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                calls[0] += 1
            return plain(*args)
        return call
    for mods, name in (((kmod, spmv), "dia_spmv_reference"),
                       ((ek, spmv), "ell_spmv_reference"),
                       ((ek,), "ell_spmv_payload_reference"),
                       ((pk,), "pexchange_reference")):
        wrapped = counted(getattr(mods[0], name))
        for mod in mods:
            monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("model", ["grid", "unstructured"])
def test_banded_lanczos_path_never_runs_plain(cuda, monkeypatch, model):
    """Banded local solves and Lanczos GenEO on the card: the grid path on
    its boxes (B1), the unstructured one through RCM (B4, B5); no plain
    version runs, and the solve converges."""
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.krylov import solve

    calls = _count_plain_on_cuda(monkeypatch)
    if model == "grid":
        gen = diffusion2d.generate_uniform(4, 48, 48, overlap=1,
                                           with_neumann=True)
    else:
        gen = unstructured.generate(4, 30, 30, overlap=2, with_neumann=True)
    opt = Options(local_solver="banded", schwarz_coarse_correction="deflated",
                  geneo_nu=6, tol=1e-8)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt, device=cuda)
    if model == "grid":
        sch.set_grid_geometry(gen.boxes, 48, 48)
    before = (kmod.launches, ek.launches, pk.launches)
    sch.solve_gevp(gen.neumann)
    state = sch.build()
    assert isinstance(state.solver, bs.BandedSolver)
    assert (sch.rcm_bandwidths is None) == (model == "grid")
    f = np.zeros((4, sch.n_max, 1))
    for s in range(4):
        f[s, : gen.n_loc[s]] = gen.f[s]
    res = solve(state, torch.as_tensor(f, device=cuda), opt=opt)
    assert bool(res.converged.all())
    after = (kmod.launches, ek.launches, pk.launches)
    grew = [a > b for a, b in zip(after, before)]
    assert grew == ([True, False, False] if model == "grid"
                    else [False, True, True])
    assert calls[0] == 0


@pytest.fixture(scope="module")
def grid_ops():
    """(CUDA operator state, CPU operator state) of generate_uniform(9, 24,
    24, overlap=2) with set_grid_geometry: the slab plan and the canvas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    gen = diffusion2d.generate_uniform(9, 24, 24, overlap=2)
    out = []
    for device in ("cuda", "cpu"):
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      device=device)
        sch.set_grid_geometry(gen.boxes, 24, 24)
        out.append(sch.operator_state())
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [1, 2, 3, 8])
def test_canvas_operator_kernels_match_plain_canvas_bitwise(grid_ops, mu,
                                                            dtype):
    """B1 (mu=1) and B2 (mu>1, 8 = the flagship's coarse panel) on a
    seam-checked canvas operator compute the plain canvas form's sums: the
    flat kernels read a stored zero where the canvas form reads its halo."""
    from hpddm_tpu_torch.ops.spmv import spmm_dia_canvas

    state = grid_ops[0]
    A = dataclasses.replace(state.A, values=state.A.values.to(dtype))
    assert A.canvas_hw is not None
    x = torch.as_tensor(np.random.default_rng(mu).normal(
        size=(state.dec.S, A.n_max, mu)), device="cuda").to(dtype)
    n1, n2 = kmod.launches, kmod.spmm_launches
    y = spmm(A, x)
    assert (kmod.launches - n1, kmod.spmm_launches - n2) == \
        ((1, 0) if mu == 1 else (0, 1))
    assert torch.equal(y, spmm_dia_canvas(A, x))


@pytest.mark.parametrize("mu", [1, 3])
def test_grid_exchange_and_gmv_on_card_match_cpu(grid_ops, mu):
    """The slab exchange on the card equals its CPU result bitwise (the
    same elementwise adds), and the gmv through B1/B2 equals the CPU's
    canvas form."""
    cu, cpu = grid_ops
    assert cu.dec.grid is not None
    x = np.random.default_rng(7).normal(size=(cu.dec.S, cu.dec.n_max, mu))
    xc, xh = torch.as_tensor(x, device="cuda"), torch.as_tensor(x)
    assert torch.equal(exchange(cu.dec, xc).cpu(), exchange(cpu.dec, xh))
    assert torch.equal(gmv(cu, xc).cpu(), gmv(cpu, xh))


@pytest.mark.parametrize("mu", [2, 3, 4])
def test_muT_gmv_launches_B3_and_matches_plain(grid_ops, mu):
    """gmv of a panel on the canvas grid state takes its RHS-leading
    branch: one B3 launch (no B2), B3 equal to its plain version and to the
    plain canvas form, and the gmv equal to the trailing-mu path's and to
    the CPU's."""
    from hpddm_tpu_torch.ops.spmv import spmm_dia_canvas_muT, spmm_muT

    cu, cpu = grid_ops
    x = np.random.default_rng(20 + mu).normal(size=(cu.dec.S, cu.dec.n_max,
                                                    mu))
    xc = torch.as_tensor(x, device="cuda")
    n2, n3 = kmod.spmm_launches, kmod.muT_launches
    y = gmv(cu, xc)
    assert (kmod.spmm_launches - n2, kmod.muT_launches - n3) == (1, 1)
    assert torch.equal(y, scaled_exchange(cu.dec, spmm(cu.A, xc)))
    assert torch.equal(y.cpu(), gmv(cpu, torch.as_tensor(x)))
    xT = xc.transpose(1, 2).contiguous()
    yT = spmm_muT(cu.A, xT)
    assert torch.equal(yT, kmod.dia_spmm_muT_reference(cu.A.values, xT,
                                                       cu.A.offsets))
    assert torch.equal(yT, spmm_dia_canvas_muT(cu.A, xT))


def test_nested_bsr_apply_on_card_matches_cpu(cuda):
    """A nested block-sparse coarse state (level-2 CG, direct level 3) on
    the card: the apply equals the CPU's to 1e-12 in f64."""
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.schwarz import apply

    gen = diffusion2d.generate_uniform(16, 64, 64, overlap=1,
                                       with_neumann=True)
    x = np.random.default_rng(9).normal(size=(16, 18 * 18, 2))
    out = []
    for device in ("cuda", "cpu"):
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=Options(schwarz_coarse_correction="deflated",
                                      geneo_nu=4, coarse_assembly="bsr",
                                      level_2_krylov_method="cg",
                                      level_2_tol=1e-6), device=device)
        sch.set_grid_geometry(gen.boxes, 64, 64)
        if device == "cuda":
            sch.solve_gevp(gen.neumann)
            vecs = sch._deflation_vectors
        else:
            sch.set_vectors(vecs)
        state = sch.build()
        assert state.coarse.mode == "bsr" and state.coarse.lvl3 == "direct"
        out.append(apply(state, torch.as_tensor(x, device=device)).cpu())
    torch.testing.assert_close(out[0], out[1], rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def model_ops():
    """The slice-5b operators on the card: 2D elasticity (DIA, 21
    diagonals), 3D diffusion (DIA, 7) and 3D elasticity (ELL, rows of up
    to 81 slots)."""
    from hpddm_tpu_torch.models import diffusion3d, elasticity2d, elasticity3d

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    e2, _, _ = elasticity2d.generate(4, 24, 24, overlap=2)
    d3 = diffusion3d.generate_uniform(8, 16, 16, 16, overlap=1)
    e3, _, _ = elasticity3d.generate(4, 8, 8, 8, overlap=2)
    return {name: pack_local_matrices(g.mats, device="cuda")
            for name, g in (("elasticity2d", e2), ("diffusion3d", d3),
                            ("elasticity3d", e3))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,nd", [("elasticity2d", 21),
                                     ("diffusion3d", 7)])
def test_dia_kernel_on_model_operators_bitwise(model_ops, name, nd, dtype):
    """B1 at the 21 diagonals of the Q1 elasticity operator and the 7 of
    the 3D stencil, against its plain version."""
    A = model_ops[name]
    assert isinstance(A, BatchedDIA) and len(A.offsets) == nd
    vals = A.values.to(dtype).contiguous()
    x = torch.as_tensor(np.random.default_rng(nd).normal(
        size=(A.values.shape[0], A.n_max)), device="cuda").to(dtype)
    before = kmod.launches
    y = kmod.dia_spmv(vals, x, A.offsets)
    torch.cuda.synchronize()
    assert kmod.launches == before + 1
    assert torch.equal(y, kmod.dia_spmv_reference(vals, x, A.offsets))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [1, 4, 10])
def test_ell_kernel_on_elasticity3d_bitwise(model_ops, mu, dtype):
    """B4 at the H8 operator's payload (rows of up to 81 slots) against
    its plain versions."""
    A = model_ops["elasticity3d"].astype(dtype)
    assert isinstance(A, BatchedELL) and 75 <= A.values.shape[1] <= 81
    x = torch.as_tensor(np.random.default_rng(mu).normal(
        size=(A.values.shape[0], A.n_max, mu)), device="cuda").to(dtype)
    before = ek.launches
    y = ek.ell_spmv(A.values, A.cols, x, A.payload)
    torch.cuda.synchronize()
    assert ek.launches == before + 1
    assert torch.equal(y, ek.ell_spmv_payload_reference(A.values, A.payload,
                                                        x))
    assert torch.equal(y, ek.ell_spmv_reference(A.values, A.cols, x))


@pytest.mark.parametrize("mu", [1, 2])
def test_dense_coupling_banded_solve_on_card_matches_cpu(cuda, mu):
    """The banded solve with dense coupling (2D elasticity on node slabs)
    on the card against the same solve on the CPU, f64."""
    from hpddm_tpu_torch.examples.bench_elasticity import banded_shapes
    from hpddm_tpu_torch.models import elasticity2d

    S, Nx = 4, 24
    gen, _, _ = elasticity2d.generate(
        S, Nx, Nx, contrast=1e2, overlap=1,
        owner_fn=lambda ix, iy: min(ix * S // Nx, S - 1))
    boxes = [(0, c, 0, r) for (r, c) in banded_shapes(gen, Nx)]
    n_max = max(gen.n_loc)
    card, cpu = (bs.build_banded_solver(gen.mats, boxes, n_max,
                                        dtype=torch.float64, device=d)
                 for d in (cuda, "cpu"))
    assert card.cl.dim() == 4 and torch.equal(card.Dinv.cpu(), cpu.Dinv)
    b = np.random.default_rng(mu).normal(size=(S, n_max, mu))
    x = card.solve(torch.as_tensor(b, device=cuda)).cpu().numpy()
    want = cpu.solve(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


# slice 5c: complex128 B1 and B2, the Helmholtz path on the card

def _complex(rng, shape, cuda):
    return torch.complex(*(torch.as_tensor(rng.normal(size=shape),
                                           device=cuda) for _ in range(2)))


def _same_bits(y, ref):
    """NaN at the same real and imaginary parts, the same bits elsewhere."""
    yr, rr = torch.view_as_real(y), torch.view_as_real(ref)
    nan = torch.isnan(rr)
    return torch.equal(torch.isnan(yr), nan) and torch.equal(yr[~nan],
                                                            rr[~nan])


@pytest.mark.parametrize("mu", [1, 3, 5, 33])
@pytest.mark.parametrize("S,n,offsets", [
    (4, 2601, (-50, -1, 0, 1, 50)), (64, 4356, (-64, -1, 0, 1, 64)),
    (3, 1000, (-3, 0, 7)), (2, 300, (-400, -1, 0, 350))] + EDGE_CASES)
def test_complex_kernels_match_plain_bitwise(cuda, S, n, offsets, mu):
    """c128 B1 (mu = 1) and B2 against the plain version's explicit real
    operations, bitwise; then with a NaN and an inf in the imaginary parts
    of two entries of x."""
    rng = np.random.default_rng(n + mu)
    vals = _complex(rng, (S, len(offsets), n), cuda)
    x = _complex(rng, (S, n) if mu == 1 else (S, n, mu), cuda)
    fn = kmod.dia_spmv if mu == 1 else kmod.dia_spmm
    before = (kmod.launches, kmod.spmm_launches)
    y = fn(vals, x, offsets)
    assert (kmod.launches, kmod.spmm_launches) == (
        before[0] + (mu == 1), before[1] + (mu > 1))
    assert torch.equal(y, kmod.dia_spmv_reference(vals, x, offsets))
    x[0, n // 2] = complex(0.5, float("nan"))
    x[-1, n - 1] = complex(-1.5, float("inf"))
    assert _same_bits(fn(vals, x, offsets),
                      kmod.dia_spmv_reference(vals, x, offsets))


def test_complex_kernels_on_offset_and_misaligned_tensors(cuda):
    """c128 tensors that start one element (16 bytes) into their buffer
    take the kernels bitwise; one that starts 8 bytes off a 16-byte
    boundary raises (a complex128 entry is one 16-byte load)."""
    S, n, offsets = 3, 1001, (-33, -1, 0, 1, 33)
    rng = np.random.default_rng(8)
    vals = _complex(rng, (S, len(offsets), n), cuda)
    x = _complex(rng, (S, n, 3), cuda)

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    ov = offset(vals)
    assert torch.equal(kmod.dia_spmm(ov, offset(x), offsets),
                       kmod.dia_spmv_reference(vals, x, offsets))
    x1 = x[:, :, 0].contiguous()
    assert torch.equal(kmod.dia_spmv(ov, offset(x1), offsets),
                       kmod.dia_spmv_reference(vals, x1, offsets))
    raw = torch.empty(2 * x1.numel() + 2, dtype=torch.float64, device=cuda)
    bad = torch.empty(0, dtype=torch.complex128, device=cuda).set_(
        raw.untyped_storage()[8:], 0, tuple(x1.shape))
    assert bad.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte"):
        kmod.dia_spmv(vals, bad, offsets)


def test_b3_b4_b5_raise_on_complex(cuda, unstr):
    """The kernels that the Helmholtz path does not reach keep raising on
    complex, naming their ROADMAP item; complex64 names C11."""
    vals = torch.zeros((2, 3, 64), dtype=torch.complex128, device=cuda)
    with pytest.raises(TypeError, match="B3c"):
        kmod.dia_spmm_muT(vals, torch.zeros((2, 4, 64), dtype=vals.dtype,
                                            device=cuda), (-1, 0, 1))
    with pytest.raises(TypeError, match="C11"):
        kmod.dia_spmv(vals.to(torch.complex64),
                      torch.zeros((2, 64), dtype=torch.complex64,
                                  device=cuda), (-1, 0, 1))
    A = unstr.A
    x = torch.zeros((unstr.dec.S, unstr.n_max, 1), dtype=torch.complex128,
                    device=cuda)
    with pytest.raises(TypeError, match="B4c"):
        ek.ell_spmv(A.values.to(x.dtype), A.cols, x, A.payload)
    with pytest.raises(TypeError, match="B5c"):
        pk.pexchange(unstr.dec.pexch, x)


@pytest.fixture(scope="module")
def helm_ops():
    """(CUDA state, CPU state, x) of helmholtz.generate(4, 24, 24, k=4,
    eps=0.3), ORAS on the optimized matrices, c128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from hpddm_tpu_torch.models import helmholtz
    from hpddm_tpu_torch.options import Options

    gen = helmholtz.generate(4, 24, 24, k=4.0, eps=0.3)
    out = []
    for device in ("cuda", "cpu"):
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=Options(schwarz_method="oras"),
                      optimized_mats=gen.oras_mats, device=device)
        out.append(sch.build())
    rng = np.random.default_rng(24)
    x = rng.normal(size=(4, out[1].dec.n_max, 2)) + \
        1j * rng.normal(size=(4, out[1].dec.n_max, 2))
    return out[0], out[1], torch.as_tensor(x)


@pytest.mark.parametrize("mu", [1, 2])
def test_helmholtz_gmv_and_oras_apply_on_card_match_cpu(helm_ops, mu,
                                                        monkeypatch):
    """The complex gmv (B1 at mu = 1, B2 at mu = 2) and one ORAS apply on
    the card against the CPU port, with no plain version on the card."""
    from hpddm_tpu_torch.precond.schwarz import apply

    card, cpu, x = helm_ops
    calls = _count_plain_on_cuda(monkeypatch)
    xc = x[:, :, :mu].contiguous()
    xg = xc.to("cuda")
    before = (kmod.launches, kmod.spmm_launches)
    for fn in (gmv, apply):
        got = fn(card, xg).cpu().numpy()
        want = fn(cpu, xc).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    assert (kmod.launches, kmod.spmm_launches) == (
        before[0] + (mu == 1), before[1] + (mu > 1))
    assert calls[0] == 0


def test_helmholtz_solve_never_runs_plain_on_cuda(helm_ops, monkeypatch):
    """A c128 ORAS solve on the card: B1 launches, no plain-version call,
    the CPU port's count."""
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.krylov import solve

    card, cpu, x = helm_ops
    calls = _count_plain_on_cuda(monkeypatch)
    f = scaled_exchange(cpu.dec, x[:, :, :1].contiguous())
    opt = Options(tol=1e-8, gmres_restart=200, max_it=300)
    before = kmod.launches
    res = solve(card, f.to("cuda"), opt=opt)
    assert kmod.launches > before and calls[0] == 0
    assert res.iterations == solve(cpu, f, opt=opt).iterations
    assert res.x.dtype == torch.complex128


@pytest.fixture(scope="module")
def renumbered():
    """A small unstructured problem in the interface-first layout, set up
    on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    gen = unstructured.generate(4, 30, 30, overlap=2, with_neumann=False)
    return {dev: Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         renumber=True, device=dev) for dev in ("cuda", "cpu")}


@pytest.mark.parametrize("mu", [1, 4])
def test_renumbered_gmv_runs_b4_bitwise_plain(renumbered, mu):
    """The gmv of the interface-first layout runs B4 (no B5 plan there)
    and equals the plain ELL form on the same renumbered batch, bitwise;
    its exchange equals the CPU's, bitwise."""
    card, cpu = renumbered["cuda"], renumbered["cpu"]
    state = card.operator_state()
    assert state.dec.renumbered and state.dec.pexch is None
    x = torch.as_tensor(np.random.default_rng(mu).normal(
        size=(state.dec.S, card.n_max, mu)), device="cuda")
    before = (ek.launches, pk.launches)
    y = gmv(state, x)
    assert (ek.launches, pk.launches) == (before[0] + 1, before[1])
    assert torch.equal(y, scaled_exchange(state.dec, spmm_ell(state.A, x)))
    assert torch.equal(exchange(state.dec, x).cpu(),
                       exchange(cpu.dec, x.cpu()))


def test_bf16_gmv_on_card_matches_cpu(cuda):
    """-hpddm_gmv_dtype bfloat16 in f32 on a grid: the card's gmv (the
    plain DIA form on the mirror, no B1 launch) agrees with the CPU's."""
    from hpddm_tpu_torch.options import Options

    gen = diffusion2d.generate_uniform(4, 64, 64, overlap=1, dtype=np.float32)
    st = {}
    for dev in ("cuda", "cpu"):
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=Options(gmv_dtype="bfloat16"), device=dev)
        sch.set_grid_geometry(gen.boxes, 64, 64)
        st[dev] = sch.operator_state()
    x = np.random.default_rng(2).normal(
        size=(4, st["cpu"].dec.n_max, 1)).astype(np.float32)
    before = kmod.launches
    y = gmv(st["cuda"], torch.from_numpy(x).to("cuda")).cpu().numpy()
    assert kmod.launches == before
    want = gmv(st["cpu"], torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def cheby_ops():
    """Slice 5d: generate_uniform(4, 64, 64) with a contrast-100 channel,
    set up on the card and on the CPU with grid geometry (canvas operator,
    slab exchange); the dst_cheby states share the CPU state's bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from hpddm_tpu_torch.options import Options

    gen = diffusion2d.generate_uniform(
        4, 64, 64, overlap=1,
        kappa=lambda x, y: np.where((y > 3.3) & (y < 6.6), 100.0, 1.0))
    out = {}
    for kind in ("dst_cheby", "cheby", "fft"):
        for device in ("cuda", "cpu"):
            sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                          options=Options(local_solver=kind,
                                          local_cheby_steps=12, tol=1e-8),
                          device=device)
            sch.set_grid_geometry(gen.boxes, 64, 64)
            out[kind, device] = sch.build()
    for kind in ("dst_cheby", "cheby"):
        cpu = out[kind, "cpu"].solver
        card = out[kind, "cuda"]
        out[kind, "cuda"] = dataclasses.replace(
            card, solver=dataclasses.replace(card.solver,
                                             lo=cpu.lo.cuda(),
                                             hi=cpu.hi.cuda()))
    x = np.random.default_rng(5).normal(size=(4, out["fft", "cpu"].dec.n_max,
                                              4))
    return out, torch.as_tensor(x), gen


@pytest.mark.parametrize("mu", [1, 4])
@pytest.mark.parametrize("kind", ["dst_cheby", "cheby", "fft"])
def test_local_solvers_on_card_match_cpu(cheby_ops, kind, mu, monkeypatch):
    """One local solve of each slice-5d solver on the card against the CPU
    port (the Chebyshev states on the same bounds); a Chebyshev solve on a
    canvas DIA operator launches B1 (mu=1) or B2 (mu=4) once a step, and
    never a plain version."""
    out, x, _ = cheby_ops
    calls = _count_plain_on_cuda(monkeypatch)
    xc = x[:, :, :mu].contiguous()
    before = (kmod.launches, kmod.spmm_launches)
    got = out[kind, "cuda"].solver.solve(xc.cuda()).cpu().numpy()
    want = out[kind, "cpu"].solver.solve(xc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    steps = 0 if kind == "fft" else 12
    assert (kmod.launches - before[0], kmod.spmm_launches - before[1]) == \
        ((steps, 0) if mu == 1 else (0, steps))
    assert calls[0] == 0


def test_dst_modes_agree_on_card(cheby_ops):
    from hpddm_tpu_torch.ops.fft_solve import build_fft_solver

    _, x, gen = cheby_ops
    n_max = x.shape[1]
    a, b = (build_fft_solver(gen.boxes, 64, 64, n_max, dtype=torch.float64,
                             mode=m, device="cuda") for m in ("fft",
                                                              "matmul"))
    xg = x.cuda()
    assert float((a.solve(xg) - b.solve(xg)).abs().max()) <= 1e-12


@pytest.mark.parametrize("kind", ["dst_cheby", "fft"])
def test_chebyshev_and_fft_solves_on_card_match_cpu(cheby_ops, kind):
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.solvers.krylov import solve

    out, _, gen = cheby_ops
    f = np.zeros((4, out[kind, "cpu"].dec.n_max, 1))
    for s in range(4):
        f[s, : gen.n_loc[s]] = gen.f[s]
    opt = Options(tol=1e-8, max_it=200)
    res = solve(out[kind, "cuda"], torch.as_tensor(f, device="cuda"),
                opt=opt)
    ref = solve(out[kind, "cpu"], torch.as_tensor(f), opt=opt)
    assert abs(res.iterations - ref.iterations) <= 1


def test_dense_variant_and_saddle_on_card_match_cpu():
    """The dense Schwarz variant (one level and EVP + deflated with a user
    GMV) and the Stokes saddle-point solver (N=16, S=4, GenEO nu=4) take
    the CPU port's counts on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from hpddm_tpu_torch.models import stokes2d
    from hpddm_tpu_torch.options import Options
    from hpddm_tpu_torch.precond.dense import DenseSchwarz
    from hpddm_tpu_torch.precond.saddle import SaddleSolver
    from hpddm_tpu_torch.solvers.gmres import gmres

    gen = diffusion2d.generate(4, 30, 30, overlap=1)
    its = {}
    for device in ("cuda", "cpu"):
        blocks = [m.dense() for m in gen.mats]
        inner = DenseSchwarz(blocks, gen.neighbors, gen.mappings, d=gen.d,
                             device=device)
        ds = DenseSchwarz(blocks, gen.neighbors, gen.mappings, d=gen.d,
                          options=Options(schwarz_coarse_correction="deflated",
                                          geneo_nu=5),
                          user_gmv=inner.gmv, device=device)
        ds.solve_evp()
        f = np.zeros((4, ds.n_max, 1))
        for s in range(4):
            f[s, : gen.n_loc[s]] = gen.f[s]
        res = gmres(ds.build(), torch.as_tensor(f, device=device), tol=1e-8,
                    restart=60, max_it=200)
        its[device] = res.iterations
    assert its["cuda"] == its["cpu"]
    sgen, B, sf, sg, _, neu = stokes2d.generate(4, N=16, overlap=2,
                                                with_neumann=True)
    out = {}
    for device in ("cuda", "cpu"):
        opt = Options(tol=1e-10, max_it=400,
                      schwarz_coarse_correction="deflated", geneo_nu=4)
        r = SaddleSolver(sgen, B, options=opt, neumann=neu,
                         device=device).solve(sf, sg, tol=1e-8)
        out[device] = r
    assert out["cuda"].outer_iterations == out["cpu"].outer_iterations
    assert abs(out["cuda"].inner_iterations
               - out["cpu"].inner_iterations) <= 2
    np.testing.assert_allclose(out["cuda"].u, out["cpu"].u, rtol=0,
                               atol=1e-7)
