"""Port vs JAX package: the unstructured P1-FEM path on the CPU in f64.

The parity configuration is the JAX driver's default
(``examples/unstructured.py``): a 60x60 jittered Delaunay mesh, S=8
subdomains by k-way partition, overlap 2, RCM-ordered local numbering, ELL
local matrices, two-level GenEO-RAS (nu=8, deflated) and right GMRES.

* Host setup (mesh, assembly, partition, decomposition, RCM numbering,
  ELL packing) is numpy/scipy in both packages: byte-equal.
* The ELL product sums each row in storage order; the JAX package's
  einsum and its windowed kernel (which column-sorts every row) sum in
  other orders: rtol 1e-12 of max|y|, as ``tests/test_unstructured.py``.
* The exchange's plain version ``pexchange_reference`` is bitwise equal to
  the JAX package's XLA general path, and equal in value to its Pallas
  exchange in interpret mode (whose masking turns -0.0 into +0.0: ROADMAP
  queue C, C1).
* GMRES takes the JAX package's iteration counts (8 at tol 1e-6, 10 at
  tol 1e-8), with the port's own setup (x at rtol 1e-7: the GenEO bases
  differ by eigensolver rounding) and with the port's runtime on the JAX
  package's setup (x at rtol 1e-10: identical operators).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpddm_tpu.core.formats import batched_dense_from as jax_dense
from hpddm_tpu.core.formats import pack_local_matrices as jax_pack
from hpddm_tpu.models import fromfile as jax_ff
from hpddm_tpu.models import unstructured as jax_un
from hpddm_tpu.ops.pallas_ell import annotate_windowed, spmm_windowed
from hpddm_tpu.ops.spmv import spmm_ell as jax_spmm_ell
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.parallel import ops as jax_ops
from hpddm_tpu.parallel import pexchange as jax_pex
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.core.formats import (BatchedDIA, BatchedELL,
                                          batched_dense_from,
                                          pack_local_matrices)
from hpddm_tpu_torch.examples import schwarz as grid_driver
from hpddm_tpu_torch.examples import unstructured as driver
from hpddm_tpu_torch.examples.library_ops import exchange_csr
from hpddm_tpu_torch.models import diffusion2d, fromfile, unstructured
from hpddm_tpu_torch.ops import ell_spmv as kmod
from hpddm_tpu_torch.ops.spmv import spmm, spmm_ell
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel import ops, pexchange
from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve
from test_torch_gmres import root_chip_smoke
from test_torch_schwarz import jax_state_arrays

chip_smoke = root_chip_smoke()
S, NX, OVERLAP, NU = 8, 60, 2, 8
TOLS = (1e-6, 1e-8)


def _options(jax=False):
    cls = JaxOptions if jax else Options
    return cls(schwarz_coarse_correction="deflated", geneo_nu=NU)


def _rhs(gen, n_max):
    f = np.zeros((len(gen.n_loc), n_max, 1))
    for s in range(len(gen.n_loc)):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return f


@pytest.fixture(scope="module")
def gens():
    """(JAX, port) generated problems at the parity configuration."""
    return (jax_un.generate(S, NX, NX, overlap=OVERLAP, with_neumann=True),
            unstructured.generate(S, NX, NX, overlap=OVERLAP,
                                  with_neumann=True))


@pytest.fixture(scope="module")
def setups(gens):
    """(JAX Schwarz, JAX state, the port's Schwarz, its state, rhs)."""
    jgen, gen = gens
    jsch = jax_sz.Schwarz(jgen.mats, jgen.neighbors, jgen.mappings,
                          d=jgen.d, options=_options(jax=True))
    jsch.solve_gevp(jgen.neumann)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=_options(), device="cpu")
    sch.solve_gevp(gen.neumann)
    return jsch, jsch.build(), sch, sch.build(), _rhs(jgen, jsch.n_max)


_JAX_RESULTS = {}


def _jax_result(setups, tol):
    """The JAX solve at tol, computed once per module."""
    if tol not in _JAX_RESULTS:
        _JAX_RESULTS[tol] = jax_solve(setups[1], jnp.asarray(setups[4]),
                                      opt=JaxOptions(tol=tol))
    return _JAX_RESULTS[tol]


def _csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    for key in ("indptr", "indices", "data"):
        assert getattr(a, key).tobytes() == getattr(b, key).tobytes(), key


def _generated_equal(port, ref, mesh=True):
    assert port.n_loc == ref.n_loc
    assert port.neighbors == ref.neighbors
    np.testing.assert_array_equal(port.owner, ref.owner)
    _csr_equal(port.A_global, ref.A_global)
    for s in range(len(ref.mats)):
        _csr_equal(port.mats[s].scipy(), ref.mats[s].scipy())
        for key in ("gids", "d", "f"):
            assert getattr(port, key)[s].tobytes() == \
                getattr(ref, key)[s].tobytes(), key
        for mp, mr in zip(port.mappings[s], ref.mappings[s]):
            assert mp.tobytes() == mr.tobytes()
    if not mesh:
        return
    for key in ("points", "triangles", "boundary"):
        assert getattr(port, key).tobytes() == getattr(ref, key).tobytes()
    if ref.neumann is not None:
        for mp, mr in zip(port.neumann, ref.neumann):
            _csr_equal(mp.scipy(), mr.scipy())


def test_generate_kway_byte_equal(gens):
    jgen, gen = gens
    _generated_equal(gen, jgen)


def test_generate_geometric_byte_equal():
    kw = dict(overlap=1, with_neumann=True, partition="geometric",
              grading=0.5, seed=3)
    _generated_equal(unstructured.generate(6, 30, 24, **kw),
                     jax_un.generate(6, 30, 24, **kw))


def test_partition_kway_and_decompose_equal(gens):
    """On an assembled matrix alone (the schwarzFromFile path): the k-way
    partition and the decomposition with RCM local numbering."""
    jgen, _ = gens
    A = jgen.A_global
    owner = fromfile.partition_kway(A, 5)
    np.testing.assert_array_equal(owner, jax_ff.partition_kway(A, 5))
    f = np.random.default_rng(2).normal(size=A.shape[0])
    port = fromfile.decompose(MatrixCSR(A), 5, overlap=2, f_global=f,
                              rcm_local=True)
    from hpddm_tpu.core.csr import MatrixCSR as JaxCSR
    ref = jax_ff.decompose(JaxCSR(A), 5, overlap=2, f_global=f,
                           rcm_local=True)
    _generated_equal(port, ref, mesh=False)


def test_ell_packing_byte_equal(gens):
    jgen, gen = gens
    ref = jax_pack(jgen.mats)
    got = pack_local_matrices(gen.mats, device="cpu")
    assert isinstance(got, BatchedELL) and got.n_max == ref.n_max
    # the port stores the JAX package's (S, n_max, w) arrays slot-major
    assert got.values.is_contiguous() and got.cols.is_contiguous()
    assert got.values.transpose(1, 2).contiguous().numpy().tobytes() == \
        np.asarray(ref.values).tobytes()
    assert got.cols.dtype == torch.int32
    assert got.cols.transpose(1, 2).contiguous().numpy().tobytes() == \
        np.asarray(ref.cols).tobytes()
    # identity padding rows, dense copies by subdomain slice
    assert batched_dense_from(got).numpy().tobytes() == \
        np.asarray(jax_dense(ref)).tobytes()
    np.testing.assert_array_equal(batched_dense_from(got, slice(2, 4)),
                                  np.asarray(jax_dense(ref))[2:4])


@pytest.mark.parametrize("mu", [1, 3])
def test_spmm_ell_matches_jax_and_windowed_kernel(gens, mu):
    jgen, gen = gens
    jA = jax_pack(jgen.mats)
    A = pack_local_matrices(gen.mats, device="cpu")
    x = np.random.default_rng(10 + mu).normal(size=(S, A.n_max, mu))
    y = spmm(A, torch.as_tensor(x)).numpy()
    assert kmod.launches == 0                    # CPU: plain version only
    assert torch.equal(spmm_ell(A, torch.as_tensor(x)), torch.as_tensor(y))
    y_ref = np.asarray(jax_spmm_ell(jA, jnp.asarray(x)))
    y_win = np.asarray(spmm_windowed(annotate_windowed(jA), jnp.asarray(x),
                                     interpret=True))
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(y, y_win, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("mu", [1, 3])
def test_pexchange_reference_equals_xla_and_pallas(setups, mu):
    jsch, _, sch, _, _ = setups
    plan = sch.dec.pexch
    assert plan is not None and plan.dst.dtype == plan.rows.dtype == \
        torch.int32 and plan.interior.dtype == torch.bool
    x = np.random.default_rng(20 + mu).normal(size=(S, sch.n_max, mu))
    x[:, ::7] = -0.0                              # signed zeros: caveat C1
    tx = torch.as_tensor(x)
    got = pexchange.pexchange(plan, tx)
    assert pexchange.launches == 0                # CPU: plain version only
    assert torch.equal(got, pexchange.pexchange_reference(plan, tx))
    # bitwise (sign bits included) against the XLA general path and the
    # port's plain exchange
    want = np.asarray(jax_ops.exchange(jsch.dec, jnp.asarray(x)))
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numpy().tobytes() == ops.exchange(sch.dec, tx).numpy().tobytes()
    # in value against the Pallas exchange in interpret mode
    jplan = jax_pex.build_plan(jsch.dec)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_pex.pexchange(jplan, jnp.asarray(x),
                                                  interpret=True)))


def test_schwarz_attaches_ell_payloads_only_to_ell(setups):
    _, _, sch, state, _ = setups
    assert isinstance(state.A, BatchedELL)
    w = state.A.values.shape[1]
    assert state.A.values.shape == state.A.cols.shape == (S, w, sch.n_max)
    assert state.A.values.is_contiguous() and state.A.cols.is_contiguous()
    assert state.dec.pexch is not None
    g = diffusion2d.generate(4, 20, 20, overlap=1)
    dia = sz.Schwarz(g.mats, g.neighbors, g.mappings, d=g.d, device="cpu")
    assert isinstance(dia.A, BatchedDIA) and dia.dec.pexch is None


def test_geneo_neumann_dense_eigenvalues_match_jax(gens, setups):
    """The dense pencil on the FEM Neumann matrices (packed dense, one
    subdomain at a time) against the JAX package's, rtol 1e-9."""
    from hpddm_tpu.precond.geneo import scale_into_overlap as jscale
    from hpddm_tpu.precond.geneo import solve_gevp_dense as jgevp
    from hpddm_tpu_torch.precond.geneo import (scale_into_overlap,
                                               solve_gevp_dense)
    jgen, gen = gens
    jsch, _, sch, _, _ = setups
    sub = slice(1, 3)
    jA_neu = jax_dense(jax_pack(jgen.neumann[sub], n_max=jsch.n_max,
                                fmt="dense"))
    jlam, _ = jgevp(jA_neu, jscale(jsch.A, jsch.dec)[sub], 4)
    A_neu = torch.stack([pack_local_matrices([m], n_max=sch.n_max,
                                             fmt="dense", device="cpu")
                         .values[0] for m in gen.neumann[sub]])
    lam, _ = solve_gevp_dense(A_neu, scale_into_overlap(sch.A, sch.dec, sub),
                              4)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-9)


@pytest.mark.parametrize("tol", TOLS)
@pytest.mark.parametrize("which", ["own_setup", "jax_setup"])
def test_gmres_iterations_and_solution(setups, which, tol):
    jstate, state, f = setups[1], setups[3], setups[4]
    rtol = 1e-7
    if which == "jax_setup":
        state = interop.state_from_numpy(jax_state_arrays(jstate),
                                         device="cpu")
        assert isinstance(state.A, BatchedELL) and state.dec.pexch is not None
        rtol = 1e-10
    jres = _jax_result(setups, tol)
    res = solve(state, torch.as_tensor(f), opt=Options(tol=tol))
    assert res.iterations == int(jres.iterations) == \
        chip_smoke.UNSTR_ITS[tol]
    assert bool(res.converged.all())
    want = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_chip_smoke_unstructured_constants(setups):
    """chip_smoke.py holds the card's f64 run to these counts: they must be
    the JAX package's CPU-f64 iteration counts at the parity config."""
    assert chip_smoke.UNSTR_ITS == {
        tol: int(_jax_result(setups, tol).iterations) for tol in TOLS}


@pytest.mark.parametrize("mu", [1, 3])
def test_chip_smoke_exchange_matrix_is_the_exchange(setups, mu):
    """The smoke and the bench time torch.sparse.mm on I + P
    (examples/library_ops.py) as the library call of the exchange: that
    matrix must compute the exchange (rtol 1e-14: the sparse product sums
    in its own order)."""
    sch = setups[2]
    plan = sch.dec.pexch
    E = exchange_csr(plan, torch.float64)
    x = torch.as_tensor(np.random.default_rng(30 + mu).normal(
        size=(S, sch.n_max, mu)))
    want = pexchange.pexchange_reference(plan, x)
    got = torch.sparse.mm(E, x.reshape(-1, mu)).reshape(x.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-14,
                               atol=1e-14 * float(want.abs().max()))
    assert E._nnz() == S * sch.n_max + int((plan.rows >= 0).sum())


def test_driver_twin_exits_zero(capsys):
    argv = ["-N", "4", "-Nx", "30", "-device", "cpu",
            "-hpddm_schwarz_coarse_correction", "deflated",
            "-hpddm_geneo_nu", "6"]
    assert driver.main(argv) == 0
    out = capsys.readouterr().out
    assert "true residual" in out and "iterations" in out


def _no_cuda_calls(gens):
    _, gen = gens
    dec = Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                        gen.n_loc, d=gen.d, device="cpu")
    arrays = {k: getattr(dec, k).numpy() for k in (
        "n_loc", "d", "if_idx", "if_gid", "if_mask", "ov_mask", "mult",
        "partners", "inv_map", "is_if")}
    arrays.update({k: getattr(dec, k) for k in interop.DEC_INT_KEYS})
    A = pack_local_matrices(gen.mats, n_max=dec.n_max, device="cpu")
    arrays.update(A_values=A.values.transpose(1, 2).numpy(),
                  A_cols=A.cols.transpose(1, 2).numpy(),
                  factor=np.zeros((S, 1, 1)), variant="ras")
    return {
        "Schwarz": lambda: sz.Schwarz(gen.mats, gen.neighbors, gen.mappings,
                                      d=gen.d),
        "Decomposition": lambda: Decomposition.from_subdomains(
            gen.neighbors, gen.mappings, gen.n_loc, d=gen.d),
        "pack_local_matrices": lambda: pack_local_matrices(gen.mats),
        "state_from_numpy": lambda: interop.state_from_numpy(arrays),
        "unstructured driver": lambda: driver.main(["-N", "2", "-Nx", "10"]),
        "schwarz driver": lambda: grid_driver.main(["-N", "2", "-Nx", "10",
                                                    "-Ny", "10"]),
    }


@pytest.mark.parametrize("entry", [
    "Schwarz", "Decomposition", "pack_local_matrices", "state_from_numpy",
    "unstructured driver", "schwarz driver"])
def test_entry_points_default_to_cuda(gens, monkeypatch, entry):
    """Without a CUDA device, an entry point called without a device
    raises; it does not run on the CPU."""
    calls = _no_cuda_calls(gens)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("what,call,match", [
    ("dst_cheby", lambda g: sz.Schwarz(
        g.mats, g.neighbors, g.mappings, d=g.d, device="cpu",
        options=Options(local_solver="dst_cheby")).build(),
     "dst_cheby requires set_grid_geometry"),
    ("fft", lambda g: sz.Schwarz(
        g.mats, g.neighbors, g.mappings, d=g.d, device="cpu",
        options=Options(local_solver="fft")).build(),
     "fft requires set_grid_geometry"),
    ("lanczos dst_cheby", lambda g: sz.Schwarz(
        g.mats, g.neighbors, g.mappings, d=g.d, device="cpu",
        options=Options(local_solver="dst_cheby")).solve_gevp(
            g.neumann, method="lanczos"),
     "dst_cheby requires set_grid_geometry"),
    ("spsd_neumann", None, None),
])
def test_out_of_scope_branches_raise(gens, what, call, match):
    """An unstructured mesh has no grid boxes, so the DST solves (``fft``,
    ``dst_cheby`` and their Lanczos inner solve) raise ``ValueError``, as
    the JAX package's builds do. ``spsd_neumann`` does on this mesh what
    the JAX package's does: the same local matrices, element for element,
    and the same warnings (none on this mesh: every edge lies in a
    subdomain and no diagonal remainder is negative)."""
    if what == "spsd_neumann":
        jgen, gen = gens
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            theirs = jax_ff.spsd_neumann(jgen)
        with warnings.catch_warnings(record=True) as mw:
            warnings.simplefilter("always")
            mine = fromfile.spsd_neumann(gen)
        assert [str(w.message) for w in mw] == [str(w.message) for w in jw]
        assert len(mine) == len(theirs)
        for a, b in zip(theirs, mine):
            a, b = a.scipy(expand=True), b.scipy(expand=True)
            assert np.array_equal(a.indptr, b.indptr)
            assert np.array_equal(a.indices, b.indices)
            assert np.array_equal(a.data, b.data)
        return
    with pytest.raises(ValueError, match=match):
        call(gens[1])


def test_ell_astype_and_plain_versions_agree():
    """BatchedELL.astype converts the values and keeps the columns, and
    the plain ELL product of an f32 batch equals the f64 one rounded
    (values and x exactly representable, sums short)."""
    rng = np.random.default_rng(4)
    cols = torch.as_tensor(rng.integers(0, 50, size=(3, 4, 50)),
                           dtype=torch.int32)
    vals = torch.as_tensor(rng.integers(-3, 4, size=(3, 4, 50)) * 0.5)
    A = BatchedELL(values=vals, cols=cols, n_max=50)
    A32 = A.astype(torch.float32)
    assert A32.values.dtype == torch.float32 and A32.cols is A.cols
    assert torch.equal(A32.values, A.values.float())
    x = torch.as_tensor(rng.integers(-4, 5, size=(3, 50, 2)) * 0.25)
    assert torch.equal(spmm(A32, x.float()), spmm(A, x).float())
    dense = batched_dense_from(A)
    assert torch.equal(spmm(A, x), torch.bmm(dense, x))
