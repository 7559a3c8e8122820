"""Port vs JAX package: banded exact local solves and Lanczos GenEO on the
CPU in f64 (slice 3a).

* ``diffusion2d.generate_uniform`` is byte-equal to the JAX package's.
* ``_extract_blocks`` and the host Schur recursion are the JAX package's
  numpy code: their outputs are ``np.array_equal``, on grid boxes with
  diagonal coupling, with dense coupling (a 9-point matrix) and through
  RCM, at 1 and 3 grid rows per block.
* A banded solve agrees with the JAX package's at rtol 1e-12 (the same
  products summed in another order) and with scipy's sparse direct solve
  at rtol 1e-9 (``tests/test_banded.py``'s bound); the device recursion
  agrees with the host one at 1e-12 in f64 and solves to < 5e-4 in f32.
* Lanczos GenEO takes the JAX package's start vector and steps:
  eigenvalues at rtol 1e-8, eigenvector subspaces with every
  principal-angle cosine >= 1 - 1e-8.
* Iteration counts equal the JAX package's. On grid boxes both sides
  call ``set_grid_geometry``, which switches both to the slab exchange
  and the canvas operator.
* The ELL payload's plain version gives NaN where the JAX package's
  ``spmm_ell`` does when x[s, 0] is not finite.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from hpddm_tpu.core.formats import pack_local_matrices as jax_pack
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.models import unstructured as jax_un
from hpddm_tpu.ops import banded_solve as jax_bs
from hpddm_tpu.ops.spmv import spmm_ell as jax_spmm_ell
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond import geneo as jax_geneo
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.core.formats import pack_local_matrices
from hpddm_tpu_torch.examples import schwarz as grid_driver
from hpddm_tpu_torch.examples import unstructured as unstr_driver
from hpddm_tpu_torch.models import diffusion2d, unstructured
from hpddm_tpu_torch.ops import banded_solve as bs
from hpddm_tpu_torch.ops import ell_spmv as ek
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import geneo
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve
from test_torch_gmres import root_chip_smoke
from test_torch_schwarz import jax_state_arrays

S = 4


def kappa(x, y):
    """High-contrast horizontal channels (``tests/test_banded.py``)."""
    return np.where((np.floor(y * 1.7) % 2) == 0, 1e3, 1.0)


def _gens(N, kap=kappa):
    return (jax_d2.generate_uniform(S, N, N, overlap=2, kappa=kap,
                                    with_neumann=True),
            diffusion2d.generate_uniform(S, N, N, overlap=2, kappa=kap,
                                         with_neumann=True))


@pytest.fixture(scope="module")
def grid48():
    return _gens(48)


@pytest.fixture(scope="module")
def grid64():
    return _gens(64)


@pytest.fixture(scope="module")
def mesh():
    """(JAX, port) unstructured parity problems: 60x60 mesh, S=8, k-way,
    overlap 2."""
    return (jax_un.generate(8, 60, 60, overlap=2, with_neumann=True),
            unstructured.generate(8, 60, 60, overlap=2, with_neumann=True))


def _nine_point():
    """A 16x16 matrix on a 4x4 grid with corner coupling (9-point-like):
    dense coupling blocks (``tests/test_banded.py:67``)."""
    n = 16
    return sp.diags([np.ones(n - 3), -np.ones(n - 1), 8 * np.ones(n),
                     -np.ones(n - 1), np.ones(n - 3)],
                    [-3, -1, 0, 1, 3]).tocsr()


def _rcm_input(gen):
    """(csrs, slot maps, boxes) as ``build_banded_solver_rcm`` makes them."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csrs, maps, bws = [], [], []
    for m in gen.mats:
        K = m.scipy(expand=True)
        perm = np.asarray(reverse_cuthill_mckee(K, symmetric_mode=True))
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(len(perm))
        coo = K.tocoo()
        bws.append(int(np.abs(iperm[coo.row] - iperm[coo.col]).max()))
        csrs.append(K)
        maps.append(iperm.astype(np.int64))
    wx = -(-max(max(bws), 8) // 8) * 8
    return csrs, maps, [(0, wx, 0, -(-K.shape[0] // wx)) for K in csrs]


def _block_inputs(mode, grid48, mesh):
    """(JAX inputs, port inputs): (mats, boxes, n_max, slot_maps)."""
    if mode == "diagonal":
        out = [(g.mats, g.boxes, max(g.n_loc), None) for g in grid48]
    elif mode == "dense coupling":
        A = _nine_point()
        out = [([A], [(0, 4, 0, 4)], 16, None)] * 2
    else:
        out = []
        for g in mesh:
            csrs, maps, boxes = _rcm_input(g)
            out.append((csrs, boxes, max(g.n_loc), maps))
    return out


@pytest.mark.parametrize("kap", [None, kappa], ids=["kappa None",
                                                    "contrast 1e3"])
def test_generate_uniform_is_byte_equal(kap):
    ref, port = _gens(48, kap)
    assert port.boxes == ref.boxes and port.n_loc == ref.n_loc
    assert port.neighbors == ref.neighbors and port.grid == ref.grid
    for a, b in zip(port.mappings, ref.mappings):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for key in ("d", "f"):
        for x, y in zip(getattr(port, key), getattr(ref, key)):
            assert x.tobytes() == y.tobytes()
    for mats in ("mats", "neumann"):
        for a, b in zip(getattr(port, mats), getattr(ref, mats)):
            a, b = a.scipy().tocsr(), b.scipy().tocsr()
            for k in ("indptr", "indices", "data"):
                assert getattr(a, k).tobytes() == getattr(b, k).tobytes()


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("mode", ["diagonal", "dense coupling", "rcm"])
def test_blocks_and_host_factors_equal_jax(grid48, mesh, mode, r):
    (jm, jb, jn, jmaps), (pm, pb, pn, pmaps) = _block_inputs(mode, grid48,
                                                             mesh)
    ref = jax_bs._extract_blocks(jm, jb, jn, jmaps, r)
    out = bs._extract_blocks(pm, pb, pn, pmaps, r)
    assert out[7] == ref[7] == (mode != "diagonal")     # dense_mode
    assert out[8:] == ref[8:]                          # nbk, L, wx_max
    for a, b in zip(out[:7], ref[:7]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    Dinv = bs._schur_host(out[0].copy(), out[1], out[2], out[7], out[10])
    jDinv = jax_bs._schur_host(ref[0].copy(), ref[1], ref[2], ref[7],
                               ref[10])
    assert np.array_equal(Dinv, jDinv)
    solver = (bs.build_banded_solver(pm, pb, pn, dtype=torch.float64,
                                     slot_maps=pmaps, rows_per_block=r,
                                     method="host", device="cpu"))
    assert np.array_equal(solver.Dinv.numpy(), jDinv)


@pytest.mark.parametrize("mode", ["diagonal", "dense coupling", "rcm"])
def test_solve_matches_jax_and_spsolve(grid48, mesh, mode):
    (jm, jb, jn, jmaps), (pm, pb, pn, pmaps) = _block_inputs(mode, grid48,
                                                             mesh)
    ref = jax_bs.build_banded_solver(jm, jb, jn, dtype=jnp.float64,
                                     slot_maps=jmaps, method="host")
    solver = bs.build_banded_solver(pm, pb, pn, dtype=torch.float64,
                                    slot_maps=pmaps, method="host",
                                    device="cpu")
    assert solver.cl.dim() == (4 if mode != "diagonal" else 3)
    rng = np.random.default_rng(0)
    b = rng.normal(size=(len(pm), pn, 2))
    x = solver.solve(torch.as_tensor(b)).numpy()
    want = np.asarray(ref.solve(jnp.asarray(b)))
    np.testing.assert_allclose(x, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    for s, m in enumerate(pm):
        K = m.scipy(expand=True) if hasattr(m, "scipy") else m
        n = K.shape[0]
        direct = sp.linalg.spsolve(K.tocsc(), b[s, :n, 0])
        np.testing.assert_allclose(x[s, :n, 0], direct, rtol=1e-9,
                                   atol=1e-9 * np.abs(direct).max())
        assert not x[s, n:].any()                  # padded rows stay zero


def test_wide_coupling_raises():
    """Coupling two grid rows apart is not block-tridiagonal."""
    n = 16
    A = sp.diags([np.ones(n - 8), -np.ones(n - 1), 4 * np.ones(n),
                  -np.ones(n - 1), np.ones(n - 8)],
                 [-8, -1, 0, 1, 8]).tocsr()
    with pytest.raises(ValueError, match="block-tridiagonal"):
        bs.build_banded_solver([A], [(0, 4, 0, 4)], 16, device="cpu")


def test_device_recursion_f64_and_f32(grid48):
    """method="device" in f64 agrees with the host factors at 1e-12; in
    f32 it solves every local system to a relative residual < 5e-4
    (``tests/test_banded.py:270-288``). On the CPU "auto" takes host."""
    gen = grid48[1]
    n_max = max(gen.n_loc)
    kw = dict(device="cpu")
    host = bs.build_banded_solver(gen.mats, gen.boxes, n_max,
                                  dtype=torch.float64, method="host", **kw)
    dev = bs.build_banded_solver(gen.mats, gen.boxes, n_max,
                                 dtype=torch.float64, method="device", **kw)
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.normal(size=(S, n_max, 2)))
    np.testing.assert_allclose(dev.solve(b).numpy(), host.solve(b).numpy(),
                               rtol=1e-12, atol=1e-12)
    auto32 = bs.build_banded_solver(gen.mats, gen.boxes, n_max, **kw)
    assert torch.equal(auto32.Dinv, host.Dinv.float())
    f32 = bs.build_banded_solver(gen.mats, gen.boxes, n_max,
                                 dtype=torch.float32, method="device", **kw)
    b32 = np.zeros((S, n_max, 1), dtype=np.float32)
    for s in range(S):
        b32[s, : gen.n_loc[s], 0] = rng.normal(size=gen.n_loc[s])
    x = f32.solve(torch.as_tensor(b32)).double().numpy()
    for s in range(S):
        K = gen.mats[s].scipy(expand=True)
        bs_ = b32[s, : gen.n_loc[s], 0].astype(np.float64)
        rel = np.linalg.norm(K @ x[s, : gen.n_loc[s], 0] - bs_) / \
            np.linalg.norm(bs_)
        assert rel < 5e-4, (s, rel)


def _principal_cosines(A, B):
    qa, _ = np.linalg.qr(A)
    qb, _ = np.linalg.qr(B)
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def _assert_same_pairs(lam, V, jlam, jV):
    np.testing.assert_allclose(lam, jlam, rtol=1e-8)
    for s in range(lam.shape[0]):
        cos = _principal_cosines(V[s], jV[s])
        assert cos.min() >= 1 - 1e-8, (s, cos.min())


def test_lanczos_on_dense_operators():
    """The function alone, both packages called the same way, on a random
    SPD pencil with a singular PSD B."""
    rng = np.random.default_rng(3)
    n, nu = 60, 5
    A = np.stack([np.eye(n) * n + (lambda m: m @ m.T)(rng.normal(size=(n,
                                                                      n)))
                  for _ in range(3)])
    B = np.stack([(lambda m: m @ m.T)(rng.normal(size=(n, n // 2)))
                  for _ in range(3)])
    Ainv = np.linalg.inv(A)
    tA, tB = torch.as_tensor(Ainv), torch.as_tensor(B)
    lam, V = geneo.solve_gevp_lanczos(lambda x: tA @ x, lambda x: tB @ x,
                                      3, n, nu, seed=7, device="cpu")
    jA, jB = jnp.asarray(Ainv), jnp.asarray(B)
    jlam, jV = jax_geneo.solve_gevp_lanczos(lambda x: jA @ x,
                                            lambda x: jB @ x, 3, n, nu,
                                            seed=7)
    _assert_same_pairs(lam.numpy(), V.numpy(), np.asarray(jlam),
                       np.asarray(jV))


def _schwarz_pair(gens, options, jax_hook=True, port_geometry=True):
    """(JAX Schwarz, port Schwarz) on the same problem and options; grid
    boxes through set_grid_geometry on both (the slab exchange)."""
    jgen, gen = gens
    jsch = jax_sz.Schwarz(jgen.mats, jgen.neighbors, jgen.mappings,
                          d=jgen.d, options=JaxOptions(**options))
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(**options), device="cpu")
    if getattr(gen, "boxes", None) is not None:
        N = gen.grid[2]
        if jax_hook:
            jsch.set_grid_geometry(jgen.boxes, N, N)
        if port_geometry:
            sch.set_grid_geometry(gen.boxes, N, N)
    return jsch, sch


@pytest.mark.parametrize("inner", ["banded", "inv"])
def test_lanczos_geneo_matches_jax(grid64, inner):
    jsch, sch = _schwarz_pair(grid64, dict(local_solver=inner))
    jlam, jV = jsch._solve_gevp_lanczos(grid64[0].neumann, 8)
    lam, V = sch._solve_gevp_lanczos(grid64[1].neumann, 8)
    assert {"neumann_factor", "lanczos_steps", "lanczos_eig"} <= \
        set(sch.timings)
    _assert_same_pairs(lam.numpy(), V.numpy(), np.asarray(jlam),
                       np.asarray(jV))


def _f(gen, n_max):
    f = np.zeros((len(gen.n_loc), n_max, 1))
    for s in range(len(gen.n_loc)):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return f


def _iterations(gens, options, nu=0, both=True):
    """(JAX count, port count, port state): the solve at tol 1e-8 with
    GenEO (method "auto") when nu > 0; residuals checked <= 1e-6."""
    kw = dict(tol=1e-8, max_it=300, **options)
    if nu:
        kw.update(schwarz_coarse_correction="deflated", geneo_nu=nu)
    jsch, sch = _schwarz_pair(gens, kw)
    its = []
    for pkg, (gen, s) in enumerate(zip(gens, (jsch, sch))):
        if pkg == 0 and not both:
            its.append(None)
            continue
        f = _f(gen, s.n_max)
        f = s.exchange_rhs(jnp.asarray(f) if pkg == 0 else
                           torch.as_tensor(f))
        if nu:
            s.solve_gevp(gen.neumann)
        state = s.build()
        if pkg == 0:
            res = jax_solve(state, f, opt=JaxOptions(**kw))
            nb, nr = jax_sz.compute_residual(state, res.x, f)
        else:
            res = solve(state, f, opt=Options(**kw))
            nb, nr = sz.compute_residual(state, res.x, f)
        assert float(nr[0] / nb[0]) < 1e-6
        its.append(int(res.iterations))
    return its[0], its[1], state


def test_one_level_banded_equals_inv_and_jax(grid48):
    jb, pb, state = _iterations(grid48, dict(local_solver="banded"))
    _, pi, _ = _iterations(grid48, dict(local_solver="inv"), both=False)
    assert isinstance(state.solver, bs.BandedSolver)
    assert pb == jb == pi, (pb, jb, pi)


@pytest.fixture(scope="module")
def two_level64(grid64):
    return (_iterations(grid64, dict(local_solver="banded"), nu=8),
            _iterations(grid64, dict(local_solver="banded"), both=False))


def test_two_level_banded_lanczos_counts(two_level64):
    (j2, p2, _), (_, p1, _) = two_level64
    assert p2 == j2, (p2, j2)
    assert p2 < p1, (p2, p1)


def test_unstructured_banded_rcm_counts(mesh):
    """The unstructured parity configuration through RCM, with Lanczos
    GenEO (method "auto" takes it for banded)."""
    j, p, state = _iterations(mesh, dict(local_solver="banded"), nu=8)
    assert state.solver.cl.dim() == 4                 # dense coupling
    assert p == j, (p, j)


def test_port_apply_on_jax_banded_state(grid64):
    """interop: the port's runtime on a JAX-built two-level banded state."""
    jgen = grid64[0]
    kw = dict(local_solver="banded", schwarz_coarse_correction="deflated",
              geneo_nu=8)
    jsch, _ = _schwarz_pair(grid64, kw)
    jsch.solve_gevp(jgen.neumann)
    jstate = jsch.build()
    state = interop.state_from_numpy(jax_state_arrays(jstate), device="cpu")
    assert isinstance(state.solver, bs.BandedSolver)
    x = np.random.default_rng(5).normal(size=(S, jsch.n_max, 1))
    x = np.array(jsch.exchange_rhs(jnp.asarray(x)))
    want = np.asarray(jax_sz.apply(jstate, jnp.asarray(x)))
    got = sz.apply(state, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_banded_shapes_and_geometry_give_one_solver(grid48):
    gen = grid48[1]
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(local_solver="banded"), device="cpu")
    with pytest.raises(ValueError, match="set_grid_geometry"):
        sch._banded_boxes()
    sch.set_grid_geometry(gen.boxes, 48, 48)
    a = sch.build().solver
    sch.set_banded_shapes([(j1 - j0, i1 - i0)
                           for (i0, i1, j0, j1) in gen.boxes])
    b = sch.build().solver
    assert torch.equal(a.Dinv, b.Dinv) and a.cl.dim() == 3
    assert sch.rcm_bandwidths is None


@pytest.mark.parametrize("driver,argv", [
    (grid_driver, ["-N", "4", "-Nx", "40", "-Ny", "40"]),
    (unstr_driver, ["-N", "8", "-Nx", "40"])], ids=["schwarz", "unstructured"])
def test_driver_twins_run_banded(driver, argv):
    """-hpddm_local_solver banded through RCM (the generators set no grid
    geometry), two-level with Lanczos GenEO."""
    assert driver.main(argv + ["-hpddm_local_solver", "banded",
                               "-hpddm_schwarz_coarse_correction",
                               "deflated", "-hpddm_geneo_nu", "8",
                               "-device", "cpu"]) == 0


@pytest.mark.parametrize("value", [np.inf, np.nan], ids=["inf", "nan"])
def test_ell_payload_propagates_non_finite_x0(grid48, value):
    """Rows with trailing padding slots add 0 * x[s, 0]: NaN where the JAX
    package's full slot sum has it, the same values elsewhere."""
    jgen, gen = grid48
    A = pack_local_matrices(gen.mats, fmt="ell", device="cpu")
    jA = jax_pack(jgen.mats, fmt="ell")
    assert int(A.payload.counts.min()) < A.values.shape[1]   # padded rows
    x = np.random.default_rng(2).normal(size=(S, A.n_max, 2))
    x[:, 0, :] = value
    got = ek.ell_spmv_payload_reference(A.values, A.payload,
                                        torch.as_tensor(x)).numpy()
    want = np.asarray(jax_spmm_ell(jA, jnp.asarray(x)))
    assert np.isnan(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12,
                               atol=1e-12 * np.abs(want[fin]).max())
    full = ek.ell_spmv_reference(A.values, A.cols, torch.as_tensor(x))
    assert torch.equal(torch.isnan(full), torch.as_tensor(np.isnan(got)))


@pytest.mark.slow
def test_smoke_constant_is_the_jax_count_at_the_grid_cell():
    """chip_smoke.py phase 12 holds the port on the card to the JAX
    package's count at the banded grid cell (generate_uniform 512x512,
    S=64, overlap 1, Lanczos GenEO nu=10 at the default ncv, tol 1e-6).
    The JAX package's setup and solve at card size take about 80 s on one
    core: run it with ``-m slow`` after changing the constant."""
    gen = jax_d2.generate_uniform(64, 512, 512, overlap=1, with_neumann=True)
    opt = JaxOptions(schwarz_coarse_correction="deflated", geneo_nu=10,
                     local_solver="banded", tol=1e-6)
    sch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=opt)
    sch.set_grid_geometry(gen.boxes, 512, 512)       # as phase 12 does
    sch.solve_gevp(gen.neumann)
    f = sch.exchange_rhs(jnp.asarray(_f(gen, sch.n_max)))
    res = jax_solve(sch.build(), f, opt=opt)
    assert int(res.iterations) == root_chip_smoke().BANDED_GRID_ITS
