"""Port vs JAX package: the elasticity models and the elasticity flagship on
the CPU in f64 (slice 5b).

* ``elasticity2d.generate`` (penalty clamp and elimination, k-way and box
  partitions) and ``elasticity3d.generate`` are byte-equal to the JAX
  package's: matrices, neighbours, mappings, partition of unity,
  right-hand sides, Neumann matrices and rigid-body modes.
* The H8 element annihilates the six rigid-body modes, and so do the
  Neumann matrices of the subdomains away from the clamped face
  (``tests/test_elasticity3d.py``); gmv on the k-way decomposition equals
  the assembled operator.
* Iteration counts equal the JAX package's: 2D two-level block GMRES (nu 0
  and 10, ``tests/test_models.py``), 3D two-level GMRES
  (``tests/test_elasticity3d.py``), banded dense-coupling solves against
  ``inv`` on node slabs (``tests/test_banded.py``) and the flagship twin
  (``examples/bench_elasticity.py`` at S=8, 64x64 nodes: f64 end to end
  with classical and modified Gram-Schmidt, f32 on the JAX package's f32
  GenEO vectors).

The penalty-clamped node-slab blocks reach cond ~1e10 without scaling, and
there classical Gram-Schmidt loses orthogonality after some 30 steps: the
JAX package jitted takes 62 (inv) and 61 (banded) iterations where the same
operations op by op take 35, the port's count (ROADMAP queue C, C8). That
test runs the JAX package's solves op by op (``jax.disable_jit``); the
others are jitted, where both forms agree.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp
from hpddm_tpu.core.scaling import jacobi_scale as jax_jacobi_scale
from hpddm_tpu.models import elasticity2d as jax_e2
from hpddm_tpu.models import elasticity3d as jax_e3
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch.examples import bench_elasticity as bench
from hpddm_tpu_torch.examples import elasticity as elasticity_example
from hpddm_tpu_torch.models import elasticity2d, elasticity3d
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.precond.geneo import scale_into_overlap
from hpddm_tpu_torch.solvers.krylov import solve


def _slabs(S, Nx):
    return lambda ix, iy: min(ix * S // Nx, S - 1)


GENERATORS = {
    "2d penalty": lambda m: m.generate(4, 20, 20, contrast=1e3, overlap=2),
    "2d eliminated": lambda m: m.generate(4, 16, 12, contrast=1e2, overlap=1,
                                          pen_scale=None),
    "2d boxes": lambda m: m.generate(8, 24, 24, overlap=2,
                                     owner_fn=bench.box_owner(8, 24)),
    "3d": lambda m: m.generate(4, 7, 7, 7, overlap=2),
    "3d slabs": lambda m: m.generate(4, 7, 6, 5, overlap=1,
                                     owner_fn=lambda ix: ix * 4 // 7),
}


def _csr_bytes(m):
    c = m.scipy(expand=False)
    return tuple(np.ascontiguousarray(getattr(c, k)).tobytes()
                 for k in ("data", "indices", "indptr")) + (c.shape,)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b)


@pytest.mark.parametrize("case", list(GENERATORS))
def test_generate_is_byte_equal(case):
    dims = 3 if case.startswith("3d") else 2
    mods = (jax_e3, elasticity3d) if dims == 3 else (jax_e2, elasticity2d)
    (jg, jn, jr), (g, n, r) = (GENERATORS[case](m) for m in mods)
    assert [_csr_bytes(m) for m in g.mats] == \
        [_csr_bytes(m) for m in jg.mats]
    assert [_csr_bytes(m) for m in n] == [_csr_bytes(m) for m in jn]
    assert g.neighbors == jg.neighbors and g.n_loc == jg.n_loc
    for a, b in zip(g.mappings, jg.mappings):
        assert len(a) == len(b) and all(map(_same, a, b))
    for key in ("d", "f", "gids"):
        assert all(map(_same, getattr(g, key), getattr(jg, key))), key
    assert all(map(_same, r, jr))
    assert _same(g.owner, jg.owner)
    for k in ("data", "indices", "indptr"):
        assert _same(getattr(g.A_global, k), getattr(jg.A_global, k))
    assert r[0].shape[1] == (6 if dims == 3 else 3)


def test_h8_rigid_body_nullspace():
    """The H8 element stiffness annihilates the six rigid-body modes and
    has exactly six zero eigenvalues (``tests/test_elasticity3d.py:14``)."""
    h = 0.25
    Ke = elasticity3d.h8_stiffness(3.7, 0.3, h)
    np.testing.assert_array_equal(Ke, jax_e3.h8_stiffness(3.7, 0.3, h))
    corners = np.array([[i, j, k] for k in (0, 1) for j in (0, 1)
                        for i in (0, 1)], dtype=np.float64) * h
    R = np.zeros((24, 6))
    for a, (x, y, z) in enumerate(corners):
        R[3 * a + 0, 0] = R[3 * a + 1, 1] = R[3 * a + 2, 2] = 1.0
        R[3 * a + 0, 3], R[3 * a + 1, 3] = -y, x
        R[3 * a + 1, 4], R[3 * a + 2, 4] = -z, y
        R[3 * a + 0, 5], R[3 * a + 2, 5] = z, -x
    assert np.abs(Ke @ R).max() < 1e-10 * np.abs(Ke).max()
    np.testing.assert_allclose(Ke, Ke.T, atol=1e-12)
    w = np.linalg.eigvalsh(Ke)
    assert np.all(w > -1e-10) and (np.abs(w) < 1e-8).sum() == 6
    np.testing.assert_array_equal(elasticity2d.q1_stiffness(2.0, 0.3, 0.1),
                                  jax_e2.q1_stiffness(2.0, 0.3, 0.1))


def test_subdomain_rbm_nullspace():
    """The unclamped x-slabs' Neumann matrices annihilate their six
    rigid-body modes (``tests/test_elasticity3d.py:54``)."""
    S, Nx = 4, 7
    _, neumann, rbm = elasticity3d.generate(
        S, Nx=Nx, Ny=Nx, Nz=Nx, overlap=1, owner_fn=lambda x: x * S // Nx)
    checked = 0
    for s in range(S):
        Ns = neumann[s].scipy(expand=True)
        scale = np.abs(Ns).max()
        if scale > 1e7:                 # the slab at the clamped face
            continue
        assert np.abs(Ns @ rbm[s]).max() < 1e-8 * scale
        checked += 1
    assert checked >= 2


def test_gmv_exactness_3d():
    """gmv on the k-way decomposition of the 7^3 H8 operator (ELL, the
    exchange plan) equals the assembled product
    (``tests/test_elasticity3d.py:34``)."""
    S = 4
    gen, _, _ = elasticity3d.generate(S, Nx=7, Ny=7, Nz=7, overlap=2)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     device="cpu")
    assert sch.A.__class__.__name__ == "BatchedELL"
    g = np.random.default_rng(0).normal(size=gen.A_global.shape[0])
    x = np.zeros((S, sch.n_max, 1))
    for s in range(S):
        x[s, : gen.n_loc[s], 0] = g[gen.gids[s]]
    y = sz.gmv(sch.operator_state(), torch.as_tensor(x)).numpy()
    ref = gen.A_global @ g
    for s in range(S):
        np.testing.assert_allclose(y[s, : gen.n_loc[s], 0], ref[gen.gids[s]],
                                   atol=1e-8 * np.abs(ref).max())


def _rhs(gen, n_max, mu=1):
    S = len(gen.mats)
    rng = np.random.default_rng(1)
    f = np.zeros((S, n_max, mu))
    for s in range(S):
        f[s, : gen.n_loc[s], 0] = gen.f[s][:, 0]
        for j in range(1, mu):
            f[s, : gen.n_loc[s], j] = rng.normal(size=gen.n_loc[s])
    return f


def _counts(jgen, gen, kw, jneu=None, neu=None, mu=1, shapes=None,
            op_by_op=False, check=None, method="auto",
            pkgs=("jax", "port")):
    """(JAX count, port count) of one solve on each package's own setup
    (GenEO by ``method`` when nu is asked for), recomputed residuals
    < 1e-2; the counts of ``pkgs`` only, when given."""
    out = []
    for pkg in pkgs:
        g = jgen if pkg == "jax" else gen
        if pkg == "jax":
            sch = jax_sz.Schwarz(g.mats, g.neighbors, g.mappings, d=g.d,
                                 options=JaxOptions(**kw))
        else:
            sch = sz.Schwarz(g.mats, g.neighbors, g.mappings, d=g.d,
                             options=Options(**kw), device="cpu")
        if shapes is not None:
            sch.set_banded_shapes(shapes)
        f = _rhs(g, sch.n_max, mu)
        f = sch.exchange_rhs(jnp.asarray(f) if pkg == "jax"
                             else torch.as_tensor(f))
        if kw.get("geneo_nu"):
            sch.solve_gevp(jneu if pkg == "jax" else neu, method=method)
        state = sch.build()
        if check is not None:
            check(state)
        if pkg == "jax":
            if op_by_op:
                with jax.disable_jit():
                    res = jax_solve(state, f, opt=sch.opt)
            else:
                res = jax_solve(state, f, opt=sch.opt)
            nb, nr = jax_sz.compute_residual(state, res.x, f)
        else:
            res = solve(state, f, opt=sch.opt)
            nb, nr = sz.compute_residual(state, res.x, f)
        assert np.all(np.asarray(nr) / np.asarray(nb) < 1e-2), pkg
        out.append(int(res.iterations))
    return tuple(out)


@pytest.fixture(scope="module")
def e2_gens():
    return [m.generate(4, Nx=20, Ny=20, contrast=1e3, overlap=2)
            for m in (jax_e2, elasticity2d)]


@pytest.mark.parametrize("nu", [0, 10])
def test_elasticity2d_two_level_bgmres_counts_equal_jax(e2_gens, nu):
    """Two right-hand sides through block GMRES (``tests/test_models.py:98``):
    the JAX package's counts (14 one-level, 7 with GenEO nu=10)."""
    (jg, jn, _), (g, n, _) = e2_gens
    kw = dict(tol=1e-6, max_it=300, gmres_restart=150, krylov_method="bgmres")
    if nu:
        kw.update(schwarz_coarse_correction="deflated", geneo_nu=nu)
    want, got = _counts(jg, g, kw, jn, n, mu=2)
    assert got == want, (got, want)
    assert got == (7 if nu else 14)


def test_elasticity3d_two_level_counts_equal_jax():
    """``tests/test_elasticity3d.py:79``: one-level and GenEO nu=10 counts
    equal the JAX package's, and GenEO cuts them."""
    gens = [m.generate(4, Nx=8, Ny=8, Nz=8, contrast=1e3, overlap=2)
            for m in (jax_e3, elasticity3d)]
    (jg, jn, _), (g, n, _) = gens
    its = {}
    for nu in (0, 10):
        kw = dict(tol=1e-6, max_it=300, gmres_restart=150)
        if nu:
            kw.update(schwarz_coarse_correction="deflated", geneo_nu=nu)
        want, its[nu] = _counts(jg, g, kw, jn, n)
        assert its[nu] == want, (nu, its[nu], want)
    assert its[10] < its[0], its


def test_lanczos_shift_leaves_out_penalty_rows():
    """Lanczos GenEO with the ``inv`` inner solve on unscaled 3D
    elasticity (10^3 nodes, S=8, contrast 1e3; ROADMAP C10). The JAX
    package's shift of the Neumann solves is 1e-8 times the mean
    |diagonal| with the clamped face's penalty rows averaged in: 14.9
    here, where the other rows' mean gives 6.8e-7. So shifted, the pencil
    A_neu + shift I = lambda B of each floating subdomain loses its six
    rigid-body modes (its smallest eigenvalue 0.50-1.49, where the port's
    shift leaves six below 1e-6), and Lanczos's vectors take one level's
    21 iterations (28 against 26 at 24^3: ``E3_ITS``). The port leaves
    penalty rows out of the mean: its Lanczos vectors come within 3 of
    the dense pencil's count (12 against 11), and one level still takes
    the JAX package's count."""
    gens = [m.generate(8, Nx=10, Ny=10, Nz=10, contrast=1e3, overlap=2)
            for m in (jax_e3, elasticity3d)]
    (jg, _, _), (g, n, _) = gens
    eps = sz.neumann_regularization(n)
    jax_eps = 1e-8 * np.mean([np.abs(m.scipy().diagonal()).mean()
                              for m in n])
    assert eps < 1e-6 < jax_eps, (eps, jax_eps)
    sch = sz.Schwarz(g.mats, g.neighbors, g.mappings, d=g.d,
                     options=Options(), device="cpu")
    floating = 0
    for s in range(8):
        diag = np.abs(n[s].scipy().diagonal())
        if diag.max() > sz.PENALTY_RATIO * np.median(diag):
            continue                    # clamped: no rigid-body mode
        floating += 1
        ns = g.n_loc[s]
        A = n[s].scipy(expand=True).toarray()
        B = scale_into_overlap(sch.A, sch.dec, slice(s, s + 1))[0, :ns, :ns]
        lam = {}
        for name, shift in (("port", eps), ("jax", jax_eps)):
            mu = scipy.linalg.eigh(B.numpy(), A + shift * np.eye(ns),
                                   eigvals_only=True)
            lam[name] = np.sort(1.0 / mu[mu > 0])
        assert lam["port"][5] < 1e-6 < 1e-2 < lam["port"][6], (s, lam)
        assert lam["jax"][0] > 0.1, (s, lam["jax"][:6])
    assert floating == 4
    kw = dict(tol=1e-6, max_it=300, gmres_restart=150)
    want, one = _counts(jg, g, kw)
    assert one == want == 21, (one, want)
    kw.update(schwarz_coarse_correction="deflated", geneo_nu=10)
    (dense,) = _counts(None, g, kw, None, n, method="dense", pkgs=("port",))
    (lanczos,) = _counts(None, g, kw, None, n, method="lanczos",
                         pkgs=("port",))
    assert lanczos <= dense + 3 and lanczos < one - 4, (lanczos, dense, one)


def test_banded_dense_coupling_counts_equal_jax():
    """Node-slab subdomains of 2D elasticity: the Q1 node blocks couple the
    rows densely; the banded solve takes the JAX package's count per
    local solver, op by op (C8), and stays within 5 of ``inv``
    (``tests/test_banded.py:181``)."""
    S, Nx = 4, 24
    gens = [m.generate(S, Nx=Nx, Ny=Nx, contrast=1e2, overlap=1,
                       owner_fn=_slabs(S, Nx)) for m in (jax_e2, elasticity2d)]
    (jg, _, _), (g, _, _) = gens
    shapes = bench.banded_shapes(g, Nx)
    its = {}
    for kind in ("inv", "banded"):
        kw = dict(tol=1e-8, max_it=400, gmres_restart=200, local_solver=kind)

        def dense(state):
            if kind == "banded":
                assert state.solver.cl.ndim == 4
        want, its[kind] = _counts(jg, g, kw, shapes=shapes if kind ==
                                  "banded" else None, op_by_op=True,
                                  check=dense)
        assert its[kind] == want, (kind, its[kind], want)
    assert abs(its["banded"] - its["inv"]) <= 5, its


TWIN_S, TWIN_NN = 8, 64


@pytest.fixture(scope="module")
def twin():
    """The flagship twin (S=8, 64x64 nodes) on both packages: the port's
    problem, and the JAX package's scaled problem as its bench builds it."""
    prob = bench.problem(TWIN_S, TWIN_NN)
    gen, neumann, _ = jax_e2.generate(
        TWIN_S, Nx=TWIN_NN, Ny=TWIN_NN, contrast=1e3, overlap=2,
        owner_fn=bench.box_owner(TWIN_S, TWIN_NN))
    return prob, (gen, jax_jacobi_scale(gen.mats, gen.f, neumann))


def _jax_twin(twin, dtype):
    """({orthogonalization: JAX count}, its Schwarz object) at the bench's
    options in dtype; f64 also with modified Gram-Schmidt."""
    prob, (gen, (mats, f_list, neu, _)) = twin
    if dtype == np.float32:
        mats = [m.__class__(m.scipy().astype(dtype)) for m in mats]
        neu = [m.__class__(m.scipy().astype(dtype)) for m in neu]
    f32 = dtype == np.float32
    opt = JaxOptions(tol=1e-2 if f32 else 1e-8, max_it=300, gmres_restart=60,
                     orthogonalization="mgs" if f32 else "cgs",
                     local_solver="banded",
                     schwarz_coarse_correction="deflated",
                     geneo_nu=bench.ELAST_NU)
    sch = jax_sz.Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=opt)
    sch.set_banded_shapes(prob["shapes"])
    sch.solve_gevp(neu, method="lanczos")
    f = np.zeros((TWIN_S, sch.n_max, 1), dtype=dtype)
    for s in range(TWIN_S):
        f[s, : gen.n_loc[s], 0] = f_list[s][:, 0]
    f = sch.exchange_rhs(jnp.asarray(f))
    state = sch.build()
    counts = {}
    for ortho in ("mgs",) if f32 else ("cgs", "mgs"):
        o = opt.copy()
        o["orthogonalization"] = ortho
        res = jax.jit(lambda st, b: jax_solve(st, b, opt=o))(state, f)
        counts[ortho] = int(res.iterations)
    return counts, sch


def test_flagship_twin_f64_counts_equal_jax(twin):
    prob = twin[0]
    want, _ = _jax_twin(twin, np.float64)
    r, sch, state, f = bench.run(prob, np.float64, device="cpu")
    its_mgs, _ = bench.mgs_solve(state, f, sch.opt)
    assert (r["iterations"], its_mgs) == (want["cgs"], want["mgs"]), \
        (r, its_mgs, want)
    assert r["dense_coupling"] and r["relres"] <= 1e-8
    assert r["true_relres"] <= 1e-6
    assert state.bc is None or state.bc.shape[0] == TWIN_S


def test_flagship_twin_f32_counts_on_jax_vectors(twin):
    """f32 (tol 1e-2, mgs): the port on the JAX package's f32 Lanczos
    vectors takes its count; the host refinement reaches 1e-8."""
    want, jsch = _jax_twin(twin, np.float32)
    want = want["mgs"]
    vectors = [np.asarray(v) for v in jsch._deflation_vectors]
    r, _, _, _ = bench.run(twin[0], np.float32, device="cpu",
                           vectors=vectors)
    assert r["iterations"] == want, (r["iterations"], want)
    assert r["history"][-1] <= 1e-8


def _jax_flagship_counts():
    """The JAX package's flagship counts (``ELAST_ITS``), jitted as
    ``tools/bench_elasticity.py`` runs it, with modified and classical
    Gram-Schmidt."""
    S, Nn = bench.ELAST_S, bench.ELAST_NN
    gen, neumann, _ = jax_e2.generate(S, Nx=Nn, Ny=Nn,
                                      contrast=bench.ELAST_CONTRAST,
                                      overlap=2, owner_fn=bench.box_owner(
                                          S, Nn))
    mats, f_list, neu, _ = jax_jacobi_scale(gen.mats, gen.f, neumann)
    opt = JaxOptions(tol=1e-8, max_it=300, gmres_restart=60,
                     orthogonalization="cgs", local_solver="banded",
                     schwarz_coarse_correction="deflated",
                     geneo_nu=bench.ELAST_NU)
    sch = jax_sz.Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=opt)
    sch.set_banded_shapes(bench.banded_shapes(gen, Nn))
    sch.solve_gevp(neu, method="lanczos")
    f = np.zeros((S, sch.n_max, 1))
    for s in range(S):
        f[s, : gen.n_loc[s], 0] = f_list[s][:, 0]
    f = sch.exchange_rhs(jnp.asarray(f))
    state = sch.build()
    got = {}
    for ortho in ("mgs", "cgs"):
        o = opt.copy()
        o["orthogonalization"] = ortho
        res = jax.jit(lambda st, b: jax_solve(st, b, opt=o))(state, f)
        got[ortho] = int(res.iterations)
    return got


@pytest.mark.slow
@pytest.mark.parametrize("cell", ["flagship", "3d 24^3"])
def test_elast_its_are_the_jax_counts(cell):
    """The CPU counts that the card is held to. ``ELAST_ITS``, the JAX
    package's at the full elasticity flagship (S=8, 512x512 nodes, nu=16,
    contrast 1e3, f64, tol 1e-8): modified Gram-Schmidt, which smoke
    phase 17 holds the card to within 2, and the bench's classical
    Gram-Schmidt, whose count rounding moves within the recorded range
    (C9); about 15 minutes on one core, most of it the host Lanczos GenEO
    and the host banded factors. ``E3_ITS``, at smoke phase 19's 3D
    elasticity cell: the JAX package's one-level count, the port's
    Lanczos GenEO nu=10 count, which the phase holds the card to within 2,
    and the JAX package's with its shift of the Neumann solves (C10);
    about 6 minutes."""
    if cell == "flagship":
        got = _jax_flagship_counts()
        lo, hi = bench.ELAST_ITS["cgs"]
        assert got["mgs"] == bench.ELAST_ITS["mgs"] and \
            lo <= got["cgs"] <= hi, got
        return
    jg, jn, _ = jax_e3.generate(8, Nx=24, Ny=24, Nz=24, contrast=1e3,
                                overlap=2)
    g, n, _ = elasticity3d.generate(8, Nx=24, Ny=24, Nz=24, contrast=1e3,
                                    overlap=2)
    kw = dict(tol=1e-6, max_it=300, gmres_restart=150)
    got = {"one level": _counts(jg, None, kw, pkgs=("jax",))[0]}
    kw.update(schwarz_coarse_correction="deflated", geneo_nu=10)
    got["lanczos, JAX shift"], got["lanczos"] = _counts(
        jg, g, kw, jn, n, method="lanczos")
    assert got == elasticity_example.E3_ITS, got
