"""Port vs JAX package: the multilevel coarse chain and the multi-RHS grid
forms on the CPU in f64 (slice 3d).

The nine tests of ``tests/test_multilevel.py`` at their sizes, each with
the port's and the JAX package's solves side by side on the same GenEO
vectors (the port's, given to the JAX package through ``set_vectors``;
the two GenEO setups are held to each other in ``test_torch_schwarz.py``):

* the nested inner iterations of one coarse solve of a random right-hand
  side (``return_its``) are equal, for block-Jacobi, ``ras``, ``asm`` and
  ``none`` preconditioners, cg and gmres, level 3 direct / cg / none,
  aggregate sizes and ``level_3_geneo_nu``, on the dense (``iterative``)
  and block-sparse (``bsr``) paths, and the 4- and 5-level chains;
* the outer iterations are equal and x agrees to rtol 1e-10;
* each JAX test's own assertion holds for the port too.

Host eigenbases (``level_3_geneo_nu``) are compared as projectors: the two
packages assemble E with different reduction orders, so an eigenvector
may flip its sign. Also: ``_defl_jacobi_cg`` with a one-level chain
against the JAX function run op by op; the f32 ``level_2_tol`` clamp; the
RHS-leading grid forms (``spmm_dia_canvas_muT``, ``grid_exchange_muT``,
their ``_scan`` forms and ``gmv`` at mu = 3) value for value; the ladder
twin (``examples/ladder.py`` at generate_uniform(16, 128, 128)); and a
JAX-built nested state carried across by ``interop``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hpddm_tpu.core.scaling import jacobi_scale as jax_jacobi_scale
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.ops import spmv as jax_spmv
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.parallel import grid as jax_grid
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.examples import ladder
from hpddm_tpu_torch.examples.flagship import kappa
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.ops import spmv
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel import grid
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve
from hpddm_tpu_torch.solvers.refine import solve_refined
from test_torch_schwarz import jax_state_arrays


@pytest.fixture(autouse=True, scope="module")
def _xla_unoptimized():
    """The JAX package's solves compile their loops anew for every state
    (the arrays are constants of the loop); without XLA's optimization
    passes they compile in about three quarters of the time, with the same
    operations. Restored for the modules that follow."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


# the JAX package's solves with the state as an argument: its arrays are
# not compiled in as constants
_jax_coarse = jax.jit(functools.partial(jax_sz._coarse_solve,
                                        return_its=True))
_jax_coarse_bsr = jax.jit(functools.partial(jax_sz._coarse_solve_bsr,
                                            return_its=True))


class Pair:
    """The same problem in both packages: port and JAX Schwarz objects on
    the port's GenEO vectors (when ``nu``), and the right-hand side."""

    def __init__(self, S, N, nu=None, uniform=False, **base):
        gen_fn = "generate_uniform" if uniform else "generate"
        gen = getattr(diffusion2d, gen_fn)(S, N, N, overlap=1,
                                           with_neumann=True)
        jgen = getattr(jax_d2, gen_fn)(S, N, N, overlap=1, with_neumann=True)
        self.base = dict(schwarz_coarse_correction="deflated", **base)
        if nu:
            self.base["geneo_nu"] = nu
        self.sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                              options=Options(**self.base), device="cpu")
        self.jsch = jax_sz.Schwarz(jgen.mats, jgen.neighbors, jgen.mappings,
                                   d=jgen.d, options=JaxOptions(**self.base))
        if uniform:
            for s in (self.sch, self.jsch):
                s.set_grid_geometry(gen.boxes, N, N)
        if nu:
            self.sch.solve_gevp(gen.neumann)
            self.jsch.set_vectors(self.sch._deflation_vectors)
        f = np.zeros((S, self.sch.n_max, 1))
        for s in range(S):
            f[s, : gen.n_loc[s]] = gen.f[s]
        self.f = f
        self.S = S

    def use(self, **extra):
        """Set the base options + extra in both packages."""
        self.sch.opt = Options(**self.base, **extra)
        self.jsch.opt = JaxOptions(**self.base, **extra)

    def states(self, **extra):
        """(port state, JAX state) built with the base options + extra."""
        self.use(**extra)
        return self.sch.build(), self.jsch.build()

    def coarse_its(self, **extra):
        """Inner iterations of one coarse solve of a random right-hand side
        in both packages (equal), and the two states."""
        st, jst = self.states(**extra)
        co, jco = st.coarse, jst.coarse
        assert co.mode == jco.mode and co.method == jco.method
        assert co.prec == jco.prec and co.lvl3 == jco.lvl3
        rng = np.random.default_rng(3)
        if co.mode == "bsr":
            c = rng.normal(size=(self.S, co.nu_max, 1))
            y, its = sz._coarse_solve_bsr(co, torch.as_tensor(c),
                                          return_its=True)
            jy, jits = _jax_coarse_bsr(jco, jnp.asarray(c))
        else:
            c = rng.normal(size=(self.S * co.nu_max, 1))
            y, its = sz._coarse_solve(co, torch.as_tensor(c),
                                      return_its=True)
            jy, jits = _jax_coarse(jco, jnp.asarray(c))
        assert its == int(jits), (extra, its, int(jits))
        # the same iterations summed in another order: the difference
        # grows with E's conditioning and the count (2.6e-10 of max|y|
        # after 147 iterations at the S=256 case)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-8,
                                   atol=1e-8 * float(np.abs(jy).max()))
        return its, st, jst

    def outer(self, st, jst):
        """Outer solves in both packages: equal iterations, x to rtol
        1e-10; returns (iterations, recomputed relative residual)."""
        res = solve(st, torch.as_tensor(self.f), opt=self.sch.opt)
        opt = self.jsch.opt
        jres = jax.jit(lambda a, b: jax_solve(a, b, opt=opt))(
            jst, jnp.asarray(self.f))
        assert res.iterations == int(jres.iterations), \
            (res.iterations, int(jres.iterations))
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                                   rtol=1e-10, atol=1e-12)
        nb, nr = sz.compute_residual(st, res.x, torch.as_tensor(self.f))
        return res.iterations, float(nr[0] / nb[0])


@pytest.fixture(scope="module")
def dense16():
    return Pair(16, 64, nu=2)


@pytest.fixture(scope="module")
def bsr64():
    return Pair(64, 128, coarse_assembly="bsr")


def _projector(Z, E2_inv):
    Z = np.asarray(Z)
    return Z @ np.asarray(E2_inv) @ Z.T


# -- the nine tests of tests/test_multilevel.py ------------------------------

def test_level2_schwarz_method_dispatches(dense16):
    its_cg, _, _ = dense16.coarse_its(level_2_tol=1e-8)
    its_bj, st, _ = dense16.coarse_its(level_2_tol=1e-8,
                                       level_2_krylov_method="gmres")
    assert st.coarse.method == "gmres" and its_bj != its_cg
    its_ras, st, _ = dense16.coarse_its(level_2_tol=1e-8,
                                        level_2_krylov_method="gmres",
                                        level_2_schwarz_method="ras")
    assert st.coarse.prec == "ras" and its_ras < its_bj
    _, st, jst = dense16.coarse_its(level_2_tol=1e-8,
                                    level_2_schwarz_method="ras")
    assert st.coarse.method == "gmres"          # ras defaults to gmres
    its, rel = dense16.outer(st, jst)
    assert rel < 1e-2 and its <= 45


def test_three_level_beats_two_level_bsr(bsr64):
    its3, st3, jst3 = bsr64.coarse_its(level_2_tol=1e-8)
    assert st3.coarse.lvl3 == "direct"
    its2, st2, _ = bsr64.coarse_its(level_2_tol=1e-8,
                                    level_3_krylov_method="none")
    assert st2.coarse.lvl3 == "none" and its3 < its2
    bsr64.use(level_2_tol=1e-8)
    _, rel = bsr64.outer(st3, jst3)
    assert rel < 1e-2


def test_level3_nested_cg_and_aggregates():
    pair = Pair(16, 64, coarse_assembly="bsr")
    _, st, jst = pair.coarse_its(level_2_tol=1e-8, level_3_krylov_method="cg",
                                 level_3_tol=1e-6, level_3_aggregate_size=4)
    co = st.coarse
    assert co.lvl3 == "cg" and tuple(co.E2.shape) == (4, 4)
    np.testing.assert_allclose(co.E2.numpy(), np.asarray(jst.coarse.E2),
                               rtol=1e-12)
    its, rel = pair.outer(st, jst)
    assert rel < 1e-2 and its <= 45


def test_level2_ras_dense_mode():
    pair = Pair(9, 48, nu=2)
    kw = dict(level_2_tol=1e-8, level_2_krylov_method="gmres")
    its_bj, _, _ = pair.coarse_its(**kw)
    for method in ("ras", "asm"):
        its, st, jst = pair.coarse_its(level_2_schwarz_method=method, **kw)
        assert its < its_bj, (method, its, its_bj)
        _, rel = pair.outer(st, jst)
        assert rel < 1e-2, method


def test_dense_coarse_auto_switches_to_bsr(monkeypatch, capsys):
    monkeypatch.setattr(sz, "_DENSE_COARSE_BYTES_CAP", 1)
    monkeypatch.setattr(jax_sz, "_DENSE_COARSE_BYTES_CAP", 1)
    pair = Pair(4, 40, nu=2)
    st, jst = pair.states()
    assert st.coarse.mode == jst.coarse.mode == "direct"
    assert pair.outer(st, jst)[1] < 1e-2
    _, st, jst = pair.coarse_its(level_2_tol=1e-8)
    assert st.coarse.mode == "bsr"
    assert pair.outer(st, jst)[1] < 1e-2
    capsys.readouterr()
    st, _ = pair.states(coarse_assembly="dense")
    assert st.coarse.mode == "direct"
    out = capsys.readouterr().out
    assert out.count("WARNING -- coarse_assembly=dense") == 2   # both


@pytest.mark.slow
def test_level3_spectral_beats_constants_at_scale():
    """S = 256 at 256^2: constant and spectral level-3 bases of the same
    size (16); the JAX package runs op by op."""
    pair = Pair(256, 256, nu=2, uniform=True, coarse_assembly="bsr")
    kw = dict(level_2_tol=1e-8, level_2_max_it=500,
              level_3_aggregate_size=16)
    with jax.disable_jit():
        its_const, st_c, _ = pair.coarse_its(**kw)
        its_spec, st_s, jst_s = pair.coarse_its(level_3_geneo_nu=1, **kw)
    assert st_c.coarse.agg_oh.shape[-1] == st_s.coarse.agg_oh.shape[-1] == 16
    assert its_spec < its_const, (its_spec, its_const)
    S, nu = pair.S, st_s.coarse.nu_max
    np.testing.assert_allclose(
        _projector(st_s.coarse.agg_oh.reshape(S * nu, -1),
                   st_s.coarse.E2_inv),
        _projector(np.asarray(jst_s.coarse.agg_oh).reshape(S * nu, -1),
                   jst_s.coarse.E2_inv), rtol=1e-8, atol=1e-10)


def test_level3_spectral_dense_path(dense16):
    kw = dict(level_2_tol=1e-8, level_2_max_it=500, level_3_aggregate_size=4)
    its_c, st_c, _ = dense16.coarse_its(**kw)
    assert st_c.coarse.Z2.shape[1] == 4
    its_s, st_s, jst_s = dense16.coarse_its(level_3_geneo_nu=2, **kw)
    assert st_s.coarse.Z2.shape[1] == 8 and its_s <= its_c
    np.testing.assert_allclose(
        _projector(st_s.coarse.Z2, st_s.coarse.E2_inv),
        _projector(jst_s.coarse.Z2, jst_s.coarse.E2_inv),
        rtol=1e-8, atol=1e-10)


def test_four_level_chain():
    pair = Pair(32, 96, nu=2, coarse_assembly="bsr")
    kw = dict(level_2_tol=1e-8, level_3_krylov_method="cg", level_3_tol=1e-8,
              level_3_aggregate_size=1, level_3_max_it=6)
    its3, st3, _ = pair.coarse_its(**kw)
    assert len(st3.coarse.chain_modes) == 0
    its4, st4, jst4 = pair.coarse_its(level_4_aggregate_size=8, **kw)
    co = st4.coarse
    assert co.chain_modes == ("direct",)
    assert tuple(co.chain_E[0].shape) == (4, 4) and its4 <= its3
    its, rel = pair.outer(st4, jst4)
    assert rel < 1e-2 and its <= 45
    _, st5, jst5 = pair.coarse_its(
        level_4_aggregate_size=8, level_4_krylov_method="cg", level_4_tol=1e-8,
        level_5_aggregate_size=2, **kw)
    co5 = st5.coarse
    assert co5.chain_modes == ("cg", "direct")
    assert tuple(co5.chain_E[1].shape) == (2, 2)
    for a, b in zip(co5.chain_E, jst5.coarse.chain_E):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    assert pair.outer(st5, jst5)[1] < 1e-2


def test_nonuniform_nu_masks_inactive_slots():
    """Subdomains with fewer deflation vectors than nu_max leave inactive
    coarse slots: the nested solves of both paths mask them as the JAX
    package does (the same inner and outer counts and solutions)."""
    pair = Pair(16, 64, nu=2)
    vecs = [v if s % 3 else v[:, :1]
            for s, v in enumerate(pair.sch._deflation_vectors)]
    pair.sch.set_vectors(vecs)
    pair.jsch.set_vectors(vecs)
    for extra in (dict(coarse_assembly="bsr", level_3_aggregate_size=4),
                  dict(level_2_schwarz_method="asm")):
        _, st, jst = pair.coarse_its(level_2_tol=1e-8, **extra)
        assert int(st.coarse.nu_loc.min()) == 1
        assert pair.outer(st, jst)[1] < 1e-2


def test_at_scale_winning_config_quality():
    pair = Pair(64, 128, nu=4, coarse_assembly="bsr", tol=1e-6)
    its = {}
    for name, extra in [
            ("L2", {}),
            ("L4", dict(level_2_krylov_method="cg", level_2_tol=1e-2,
                        level_2_max_it=50, level_3_krylov_method="cg",
                        level_3_aggregate_size=4, level_3_geneo_nu=2,
                        level_3_tol=1e-2, level_3_max_it=20,
                        level_4_aggregate_size=4))]:
        st, jst = pair.states(**extra)
        its[name], rel = pair.outer(st, jst)
        assert rel < 1e-4, name
    assert its["L4"] <= its["L2"] + 4, its


# -- the recursion unit, the f32 clamp, interop -----------------------------

def test_defl_jacobi_cg_one_level_chain_equals_jax():
    """A Jacobi CG deflated by a direct next level, against the JAX
    function run op by op (its while_loop as a Python loop)."""
    rng = np.random.default_rng(8)
    n, m = 40, 10
    B = rng.normal(size=(n, n))
    E = B @ B.T + n * np.eye(n)
    Jinv = np.diag(1.0 / np.diag(E))
    Zn = np.zeros((n, m))
    Zn[np.arange(n), np.arange(n) // 4] = 1.0
    En_inv = np.linalg.inv(Zn.T @ E @ Zn)
    rc = rng.normal(size=(n, 3))
    t = [torch.as_tensor(a) for a in (E, Jinv, rc, Zn, En_inv)]
    w = sz._defl_jacobi_cg(t[0], t[1], t[2], 1e-10, 30,
                           (t[3], lambda r: t[4] @ r))
    with jax.disable_jit():
        jw = jax_sz._defl_jacobi_cg(
            jnp.asarray(E), jnp.asarray(Jinv), jnp.asarray(rc), 1e-10, 30,
            (jnp.asarray(Zn), lambda r: jnp.asarray(En_inv) @ r))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-12,
                               atol=1e-12 * float(np.abs(jw).max()))
    assert np.linalg.norm(E @ w.numpy() - rc) <= 1e-9 * np.linalg.norm(rc)


def test_f32_nested_coarse_tol_clamped(capsys):
    """``tests/test_coarse_bsr.py:195``: below the f32 nested-coarse floor
    level_2_tol is clamped to 1e-5 with a warning; f64 keeps it."""
    def build(npdt):
        gen = diffusion2d.generate_uniform(4, 48, 48, overlap=1,
                                           with_neumann=True, dtype=npdt)
        sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=Options(schwarz_coarse_correction="deflated",
                                         geneo_nu=2, coarse_assembly="bsr",
                                         level_2_tol=1e-8), device="cpu")
        sch.solve_gevp(gen.neumann)
        return sch.build()
    assert build(np.float64).coarse.inner_tol == 1e-8
    assert "clamped" not in capsys.readouterr().out
    assert build(np.float32).coarse.inner_tol == 1e-5
    assert "WARNING -- level_2_tol 1e-08 clamped to 1e-5" in \
        capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    dict(level_2_tol=1e-6, level_2_schwarz_method="asm",
         level_3_krylov_method="cg", level_3_aggregate_size=4,
         level_4_aggregate_size=2),
    dict(coarse_assembly="bsr", level_2_tol=1e-6,
         level_2_schwarz_method="ras", level_3_krylov_method="cg",
         level_3_geneo_nu=1, level_3_aggregate_size=4,
         level_4_krylov_method="cg", level_5_aggregate_size=2)],
    ids=["iterative", "bsr"])
def test_jax_built_nested_state_through_interop(dense16, extra):
    """A JAX-built nested state (every level) carried into the port gives
    the JAX package's ``apply``."""
    _, jst = dense16.states(**extra)
    st = interop.state_from_numpy(jax_state_arrays(jst), device="cpu")
    assert st.coarse.mode == jst.coarse.mode
    assert st.coarse.chain_modes == jst.coarse.chain_modes
    x = np.random.default_rng(12).normal(size=dense16.f.shape)
    np.testing.assert_allclose(
        sz.apply(st, torch.as_tensor(x)).numpy(),
        np.asarray(jax_sz.apply(jst, jnp.asarray(x))), rtol=1e-10,
        atol=1e-12)


# -- the multi-RHS grid forms -------------------------------------------------

@pytest.fixture(scope="module")
def canvas16():
    """A 16-subdomain uniform grid with the slab plan and the canvas in
    both packages, and a random (S, mu=3, n) panel."""
    pair = Pair(16, 64, uniform=True)
    assert pair.sch.A.canvas_hw is not None and pair.sch.dec.grid is not None
    xT = np.random.default_rng(40).normal(size=(16, 3, pair.sch.n_max))
    return pair.sch, pair.jsch, xT


def test_spmm_canvas_muT_forms_equal_jax(canvas16):
    sch, jsch, xT = canvas16
    want = np.asarray(jax_spmv.spmm_dia_canvas_muT(jsch.A, jnp.asarray(xT)))
    x = torch.as_tensor(xT)
    np.testing.assert_array_equal(spmv.spmm_dia_canvas_muT(sch.A, x).numpy(),
                                  want)
    np.testing.assert_array_equal(spmv.spmm_muT(sch.A, x).numpy(), want)
    d, jd = sch.dec.d, jsch.dec.d
    for mu in (3, 4):
        xm = np.concatenate([xT, xT[:, :1]], axis=1)[:, :mu]
        np.testing.assert_array_equal(
            spmv.spmm_dia_canvas_muT_scan(sch.A, torch.as_tensor(xm),
                                          scale=d).numpy(),
            np.asarray(jax_spmv.spmm_dia_canvas_muT_scan(
                jsch.A, jnp.asarray(xm), pair=2, scale=jd)))


def test_grid_exchange_muT_forms_equal_jax(canvas16):
    sch, jsch, xT = canvas16
    want = np.asarray(jax_grid.grid_exchange_muT(jsch.dec.grid,
                                                 jnp.asarray(xT)))
    x = torch.as_tensor(xT)
    np.testing.assert_array_equal(
        grid.grid_exchange_muT(sch.dec.grid, x).numpy(), want)
    scan = grid.grid_exchange_muT_scan(sch.dec.grid, x).numpy()
    np.testing.assert_array_equal(scan, want)
    # the JAX package's scan form compiles its single-RHS exchange, and
    # XLA rounds it otherwise than the same operations op by op (8.9e-16
    # apart here); the port's exchange is the op-by-op one, bitwise
    np.testing.assert_allclose(
        scan, np.asarray(jax_grid.grid_exchange_muT_scan(jsch.dec.grid,
                                                         jnp.asarray(xT))),
        rtol=0.0, atol=1e-13)


def test_gmv_muT_branch_equals_jax(canvas16, monkeypatch):
    """gmv at mu = 3 on the canvas grid state takes the RHS-leading branch
    (B3's layout) and gives the JAX package's values and the trailing-mu
    path's."""
    sch, jsch, xT = canvas16
    x = np.ascontiguousarray(np.moveaxis(xT, 1, 2))
    calls = []
    monkeypatch.setattr(sz, "spmm_muT", lambda A, v: calls.append(1) or
                        spmv.spmm_muT(A, v))
    got = sz.gmv(sch.operator_state(), torch.as_tensor(x))
    assert calls == [1]
    want = np.asarray(jax_sz.gmv(jsch.operator_state(), jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    st = sch.operator_state()
    trailing = sz.scaled_exchange(st.dec, spmv.spmm(st.A, torch.as_tensor(x)))
    assert torch.equal(got, trailing)


# -- the ladder twin ----------------------------------------------------------

def test_ladder_twin_counts_equal_jax_and_refine():
    """examples/ladder.py at generate_uniform(16, 128, 128): the ladder
    options (banded, Lanczos GenEO nu=8, bsr, level-2 CG, direct level 3,
    flexible GMRES restart 40) in f64 at the bench's tol 2e-3 take the JAX
    package's outer count on the same vectors, and the host refinement
    reaches a true relative residual <= 1e-10."""
    prob = ladder.problem(16, 128)
    gen = prob["gen"]
    jgen = jax_d2.generate_uniform(16, 128, 128, overlap=1, kappa=kappa,
                                   with_neumann=True)
    jmats, _, _, _ = jax_jacobi_scale(jgen.mats, jgen.f, jgen.neumann)
    opt = ladder.options(2e-3)
    sch = sz.Schwarz(prob["mats"], gen.neighbors, gen.mappings, d=gen.d,
                     options=opt, device="cpu")
    sch.set_grid_geometry(gen.boxes, 128, 128)
    sch.solve_gevp(prob["neumann"], method="lanczos")
    st = sch.build()
    assert st.coarse.mode == "bsr" and st.coarse.lvl3 == "direct"
    jopt = JaxOptions(**{k: v for k, v in opt.items()})
    jsch = jax_sz.Schwarz(jmats, jgen.neighbors, jgen.mappings, d=jgen.d,
                          options=jopt)
    jsch.set_grid_geometry(jgen.boxes, 128, 128)
    jsch.set_vectors(sch._deflation_vectors)
    jst = jsch.build()
    f = np.zeros((16, sch.n_max, 1))
    for s in range(16):
        f[s, : gen.n_loc[s]] = prob["f"][s]
    res = solve(st, torch.as_tensor(f), opt=opt)
    jres = jax_solve(jst, jnp.asarray(f), opt=jopt)
    assert res.iterations == int(jres.iterations)
    _, info = solve_refined(lambda b: solve(st, b, opt=opt), prob["mats"],
                            torch.as_tensor(f), st.dec, tol=1e-10,
                            max_refine=8)
    assert info["history"][-1] <= 1e-10, info["history"]
