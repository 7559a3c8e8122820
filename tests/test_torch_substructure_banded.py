"""Port vs JAX package on the CPU in f64: FETI and BDD with banded local
solves (``-hpddm_substructuring_local banded``) and Chebyshev coarse
solves (``-hpddm_substructuring_coarse cheby``), the cases of
``tests/test_substructure_banded.py`` at its sizes and tolerances:

* banded FETI (dirichlet, lumped, none) and BDD at ``generate(16, 32, 32)``
  and ``generate(4, 20, 24)``: the dirichlet count is the JAX package's
  exactly and within 1 of the dense-local count; lumped and none within 1
  of it (C22: their recurrences amplify rounding, and the JAX package's
  own jitted and op-by-op runs differ by 1 at these cells); BDD on the JAX
  package's carried Chebyshev bounds exactly, on the port's own bounds
  within C21's window, and at most dense + 5; solutions within 1e-6 of the
  direct solve;
* banded with the mfree coarse mode: the JAX package's count, no dense G,
  dummy dense factors;
* the cheby coarse mode on carried bounds exactly (the JAX package's state
  carried whole by ``interop``), on the port's own bounds within C21's
  window;
* GenEO-substructuring through the Lanczos pencil at nu=2 (C20: the
  pencil's few distinct eigenvalues exhaust the Krylov space, so no
  eigenvalue is compared): the port's enrichment on the JAX package's
  eigenpairs gives the JAX package's balancing ranks and BDD count; on its
  own pencil the balancing basis is
  orthonormal on valid rows and zero on padded rows, BDD converges within
  ``SLACK`` of the JAX package's count (C20) and at most dense + 5;
* ``_cheb_inverse`` and ``_spd_bounds`` against the JAX functions on one
  SPD operator.

C21 (ROADMAP queue C): the port draws the start vectors of its bounds
from a seeded ``torch.Generator``, the JAX package from
``jax.random.PRNGKey(41|17|29)``. ``C21_WINDOW`` is the JAX package's own
spread of each count over the start keys, which ``-m slow``
(``test_c21_window_is_the_jax_spread``) recomputes.

The JAX package's banded path segfaults XLA CPU once a process has
compiled many programs (``tests/test_substructure_banded.py:1-12``), so
every JAX reference of this file is computed in one fresh subprocess
(``_jax_reference``, run once by the module fixture ``ref``) and comes
back as numpy arrays. That process runs with
``jax_disable_most_optimizations`` (its compiles are most of its time;
the counts held exactly are the same with and without).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.examples.bench_feti import rhs
from hpddm_tpu_torch.models import nonoverlap
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import substructure as sub

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
FETI_MAX = {"dirichlet": 200, "lumped": 400, "none": 400}
BDD_MAX = 300
CELLS = ((16, 32, 32), (4, 20, 24))
# the high-contrast or degenerate GenEO counts follow the eigensolver's
# basis (C20)
SLACK = 5
# C21: the JAX package's counts over jax.random.PRNGKey(k + 41 | 17 | 29),
# k = 0..4, at tol 1e-9 (the bounds it estimates move in the third digit,
# the counts not at all): (lowest, highest)
C21_WINDOW = {
    ((16, 32, 32), "dense", "bdd"): (19, 19),
    ((4, 20, 24), "dense", "bdd"): (14, 14),
    ((16, 32, 32), "cheby", "feti dirichlet"): (18, 18),
    ((16, 32, 32), "cheby", "bdd"): (19, 19),
}


def _build(gen, **opts):
    return sub.Substructure(
        gen.mats, gen.neighbors, gen.mappings,
        options=Options(substructuring_local="banded", **opts),
        kernels=gen.kernels, grid_shapes=gen.grid_shapes,
        slot_maps=gen.slot_maps, device="cpu")


# ----------------------------------------------------------------------
# the JAX package's references, in a subprocess
# ----------------------------------------------------------------------

def _jax_reference(path):
    """Every JAX reference of this file, pickled to path as numpy arrays
    (run in a fresh process with JAX on the CPU in f64)."""
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.models import nonoverlap as jnon
    from hpddm_tpu.options import Options as JOptions
    from hpddm_tpu.precond import substructure as js
    from test_torch_substructure import jax_state_arrays

    feti = jax.jit(js.feti_solve, static_argnames=(
        "tol", "max_it", "precond", "axis_name"))
    bdd = jax.jit(js.bdd_solve, static_argnames=(
        "tol", "max_it", "axis_name"))

    def build(gen, **opts):
        return js.Substructure(
            gen.mats, gen.neighbors, gen.mappings,
            options=JOptions(substructuring_local="banded", **opts),
            kernels=gen.kernels, grid_shapes=gen.grid_shapes,
            slot_maps=gen.slot_maps)

    def counts(st, f, preconds):
        out = {f"feti {p}": int(feti(st, f, tol=TOL, max_it=FETI_MAX[p],
                                     precond=p).iterations)
               for p in preconds}
        out["bdd"] = int(bdd(st, f, tol=TOL, max_it=BDD_MAX).iterations)
        return out

    def bounds(st):
        return {k: None if getattr(st, k) is None else float(getattr(st, k))
                for k in ("sb_lo", "sb_hi", "gtg_lo", "gtg_hi", "wsw_lo",
                          "wsw_hi")} | {
            k: int(getattr(st, k)) for k in (
                "sb_degree", "coarse_degree", "bdd_coarse_degree")}

    ref = {}
    for cell in CELLS:
        gen = jnon.generate(*cell)
        s = build(gen)
        f = jnp.asarray(rhs(gen, s.n_max, np.float64))
        ref[cell, "dense"] = dict(counts=counts(s.state, f, FETI_MAX),
                                  bounds=bounds(s.state))
        if cell != CELLS[0]:
            continue
        st = s.state
        rng = np.random.default_rng(5)
        X = rng.normal(size=(st.N_l, 2))
        Y = rng.normal(size=(st.S_total, st.bidx.shape[1], 2))
        Y = np.asarray(js.exchange(st.dec_b, jnp.asarray(Y))) * \
            np.asarray(st.b_mask)[:, :, None]
        ref["operators"] = dict(
            X=X, Y=Y, arrays=jax_state_arrays(st),
            F=np.asarray(js.feti_operator(st, jnp.asarray(X))),
            Pd=np.asarray(js.feti_precond(st, jnp.asarray(X))),
            Sb=np.asarray(js._sb_apply(st, jnp.asarray(Y))),
            bdd_op=np.asarray(js.bdd_operator(st, jnp.asarray(Y))))
        # solve_gevp's Lanczos eigenpairs, recorded on their way through
        pencil = []
        lanczos = js._schur_gevp_lanczos
        js._schur_gevp_lanczos = lambda *a: pencil.append(lanczos(*a)) or \
            pencil[-1]
        try:
            en = s.solve_gevp(nu=2)
        finally:
            js._schur_gevp_lanczos = lanczos
        ref["gevp"] = dict(lam=np.asarray(pencil[0][0]),
                           V=np.asarray(pencil[0][1]),
                           sb_r_loc=np.asarray(en.sb_r_loc),
                           bdd=int(bdd(en, f, tol=TOL,
                                       max_it=BDD_MAX).iterations))
        s = build(gen, substructuring_coarse="cheby")
        ref[cell, "cheby"] = dict(counts=counts(s.state, f, ("dirichlet",)),
                                  bounds=bounds(s.state),
                                  arrays=jax_state_arrays(s.state))
    # the Chebyshev solve and the bounds estimate on one SPD operator
    rng = np.random.default_rng(6)
    Q, _ = np.linalg.qr(rng.normal(size=(30, 30)))
    M = (Q * np.linspace(0.5, 40.0, 30)) @ Q.T
    v0, b = rng.normal(size=(30, 1)), rng.normal(size=(30, 2))
    Mj = jnp.asarray(M)
    hi, lo = js._spd_bounds(lambda v: Mj @ v, jnp.asarray(v0), 4)
    x = js._cheb_inverse(lambda v: Mj @ v, jnp.asarray(b), float(lo) * 0.5,
                         float(hi) * 1.05, 20)
    ref["cheb"] = dict(M=M, v0=v0, b=b, hi=float(hi), lo=float(lo),
                       x=np.asarray(x))
    with open(path, "wb") as fh:
        pickle.dump(ref, fh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_banded") / "ref.pkl")
    code = ("import sys; sys.path[:0] = [{root!r}, {tests!r}]; "
            "import jax; jax.config.update('jax_platforms', 'cpu'); "
            "jax.config.update('jax_enable_x64', True); "
            "jax.config.update('jax_disable_most_optimizations', True); "
            "from test_torch_substructure_banded import _jax_reference; "
            "_jax_reference({path!r})").format(
                root=ROOT, tests=os.path.join(ROOT, "tests"), path=path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    with open(path, "rb") as fh:
        return pickle.load(fh)


# ----------------------------------------------------------------------
# the port's side
# ----------------------------------------------------------------------

class Cell:
    """One generated problem with the port's banded and dense states."""

    def __init__(self, args, **opts):
        self.gen = nonoverlap.generate(*args)
        self.sub = _build(self.gen, **opts)
        self.f = torch.as_tensor(rhs(self.gen, self.sub.n_max, np.float64))
        self.x_direct = spla.spsolve(self.gen.A_global.tocsc(),
                                     self.gen.f_global)

    def dense(self):
        if not hasattr(self, "_dense"):
            g = self.gen
            self._dense = sub.Substructure(g.mats, g.neighbors, g.mappings,
                                           device="cpu").state
        return self._dense

    def error(self, u):
        """Relative error of the averaged solution against the direct
        solve."""
        N = self.gen.A_global.shape[0]
        acc, cnt = np.zeros(N), np.zeros(N)
        u = u[:, :, 0].numpy()
        for s, g in enumerate(self.gen.gids):
            acc[g] += u[s, : len(g)]
            cnt[g] += 1
        return (np.linalg.norm(acc / cnt - self.x_direct)
                / np.linalg.norm(self.x_direct))


@pytest.fixture(scope="module")
def cell():
    cache = {}

    def get(args, **opts):
        key = (args, tuple(sorted(opts.items())))
        if key not in cache:
            cache[key] = Cell(args, **opts)
        return cache[key]
    return get


def _rel(a, b):
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("args", CELLS)
def test_banded_feti(ref, cell, args):
    """FETI on banded locals, three preconditioners: dirichlet the JAX
    package's count exactly, lumped and none within 1 of it (C22); each
    within 1 of the port's dense-local count and exact against the direct
    solve. The dense-local K^+ is never formed."""
    c = cell(args)
    want = ref[args, "dense"]["counts"]
    assert c.sub.state.K_pinv.shape[1:] == (1, 1)
    dense = c.dense()
    for p, max_it in FETI_MAX.items():
        res = sub.feti_solve(c.sub.state, c.f, tol=TOL, max_it=max_it,
                             precond=p)
        slack = 0 if p == "dirichlet" else 1
        assert abs(res.iterations - want[f"feti {p}"]) <= slack, \
            (p, res.iterations, want)
        assert c.error(res.u) < 1e-6, p
        if p == "dirichlet":
            d = sub.feti_solve(dense, c.f, tol=TOL, max_it=max_it)
            assert abs(res.iterations - d.iterations) <= 1


@pytest.mark.parametrize("args", CELLS)
def test_banded_bdd(ref, cell, args):
    """BDD on banded locals (the Chebyshev S_b^+): on the JAX package's
    bounds its count exactly, on the port's own within C21's window, at
    most dense + 5 and exact against the direct solve."""
    c = cell(args)
    jr = ref[args, "dense"]
    st = c.sub.state
    b = jr["bounds"]
    carried = sub.dataclasses.replace(st, sb_lo=b["sb_lo"], sb_hi=b["sb_hi"],
                                      sb_degree=b["sb_degree"])
    assert sub.bdd_solve(carried, c.f, tol=TOL,
                         max_it=BDD_MAX).iterations == jr["counts"]["bdd"]
    res = sub.bdd_solve(st, c.f, tol=TOL, max_it=BDD_MAX)
    lo, hi = C21_WINDOW[args, "dense", "bdd"]
    assert lo <= res.iterations <= hi
    assert res.iterations <= sub.bdd_solve(c.dense(), c.f, tol=TOL,
                                           max_it=BDD_MAX).iterations + 5
    assert c.error(res.u) < 1e-6
    # the port's own bounds against the JAX package's: the power iterations
    # from other starts (the degree within the clipping)
    assert abs(st.sb_hi - b["sb_hi"]) <= 0.01 * b["sb_hi"]
    assert 0.5 * b["sb_lo"] <= st.sb_lo <= 2.0 * b["sb_lo"]
    assert abs(st.sb_degree - b["sb_degree"]) <= 8


def test_banded_mfree(ref, cell):
    """Banded locals with the mfree coarse mode, exact like the dense
    coarse mode: the JAX package's FETI count (its mfree count is its
    dense-coarse one, tests/test_substructure.py:140), no G, dummy dense
    factors; with_coarse_mode on the dense-coarse state gives the same
    coarse matrix."""
    args = CELLS[0]
    c = cell(args, substructuring_coarse="mfree")
    st = c.sub.state
    want = ref[args, "dense"]["counts"]
    assert st.G is None and st.K_pinv.shape[1:] == (1, 1)
    res = sub.feti_solve(st, c.f, tol=TOL, max_it=200)
    assert res.iterations == want["feti dirichlet"]
    assert c.error(res.u) < 1e-6
    # mfree is exact, so its BDD count is the dense-coarse one: on the
    # port's own Chebyshev S_b^+ bounds, in C21's window
    b = sub.bdd_solve(st, c.f, tol=TOL, max_it=BDD_MAX)
    lo, hi = C21_WINDOW[args, "dense", "bdd"]
    assert lo <= want["bdd"] <= hi and lo <= b.iterations <= hi
    assert c.error(b.u) < 1e-6
    derived = sub.with_coarse_mode(cell(args).sub.state, "mfree")
    assert derived.G is None
    assert _rel(st.GtG_inv.numpy(), derived.GtG_inv) < 1e-12


def test_cheby_coarse(ref, cell):
    """-hpddm_substructuring_coarse cheby on banded locals: the JAX
    package's state carried whole (factors, bounds, degrees) takes its
    counts exactly and gives its operators; the port's own bounds are the
    JAX package's to the power iteration's accuracy and its counts lie in
    C21's window."""
    args = CELLS[0]
    jr = ref[args, "cheby"]
    carried = interop.substructure_state_from_numpy(jr["arrays"],
                                                    device="cpu")
    assert carried.coarse_mode == "cheby" and carried.G is None
    assert carried.coarse_degree == jr["bounds"]["coarse_degree"]
    c = cell(args, substructuring_coarse="cheby")
    f = c.f
    assert sub.feti_solve(carried, f, tol=TOL, max_it=200).iterations == \
        jr["counts"]["feti dirichlet"]
    assert sub.bdd_solve(carried, f, tol=TOL, max_it=BDD_MAX).iterations \
        == jr["counts"]["bdd"]
    st = c.sub.state
    assert st.GtG_inv is None and st.coarse_mode == "cheby"
    b = jr["bounds"]
    for k in ("gtg_hi", "wsw_hi"):
        assert abs(getattr(st, k) - b[k]) <= 0.05 * b[k], k
    for k in ("gtg_lo", "wsw_lo"):
        assert 0.5 * b[k] <= getattr(st, k) <= 2.0 * b[k], k
    for name, res in (
            ("feti dirichlet", sub.feti_solve(st, f, tol=TOL, max_it=200)),
            ("bdd", sub.bdd_solve(st, f, tol=TOL, max_it=BDD_MAX))):
        lo, hi = C21_WINDOW[args, "cheby", name]
        assert lo <= res.iterations <= hi, (name, res.iterations)
        assert c.error(res.u) < 1e-6, name
    # with_coarse_mode estimates the bounds on the same factors
    derived = sub.with_coarse_mode(cell(args).sub.state, "cheby")
    assert (derived.gtg_lo, derived.gtg_hi, derived.coarse_degree) == \
        (st.gtg_lo, st.gtg_hi, st.coarse_degree)


def test_operators_on_the_carried_state(ref):
    """The JAX package's banded state carried by interop (its factors,
    packed matrices and bounds): F, the Dirichlet preconditioner, the
    implicit S_b and the BDD operator equal the JAX package's to 1e-12
    (the Chebyshev S_b^+ through the BDD count on the carried bounds)."""
    op = ref["operators"]
    st = interop.substructure_state_from_numpy(op["arrays"], device="cpu")
    assert st.local_mode == "banded" and st.Kb is not None
    X, Y = torch.as_tensor(op["X"]), torch.as_tensor(op["Y"])
    assert _rel(op["F"], sub.feti_operator(st, X)) < 1e-12
    assert _rel(op["Pd"], sub.feti_precond(st, X)) < 1e-12
    assert _rel(op["Sb"], sub._sb_apply(st, Y)) < 1e-12
    assert _rel(op["bdd_op"], sub.bdd_operator(st, Y)) < 1e-12


def test_lanczos_geneo(ref, cell):
    """GenEO-substructuring through the matrix-free Lanczos pencil at
    nu=2 (C20). At this cell the pencil has one to three distinct
    eigenvalues per subdomain (4 alone on the corner subdomains, where
    D = 1/2), so the Krylov space of one start vector is exhausted within
    a few of the 12 Lanczos steps and the later Ritz pairs are rounding
    noise in both packages: no eigenvalue is compared. On the carried state
    the port's enrichment on the JAX package's eigenpairs gives the JAX
    package's balancing ranks and BDD count; on its own state the
    balancing basis is orthonormal on valid rows and zero on padded rows,
    and BDD converges within SLACK of the JAX package and at most dense +
    5 (dense: the dense pencil at nu=2)."""
    args = CELLS[0]
    g = ref["gevp"]
    carried = interop.substructure_state_from_numpy(
        ref["operators"]["arrays"], device="cpu")
    on_jax = sub.solve_gevp(carried, nu=2, pencil=(g["lam"], g["V"]))
    assert np.array_equal(on_jax.sb_r_loc.numpy(), g["sb_r_loc"])
    c = cell(args)
    assert sub.bdd_solve(on_jax, c.f, tol=TOL,
                         max_it=BDD_MAX).iterations == g["bdd"]

    st = sub.solve_gevp(c.sub.state, nu=2)
    Sbk, msk = st.Sb_kernels.numpy(), st.b_mask.numpy()
    rk = st.sb_r_loc.numpy()
    assert np.abs(Sbk[~msk]).max(initial=0.0) < 1e-12
    for s in range(Sbk.shape[0]):
        Q = Sbk[s, :, : rk[s]]
        np.testing.assert_allclose(Q.T @ Q, np.eye(int(rk[s])), atol=1e-10)
    res = sub.bdd_solve(st, c.f, tol=TOL, max_it=BDD_MAX)
    assert c.error(res.u) < 1e-6
    assert abs(res.iterations - g["bdd"]) <= SLACK
    dense = sub.solve_gevp(c.dense(), nu=2)
    assert res.iterations <= sub.bdd_solve(dense, c.f, tol=TOL,
                                           max_it=BDD_MAX).iterations + 5


def test_cheb_inverse_and_spd_bounds(ref):
    """``_spd_bounds`` and ``_cheb_inverse`` equal the JAX functions on
    one SPD operator (30 x 30, spectrum 0.5..40). The bounds at 4 steps:
    the shifted iteration starts from the first one's converged vector, so
    after the default 48 steps its components along the low eigenvectors,
    and the lower bound, are rounding noise in both packages (C21)."""
    r = ref["cheb"]
    M = torch.as_tensor(r["M"])
    hi, lo = sub._spd_bounds(lambda v: M @ v, torch.as_tensor(r["v0"]), 4)
    assert abs(float(hi) - r["hi"]) <= 1e-12 * r["hi"]
    assert abs(float(lo) - r["lo"]) <= 1e-12 * r["hi"]
    x = sub._cheb_inverse(lambda v: M @ v, torch.as_tensor(r["b"]),
                          r["lo"] * 0.5, r["hi"] * 1.05, 20)
    assert _rel(r["x"], x) < 1e-12


def test_banded_needs_grid_shapes(cell):
    """The JAX package's ValueErrors: no grid_shapes; a grid shape that
    does not match n without slot maps."""
    g = cell(CELLS[1]).gen
    opts = Options(substructuring_local="banded")
    with pytest.raises(ValueError, match="grid_shapes"):
        sub.Substructure(g.mats, g.neighbors, g.mappings, options=opts,
                         device="cpu")
    with pytest.raises(ValueError, match="slot_maps"):
        sub.Substructure(g.mats, g.neighbors, g.mappings, options=opts,
                         kernels=g.kernels, grid_shapes=g.grid_shapes,
                         device="cpu")


# ----------------------------------------------------------------------
# the caveats' evidence (-m slow)
# ----------------------------------------------------------------------

def _jax_spread(path, cells, keys):
    """The JAX package's banded counts with its start keys shifted by k
    (C21), pickled to path: {(cell, coarse mode, name): [count per k]}."""
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.models import nonoverlap as jnon
    from hpddm_tpu.options import Options as JOptions
    from hpddm_tpu.precond import substructure as js

    feti = jax.jit(js.feti_solve, static_argnames=(
        "tol", "max_it", "precond", "axis_name"))
    bdd = jax.jit(js.bdd_solve, static_argnames=(
        "tol", "max_it", "axis_name"))
    key = jax.random.PRNGKey
    out = {}
    for cell_, mode in cells:
        gen = jnon.generate(*cell_)
        f = None
        for k in keys:
            jax.random.PRNGKey = (lambda s, k=k: key(s + k))
            try:
                s = js.Substructure(
                    gen.mats, gen.neighbors, gen.mappings,
                    options=JOptions(substructuring_local="banded",
                                     substructuring_coarse=mode),
                    kernels=gen.kernels, grid_shapes=gen.grid_shapes,
                    slot_maps=gen.slot_maps)
            finally:
                jax.random.PRNGKey = key
            if f is None:
                f = jnp.asarray(rhs(gen, s.n_max, np.float64))
            out.setdefault((cell_, mode, "bdd"), []).append(int(bdd(
                s.state, f, tol=TOL, max_it=BDD_MAX).iterations))
            if mode == "cheby":
                out.setdefault((cell_, mode, "feti dirichlet"), []).append(
                    int(feti(s.state, f, tol=TOL, max_it=200).iterations))
    with open(path, "wb") as fh:
        pickle.dump(out, fh)


@pytest.mark.slow
def test_c21_window_is_the_jax_spread(tmp_path):
    """``C21_WINDOW`` is the JAX package's own spread of each count over
    five start keys (about 3 minutes on one core)."""
    path = str(tmp_path / "spread.pkl")
    code = ("import sys; sys.path[:0] = [{root!r}, {tests!r}]; "
            "import jax; jax.config.update('jax_platforms', 'cpu'); "
            "jax.config.update('jax_enable_x64', True); "
            "from test_torch_substructure_banded import _jax_spread; "
            "_jax_spread({path!r}, [((16, 32, 32), 'dense'), "
            "((4, 20, 24), 'dense'), ((16, 32, 32), 'cheby')], "
            "range(5))").format(root=ROOT, tests=os.path.join(ROOT, "tests"),
                                path=path)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=1800)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    with open(path, "rb") as fh:
        spread = pickle.load(fh)
    assert {k: (min(v), max(v)) for k, v in spread.items()} == C21_WINDOW


def _jax_rounding(path):
    """The JAX package's lumped and none FETI counts at the cells where
    they follow rounding (C22), pickled to path: jitted, op by op, and
    jitted on f (1 + 1e-15)."""
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.models import nonoverlap as jnon
    from hpddm_tpu.options import Options as JOptions
    from hpddm_tpu.precond import substructure as js

    feti = jax.jit(js.feti_solve, static_argnames=(
        "tol", "max_it", "precond", "axis_name"))
    out = {}
    for cell_, p in (((4, 20, 24), "lumped"), ((16, 32, 32), "none")):
        gen = jnon.generate(*cell_)
        s = js.Substructure(
            gen.mats, gen.neighbors, gen.mappings,
            options=JOptions(substructuring_local="banded"),
            kernels=gen.kernels, grid_shapes=gen.grid_shapes,
            slot_maps=gen.slot_maps)
        f = jnp.asarray(rhs(gen, s.n_max, np.float64))
        out[cell_, p] = [int(fn(s.state, g, tol=TOL, max_it=FETI_MAX[p],
                                precond=p).iterations)
                         for fn, g in ((feti, f), (js.feti_solve, f),
                                       (feti, f * (1 + 1e-15)))]
    with open(path, "wb") as fh:
        pickle.dump(out, fh)


@pytest.mark.slow
def test_c22_jax_counts_follow_rounding(tmp_path, cell):
    """C22: at the two cells where the port's lumped or none FETI count
    is 1 from the JAX package's jitted count, the JAX package's own count
    moves by 1 between its jitted and op-by-op runs or under a 1e-15
    relative change of f, and the port's count is one of the JAX
    package's (about 1 minute on one core)."""
    path = str(tmp_path / "rounding.pkl")
    code = ("import sys; sys.path[:0] = [{root!r}, {tests!r}]; "
            "import jax; jax.config.update('jax_platforms', 'cpu'); "
            "jax.config.update('jax_enable_x64', True); "
            "from test_torch_substructure_banded import _jax_rounding; "
            "_jax_rounding({path!r})").format(
                root=ROOT, tests=os.path.join(ROOT, "tests"), path=path)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    with open(path, "rb") as fh:
        runs = pickle.load(fh)
    for (args, p), counts in runs.items():
        assert max(counts) - min(counts) == 1, (args, p, counts)
        c = cell(args)
        mine = sub.feti_solve(c.sub.state, c.f, tol=TOL, max_it=FETI_MAX[p],
                              precond=p).iterations
        assert mine in counts, (args, p, mine, counts)


def _jax_smoke_constants(path, caps):
    """The JAX package's counts at smoke phase 25's cell (a) and its
    residuals at cell (b) at the iteration caps ``caps``, pickled to
    path."""
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.models import nonoverlap as jnon
    from hpddm_tpu.options import Options as JOptions
    from hpddm_tpu.precond import substructure as js

    feti = jax.jit(js.feti_solve, static_argnames=(
        "tol", "max_it", "precond", "axis_name"))
    bdd = jax.jit(js.bdd_solve, static_argnames=(
        "tol", "max_it", "axis_name"))

    def build(gen, mode):
        return js.Substructure(
            gen.mats, gen.neighbors, gen.mappings,
            options=JOptions(substructuring_local="banded",
                             substructuring_coarse=mode),
            kernels=gen.kernels, grid_shapes=gen.grid_shapes,
            slot_maps=gen.slot_maps)

    its, res = {}, {}
    gen = jnon.generate(64, 128, 128)
    for mode in ("dense", "mfree", "cheby"):
        s = build(gen, mode)
        f = jnp.asarray(rhs(gen, s.n_max, np.float64))
        for p in ("dirichlet", "lumped", "none"):
            its[f"a {mode} feti {p}"] = int(feti(
                s.state, f, tol=1e-8, max_it=500, precond=p).iterations)
        its[f"a {mode} bdd"] = int(bdd(s.state, f, tol=1e-8,
                                       max_it=500).iterations)
    gen = jnon.generate(64, 256, 256, contrast=1e4, checker=16)
    s = build(gen, "cheby")
    f = jnp.asarray(rhs(gen, s.n_max, np.float64))
    for feti_key, bdd_key in (("b feti", "b bdd"),
                              ("b feti deflated", "b bdd enriched")):
        st = s.state if feti_key == "b feti" else s.solve_gevp(
            nu=6, feti_deflation=True)
        res[feti_key] = float(feti(st, f, tol=1e-8, max_it=caps[
            "feti"]).rel_res[0])
        res[bdd_key] = float(bdd(st, f, tol=1e-8, max_it=caps[
            "bdd"]).rel_res[0])
    with open(path, "wb") as fh:
        pickle.dump((its, res), fh)


@pytest.mark.slow
def test_smoke_constants_are_the_jax_counts(tmp_path):
    """``FETI5B_JAX_ITS`` and ``FETI5B_JAX_RES``, what smoke phase 25
    holds the card to: the JAX package's CPU counts at (a) exactly, its
    residuals at (b) at the caps ``FETI5B_CAPS`` within 10% (about 10
    minutes on four cores, most of it (b))."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    path = str(tmp_path / "smoke.pkl")
    code = ("import sys; sys.path[:0] = [{root!r}, {tests!r}]; "
            "import jax; jax.config.update('jax_platforms', 'cpu'); "
            "jax.config.update('jax_enable_x64', True); "
            "from test_torch_substructure_banded import "
            "_jax_smoke_constants; _jax_smoke_constants({path!r}, "
            "{caps!r})").format(root=ROOT, tests=os.path.join(ROOT, "tests"),
                                path=path, caps=chip_smoke.FETI5B_CAPS)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=5400)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    with open(path, "rb") as fh:
        its, res = pickle.load(fh)
    assert its == chip_smoke.FETI5B_JAX_ITS
    for k, v in chip_smoke.FETI5B_JAX_RES.items():
        assert abs(res[k] - v) <= 0.1 * v, (k, res[k], v)
