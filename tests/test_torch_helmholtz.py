"""Port vs JAX package on the CPU: slice 5c, complex scalars and the
Helmholtz model with ORAS/SORAS on optimized local matrices.

* ``helmholtz.generate`` is byte-equal to the JAX package's in both
  forms (native complex and the real pair), and both packages pack its
  matrices in the same format with the same offsets.
* The anchors at 60x60, S=4, k=6, eps=0, GMRES(200), tol 1e-6: c128 ORAS
  takes the JAX package's count (computed here; 100) with the ``inv`` and
  the ``lu`` local solver, and SORAS with the optimized matrices and the
  real pair in f64 and f32 take ``ANCHOR_ITS`` (110, 194, 194; the JAX
  package's counts, which the ``-m slow`` case recomputes).
* The twins of the JAX package's tests of ``tests/test_models.py``:
  ``test_complex_gmres``, ``test_helmholtz_oras_beats_ras`` (the ORAS
  count equal to the JAX package's at tol 1e-8; the RAS count is driven
  by rounding, ROADMAP queue C, so only ORAS < RAS is held) and the
  eps=0.3 recycling sweep (GMRES and GCRODR totals ``SWEEP_TOTALS``, the
  JAX package's, recomputed by the ``-m slow`` case).
* The complex block-sparse coarse blocks (``_bsr_blocks``) against the
  dense Galerkin product and the JAX package's blocks; an interop round
  trip of a c128 ORAS state (inv and lu); complex64 raising (C11).

One JAX solve (c128 ORAS at tol 1e-8, whose history gives the tol 1e-6
count too) is shared through a module fixture.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpddm_tpu.models import helmholtz as jax_h
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond.schwarz import Schwarz as JaxSchwarz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.core.formats import BatchedDIA, pack_local_matrices
from hpddm_tpu_torch.examples import helmholtz as twin
from hpddm_tpu_torch.models import helmholtz
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve

from test_torch_schwarz import jax_state_arrays

S, NX, K = 4, 60, 6.0
ANCHOR_ITS = twin.ANCHOR_ITS
# GMRES(30) and GCRODR(30, 10) totals over k = 4.0, 4.05, 4.1 at 40x40,
# S=4, eps=0.3, ORAS, tol 1e-8 (tests/test_models.py:66-95): the JAX
# package's, recomputed by test_sweep_and_anchor_constants_are_the_jax_packages
SWEEP_TOTALS = {"gmres": 211, "gcrodr": 214}
SWEEP_KS = (4.0, 4.05, 4.1)


def _csr_bytes(m):
    c = m.scipy(expand=False)
    return tuple(np.ascontiguousarray(getattr(c, k)).tobytes()
                 for k in ("indptr", "indices", "data")) + (str(c.dtype),)


def _rhs(gen, n_max, dtype=None):
    f = np.zeros((len(gen.mats), n_max, 1),
                 dtype=dtype if dtype is not None else gen.f[0].dtype)
    for s in range(len(gen.mats)):
        f[s, : gen.n_loc[s]] = np.asarray(gen.f[s]).reshape(-1, 1)
    return f


def _port(gen, method="oras", local_solver="inv", optimized=True, **kw):
    opt = Options(schwarz_method=method, local_solver=local_solver,
                  gmres_restart=200, **kw)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=opt, device="cpu",
                     optimized_mats=gen.oras_mats if optimized else None)
    return sch, opt, torch.as_tensor(_rhs(gen, sch.n_max))


def _count(hist, tol):
    """The first iteration whose relative residual estimate is <= tol."""
    hist = np.asarray(hist)[:, 0]
    return int(np.nonzero((hist >= 0) & (hist <= tol))[0][0])


@pytest.fixture(scope="module")
def jax_oras():
    """The JAX package's c128 ORAS state and solve at tol 1e-8 (max_it
    300, as its oras < ras test), and its counts at 1e-8 and 1e-6."""
    gen = jax_h.generate(S, Nx=NX, Ny=NX, k=K, eps=0.0)
    opt = JaxOptions(schwarz_method="oras", tol=1e-8, max_it=300,
                     gmres_restart=200)
    sch = JaxSchwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=opt, optimized_mats=gen.oras_mats)
    f = _rhs(gen, sch.n_max)
    state = sch.build()
    res = jax_solve(state, jnp.asarray(f), opt=opt)
    return dict(state=state, f=f, its8=int(res.iterations),
                its6=_count(res.history, 1e-6))


@pytest.mark.parametrize("as_real,dtype", [(False, np.complex128),
                                           (True, np.complex128),
                                           (True, np.complex64)])
def test_generate_is_byte_equal(as_real, dtype):
    kw = dict(Nx=NX, Ny=NX, k=K, eps=0.05, as_real=as_real, dtype=dtype)
    g, j = helmholtz.generate(S, **kw), jax_h.generate(S, **kw)
    for name in ("mats", "oras_mats"):
        assert [_csr_bytes(m) for m in getattr(g, name)] == \
            [_csr_bytes(m) for m in getattr(j, name)], name
    for name in ("d", "f"):
        for a, b in zip(getattr(g, name), getattr(j, name)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert g.n_loc == j.n_loc and g.neighbors == j.neighbors
    for ms, js in zip(g.mappings, j.mappings):
        assert [np.asarray(m).tobytes() for m in ms] == \
            [np.asarray(m).tobytes() for m in js]


@pytest.mark.parametrize("S_,Nx,as_real,ndiag,n_max", [
    (S, NX, False, 5, 961), (S, NX, True, 15, 1922),
    (64, 512, False, 5, 4356), (64, 512, True, 31, 8712)])
def test_pack_format_and_offsets_follow_jax(S_, Nx, as_real, ndiag, n_max):
    """Both packages choose DIA with the same offsets for the operator
    and the optimized matrices: 5 diagonals native, the union of each
    subdomain's +-n_s in the real pair (15 at the anchor, 31 at the card's
    full cell, 512x512, S=64); at the anchor the packed values are
    equal too."""
    from hpddm_tpu.core import formats as jax_formats
    from hpddm_tpu_torch.core import formats

    g = helmholtz.generate(S_, Nx=Nx, Ny=Nx, k=K, eps=0.0, as_real=as_real)
    j = jax_h.generate(S_, Nx=Nx, Ny=Nx, k=K, eps=0.0, as_real=as_real)
    for mine, theirs in ((g.mats, j.mats), (g.oras_mats, j.oras_mats)):
        offs = formats._diag_offsets(mine)
        assert len(offs) == ndiag and max(m.n for m in mine) == n_max
        assert offs.tolist() == jax_formats._diag_offsets(theirs).tolist()
        if S_ == S:
            A = pack_local_matrices(mine, device="cpu")
            B = jax_formats.pack_local_matrices(theirs)
            assert isinstance(A, BatchedDIA)
            assert A.offsets == tuple(B.offsets)
            np.testing.assert_array_equal(A.values.numpy(),
                                          np.asarray(B.values))


@pytest.mark.parametrize("case", ["oras", "oras lu", "soras",
                                  "real pair f64", "real pair f32"])
def test_anchor_counts(case, jax_oras):
    as_real = case.startswith("real")
    gen = helmholtz.generate(
        S, Nx=NX, Ny=NX, k=K, eps=0.0, as_real=as_real,
        dtype=np.complex64 if case.endswith("f32") else np.complex128)
    sch, opt, f = _port(gen, method=case.split()[0] if not as_real
                        else "oras",
                        local_solver="lu" if case.endswith("lu") else "inv",
                        tol=1e-6, max_it=500)
    state = sch.build()
    res = solve(state, f, opt=opt)
    want = jax_oras["its6"] if case.startswith("oras") else ANCHOR_ITS[case]
    assert res.iterations == want == ANCHOR_ITS[case.split(" lu")[0]]
    nb, nr = sz.compute_residual(state, res.x, f)
    # f32's recomputed residual lies near 1e-5 here, in both packages (the
    # JAX package's 8.2e-6 on the CPU): its gate is f32's floor
    assert float(nr[0] / nb[0]) <= (1e-4 if case.endswith("f32") else 1e-5)
    assert res.x.dtype == f.dtype


def test_oras_beats_ras(jax_oras):
    """Twin of test_helmholtz_oras_beats_ras: undamped, tol 1e-8, RAS at
    its cap of 300 or above ORAS; the ORAS count the JAX package's."""
    gen = helmholtz.generate(S, Nx=NX, Ny=NX, k=K, eps=0.0)
    its = {}
    for method, optimized in (("ras", False), ("oras", True)):
        sch, opt, f = _port(gen, method=method, optimized=optimized,
                            tol=1e-8, max_it=300)
        state = sch.build()
        res = solve(state, f, opt=opt)
        its[method] = res.iterations
        if method == "oras":
            nb, nr = sz.compute_residual(state, res.x, f)
            assert float(nr[0] / nb[0]) < 1e-2
    assert its["oras"] == jax_oras["its8"] and its["oras"] < its["ras"], its


def test_complex_gmres():
    """Twin of the JAX package's test_complex_gmres (K = complex<double>):
    the same count and solution as its GMRES on the same operator."""
    import scipy.sparse as sp
    from hpddm_tpu.solvers.base import LinearOperator as JaxOperator
    from hpddm_tpu.solvers.gmres import gmres as jax_gmres
    from hpddm_tpu_torch.solvers.base import LinearOperator
    from hpddm_tpu_torch.solvers.gmres import gmres

    n = 50
    rng = np.random.default_rng(0)
    A = sp.diags([np.full(n - 1, -1.0), 4.0 + 1j * rng.normal(size=n),
                  np.full(n - 1, -1.0)], [-1, 0, 1]).tocsr()
    b = (rng.normal(size=(1, n, 1)) + 1j * rng.normal(size=(1, n, 1)))
    Ad = np.asarray(A.todense())
    want = jax_gmres(JaxOperator(gmv=lambda x: jnp.einsum(
        "nk,skm->snm", jnp.asarray(Ad), x)), jnp.asarray(b), tol=1e-10,
        restart=60, max_it=200)
    At = torch.as_tensor(Ad)
    res = gmres(LinearOperator(gmv=lambda x: torch.einsum("nk,skm->snm",
                                                          At, x)),
                torch.as_tensor(b), tol=1e-10, restart=60, max_it=200)
    x = res.x.numpy()[0, :, 0]
    r = b[0, :, 0] - A @ x
    assert np.linalg.norm(r) / np.linalg.norm(b[0, :, 0]) < 1e-8
    assert res.iterations == int(want.iterations)
    np.testing.assert_allclose(x, np.asarray(want.x)[0, :, 0], rtol=1e-10)


def _sweep_opts():
    base = dict(schwarz_method="oras", tol=1e-8, gmres_restart=30,
                max_it=300)
    return [Options(krylov_method="gmres", **base),
            Options(krylov_method="gcrodr", recycle=10, **base)]


def test_sweep_totals():
    """The eps=0.3 sweep of tests/test_models.py:66-95 through the twin's
    ``sweep`` (one setup per k, both methods on it): the JAX package's
    totals, GCRODR within its bound of GMRES + 10, every solve
    converged."""
    totals, records, ok = twin.sweep(S, 40, SWEEP_KS, 0.3, _sweep_opts(),
                                     torch.device("cpu"), log=lambda *_: 0)
    assert [r[1] for r in records[::2]] == list(SWEEP_KS)
    assert ok and dict(zip(("gmres", "gcrodr"), totals)) == SWEEP_TOTALS
    assert totals[1] <= totals[0] + 10


@pytest.mark.slow
def test_sweep_and_anchor_constants_are_the_jax_packages():
    """SWEEP_TOTALS and ANCHOR_ITS (SORAS, the real pair) recomputed with
    the JAX package (about 90 s on one core)."""
    from hpddm_tpu.solvers.gcrodr import gcrodr as jax_gcrodr
    from hpddm_tpu.solvers.gmres import gmres as jax_gmres
    from hpddm_tpu.solvers.krylov import make_operator as jax_op

    totals = {"gmres": 0, "gcrodr": 0}
    rec = None
    for k in SWEEP_KS:
        gen = jax_h.generate(S, Nx=40, Ny=40, k=k, eps=0.3)
        sch = JaxSchwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=JaxOptions(schwarz_method="oras"),
                         optimized_mats=gen.oras_mats)
        f = jnp.asarray(_rhs(gen, sch.n_max))
        op = jax_op(sch.build())
        totals["gmres"] += int(jax_gmres(op, f, tol=1e-8, restart=30,
                                         max_it=300).iterations)
        rr = jax_gcrodr(op, f, tol=1e-8, restart=30, max_it=300,
                        recycle=10, recycled=rec)
        rec = rr.recycled
        totals["gcrodr"] += int(rr.iterations)
    assert totals == SWEEP_TOTALS
    for case, as_real, dt, method in (
            ("soras", False, np.complex128, "soras"),
            ("real pair f64", True, np.complex128, "oras"),
            ("real pair f32", True, np.complex64, "oras")):
        gen = jax_h.generate(S, Nx=NX, Ny=NX, k=K, eps=0.0, as_real=as_real,
                             dtype=dt)
        opt = JaxOptions(tol=1e-6, max_it=500, gmres_restart=200,
                         schwarz_method=method)
        sch = JaxSchwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=opt, optimized_mats=gen.oras_mats)
        res = jax_solve(sch.build(), jnp.asarray(_rhs(gen, sch.n_max)),
                        opt=opt)
        assert int(res.iterations) == ANCHOR_ITS[case], case


def test_complex_bsr_blocks():
    """Complex scalars (E complex symmetric, not Hermitian): the port's
    neighbour blocks equal the dense Galerkin product's blocks and the
    JAX package's (twin of tests/test_coarse_bsr.py:71-80)."""
    kw = dict(Nx=24, Ny=24, k=4.0, eps=0.3)
    gen = helmholtz.generate(S, **kw)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(schwarz_coarse_correction="deflated"),
                     device="cpu")
    Z = torch.ones((S, sch.n_max, 1), dtype=torch.complex128)
    for s in range(S):
        Z[s, gen.n_loc[s]:] = 0
    nu_loc = np.ones(S, dtype=np.int32)
    E = sch._assemble_E(Z, nu_loc, 1).numpy().reshape(S, 1, S, 1)
    Ed, En, nbr = sch._bsr_blocks(Z, nu_loc, 1)
    Ed, En = Ed.numpy(), En.numpy()
    assert Ed.dtype == np.complex128 and np.abs(E.imag).max() > 0
    scale = np.abs(E).max()
    jg = jax_h.generate(S, **kw)
    jsch = JaxSchwarz(jg.mats, jg.neighbors, jg.mappings, d=jg.d,
                      options=JaxOptions(
                          schwarz_coarse_correction="deflated",
                          level_2_krylov_method="cg", coarse_assembly="bsr"))
    co = jsch.build().coarse
    oh = np.asarray(co.nbr_oh)
    for s in range(S):
        np.testing.assert_allclose(Ed[s], E[s, :, s, :], atol=1e-10 * scale)
        np.testing.assert_allclose(Ed[s], np.asarray(co.Eb_diag)[s],
                                   atol=1e-10 * scale)
        for j, q in enumerate(nbr[s]):
            if q < S:
                np.testing.assert_allclose(En[s, j], E[s, :, q, :],
                                           atol=1e-10 * scale)
                jj = int(np.nonzero(np.argmax(oh[s], axis=-1) == q)[0][0])
                np.testing.assert_allclose(En[s, j],
                                           np.asarray(co.Eb_nbr)[s, jj],
                                           atol=1e-10 * scale)


@pytest.mark.parametrize("kind", ["inv", "lu"])
def test_interop_round_trip_of_a_c128_oras_state(kind, jax_oras):
    """A JAX c128 ORAS state (its optimized matrices' inverse, or their LU
    with the 0-based pivots) carried into the port: apply and gmv within
    1e-12 of the JAX package's, and the JAX package's count."""
    import dataclasses

    from hpddm_tpu.core.formats import pack_local_matrices as jax_pack
    from hpddm_tpu.ops.local_solve import factorize as jax_factorize
    from hpddm_tpu.precond import schwarz as jax_sz

    jstate = jax_oras["state"]
    arrays = jax_state_arrays(jstate)
    if kind == "lu":
        gen = jax_h.generate(S, Nx=NX, Ny=NX, k=K, eps=0.0)
        A = jax_pack(gen.oras_mats, n_max=jstate.dec.n_max, fmt="dense")
        lu = jax_factorize(A.values, "lu")
        arrays.update(local_kind="lu", factor=np.asarray(lu.factor),
                      aux=np.asarray(lu.aux))
        jstate = dataclasses.replace(jstate, solver=lu)
    state = interop.state_from_numpy(arrays, device="cpu")
    assert state.A.values.dtype == torch.complex128
    assert state.dec.d.dtype == torch.float64 and state.solver.kind == kind
    f = jax_oras["f"]
    for fn in ("apply", "gmv"):
        want = np.asarray(getattr(jax_sz, fn)(jstate, jnp.asarray(f)))
        got = getattr(sz, fn)(state, torch.as_tensor(f)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    res = solve(state, torch.as_tensor(f), opt=Options(
        tol=1e-6, max_it=500, gmres_restart=200))
    assert res.iterations == jax_oras["its6"]


def test_multi_rhs_columns_follow_single_solves():
    """Pseudo-block GMRES on three complex right-hand sides: each column
    takes its own single-RHS count (the solver is column-independent)."""
    gen = helmholtz.generate(S, Nx=24, Ny=24, k=4.0, eps=0.3)
    sch, opt, f = _port(gen, tol=1e-8, max_it=200)
    rng = np.random.default_rng(21)
    B = rng.normal(size=(S, sch.n_max, 3)) + 1j * rng.normal(
        size=(S, sch.n_max, 3))
    B = sch.exchange_rhs(torch.as_tensor(B) * (torch.abs(f) > 0))
    state = sch.build()
    res = solve(state, B, opt=opt)
    for j in range(3):
        one = solve(state, B[:, :, j:j + 1].contiguous(), opt=opt)
        assert int(res.it_per_rhs[j]) == one.iterations
    nb, nr = sz.compute_residual(state, res.x, B)
    assert float(torch.max(nr / nb)) < 1e-7


def test_complex64_raises():
    gen = helmholtz.generate(S, Nx=16, Ny=16, k=4.0, eps=0.3,
                             dtype=np.complex64)
    with pytest.raises(TypeError, match="C11"):
        sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                   device="cpu")


def test_twin_main(capsys):
    """The twin's command line: a recycled two-wavenumber sweep and a
    solve with the lu local solver, each converged (exit 0)."""
    base = ["-N", "4", "-Nx", "24", "-k", "4", "-eps", "0.3",
            "-device", "cpu"]
    assert twin.main(base + ["-sweep", "2", "-hpddm_krylov_method",
                             "gcrodr", "-hpddm_recycle", "5"]) == 0
    assert "total iterations" in capsys.readouterr().out
    assert twin.main(base + ["-hpddm_local_solver", "lu"]) == 0
