"""Port vs JAX package: the rest of slice 5a on the CPU.

* ``-hpddm_reuse_preconditioner`` with ``update_matrices``: ``build``
  keeps the factorization and the coarse operator, and the solve of the
  updated system takes the JAX package's count (f64).
* ``statistics()`` returns the JAX package's text.
* ``exchange_matrices`` gives local matrices bitwise equal to the JAX
  package's (tests/test_matrix_exchange.py:17's case); ``restrict_pou``
  and ``restriction`` give its rounded partition of unity, exactly, in
  both layouts; at a small size the setup-scale case's gates hold (the
  rounded POU is boolean and sums to 1 on every dof).
* ``-hpddm_geneo_estimate_nu`` gives the JAX package's per-subdomain
  counts (tests/test_features.py:137's case).
* The dumps: ``dump_matrices`` files are byte-equal to the JAX package's;
  ``dump_eigenvectors`` and ``-hpddm_level_2_dump_matrix`` files have
  its layout, line for line, and values within 1e-10 (eigenvalues,
  relative), 1e-8 (eigenvectors, each column up to its sign: two
  eigensolvers) and 1e-12 (E, relative to its largest entry: another
  summation order), and each reads back (``MatrixCSR.from_file``,
  ``np.loadtxt``) equal to the state it came from.
* ``-hpddm_gmv_dtype bfloat16``: the gmv is within rtol 1e-6 of the JAX
  package's in f32, also on its state carried by ``interop``
  (``A_values_lp``), and differs from the full-precision one by (0, 1e-2);
  the assembled E reads the mirror in both packages (ROADMAP C14) and
  agrees to 1e-12 in f64; a two-level solve takes the JAX package's
  count.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from hpddm_tpu.core.csr import MatrixCSR as JaxCSR
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.parallel.decomposition import restrict_pou as jax_restrict
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel.decomposition import restrict_pou
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve
from test_torch_schwarz import jax_state_arrays

S = 4
TWO_LEVEL = dict(schwarz_coarse_correction="deflated", geneo_nu=4)


def _rhs(gen, n_max, dtype=np.float64):
    f = np.zeros((len(gen.n_loc), n_max, 1), dtype=dtype)
    for s in range(len(gen.n_loc)):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return f


def _scaled(mats, c, csr):
    return [csr(m.scipy() * c) for m in mats]


@pytest.fixture(scope="module")
def reuse(tmp_path_factory):
    """40x40, S=4, GenEO nu=4, deflated, with reuse_preconditioner=1 and
    the three dumps, in both packages: GenEO, a build, a solve,
    update_matrices with the matrices scaled by 1.001, a build and a
    solve. The port builds on the JAX package's GenEO vectors
    (``set_vectors``, after its own GenEO has dumped its pairs): an
    eigenvector's sign is arbitrary, and E is then the same matrix."""
    tmp = tmp_path_factory.mktemp("dumps")
    jgen = jax_d2.generate(S, 40, 40, overlap=1, with_neumann=True)
    gen = diffusion2d.generate(S, 40, 40, overlap=1, with_neumann=True)
    out = {}
    for name, mod, g, opts, csr in (
            ("jax", jax_sz, jgen, JaxOptions, JaxCSR),
            ("port", sz, gen, Options, MatrixCSR)):
        opt = opts(reuse_preconditioner=1,
                   dump_matrices=str(tmp / f"{name}_mat"),
                   dump_eigenvectors=str(tmp / f"{name}_eig"),
                   level_2_dump_matrix=str(tmp / f"{name}_E.txt"),
                   **TWO_LEVEL)
        kw = {} if name == "jax" else dict(device="cpu")
        sch = mod.Schwarz(g.mats, g.neighbors, g.mappings, d=g.d,
                          options=opt, **kw)
        sch.solve_gevp(g.neumann)
        if name == "port":
            sch.set_vectors(out["jax"]["sch"]._deflation_vectors)
        st1 = sch.build()
        f = _rhs(gen, sch.n_max)
        fx = jnp.asarray(f) if name == "jax" else torch.from_numpy(f)
        run = jax_solve if name == "jax" else solve
        its1 = int(run(st1, fx, opt=opt).iterations)
        sch.update_matrices(_scaled(g.mats, 1.001, csr))
        st2 = sch.build()
        res2 = run(st2, fx, opt=opt)
        out[name] = dict(sch=sch, st1=st1, st2=st2, its1=its1,
                         its2=int(res2.iterations), x2=np.asarray(res2.x),
                         f=fx, gen=g)
    out["tmp"] = tmp
    return out


def test_reuse_keeps_factorization_and_coarse_operator(reuse):
    for name in ("jax", "port"):
        r = reuse[name]
        assert r["st2"].solver is r["st1"].solver, name
        assert r["st2"].coarse is r["st1"].coarse, name
        assert r["st2"].A is r["sch"].A and r["st2"].A is not r["st1"].A
    p, j = reuse["port"], reuse["jax"]
    assert p["its1"] == j["its1"] and p["its2"] == j["its2"], \
        (p["its1"], j["its1"], p["its2"], j["its2"])
    nb, nr = sz.compute_residual(p["st2"], torch.from_numpy(p["x2"]),
                                 p["f"])
    assert float(nr[0] / nb[0]) < 1e-6
    np.testing.assert_allclose(p["x2"], j["x2"], rtol=0, atol=1e-8)


def test_build_keeps_no_state_without_reuse():
    """Without -hpddm_reuse_preconditioner a build keeps nothing: each
    build factorizes anew, and the option set after such a build reuses
    from the next build on (the JAX package keeps every state, so there
    the first build after the option is set already reuses)."""
    gen = diffusion2d.generate(S, 40, 40, overlap=1)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(), device="cpu")
    a, b = sch.build(), sch.build()
    assert b.solver is not a.solver
    sch.opt["reuse_preconditioner"] = 1
    c = sch.build()
    assert c.solver is not b.solver and sch.build().solver is c.solver


def test_statistics_text_equals_jax(reuse):
    got = reuse["port"]["sch"].statistics()
    assert got == reuse["jax"]["sch"].statistics()
    assert "4 subdomains" in got and "1600" in got


def test_dump_matrices_byte_equal_jax(reuse):
    """Written at each full build: the second build reused the factors,
    so the files hold the first matrices."""
    tmp = reuse["tmp"]
    gen = reuse["port"]["gen"]
    for s in range(S):
        got = (tmp / f"port_mat_{s}.txt").read_bytes()
        assert got == (tmp / f"jax_mat_{s}.txt").read_bytes(), s
        back = MatrixCSR.from_file(str(tmp / f"port_mat_{s}.txt"))
        assert (back.scipy() != gen.mats[s].scipy()).nnz == 0


def _read_eig(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    lam = np.array([float(v) for v in lines[1].split()])
    V = np.loadtxt(path, skiprows=2, ndmin=2)
    return lines, lam, V


def test_dump_eigenvectors_layout_and_values_match_jax(reuse):
    tmp = reuse["tmp"]
    sch = reuse["port"]["sch"]
    for s in range(S):
        lines, lam, V = _read_eig(tmp / f"port_eig_{s}.txt")
        jlines, jlam, jV = _read_eig(tmp / f"jax_eig_{s}.txt")
        assert lines[0] == jlines[0] and len(lines) == len(jlines)
        assert V.shape == jV.shape == (sch.mats[s].n, 4)
        np.testing.assert_allclose(lam, jlam, rtol=1e-10)
        sign = np.sign(np.sum(V * jV, axis=0))
        np.testing.assert_allclose(V * sign, jV, rtol=0, atol=1e-8)


def test_dump_eigenpairs_writes_jax_bytes(tmp_path):
    """Given the same pairs, the port's writer and the JAX package's
    write the same bytes (the JAX writer is inline in its solve_gevp, so
    its body is reproduced here from hpddm_tpu/precond/schwarz.py:923-934
    on the same arrays)."""
    rng = np.random.default_rng(7)
    lam, V = rng.normal(size=3), rng.normal(size=(11, 3))
    sz.dump_eigenpairs(str(tmp_path / "p.txt"), lam, V)
    with open(tmp_path / "j.txt", "w") as fh:
        fh.write("# GenEO eigenpairs (lambda then vector columns)\n")
        fh.write(" ".join(f"{v:.15e}" for v in lam) + "\n")
        np.savetxt(fh, V)
    assert (tmp_path / "p.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def test_level_2_dump_matrix_matches_jax(reuse):
    """-hpddm_level_2_dump_matrix on the dense-assembled E: the same
    header and (i, j) pattern as the JAX package's file, values within
    1e-12 of its largest entry; the file reads back as the state's E."""
    tmp = reuse["tmp"]
    plines = (tmp / "port_E.txt").read_text().splitlines()
    jlines = (tmp / "jax_E.txt").read_text().splitlines()
    assert plines[:3] == jlines[:3]
    assert [ln.split()[:2] for ln in plines[3:]] == \
        [ln.split()[:2] for ln in jlines[3:]]
    got = MatrixCSR.from_file(str(tmp / "port_E.txt")).scipy().toarray()
    ref = MatrixCSR.from_file(str(tmp / "jax_E.txt")).scipy().toarray()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    E_inv = reuse["port"]["st1"].coarse.E_inv.numpy()
    np.testing.assert_allclose(got @ E_inv, np.eye(len(got)), atol=1e-8)


def _dirty(gen, clean, rng):
    dirty = []
    for s in range(S):
        A = clean[s].copy().tolil()
        for r in np.nonzero(np.asarray(gen.d[s]) < 1e-12)[0]:
            cols = clean[s][r].indices
            A[r, cols] = rng.normal(size=len(cols))
        dirty.append(sp.csr_matrix(A))
    return dirty


@pytest.mark.parametrize("renumber", [False, True])
def test_exchange_matrices_bitwise_equal_jax(renumber):
    """tests/test_matrix_exchange.py:17's case (48x48, S=4, overlap 2, the
    non-owned overlap rows corrupted): the exchanged local matrices equal
    the JAX package's bitwise, in both layouts, and carry the owners'
    values on every shared block."""
    gen = diffusion2d.generate_uniform(S, 48, 48, overlap=2)
    clean = [m.scipy(expand=True).tocsr() for m in gen.mats]
    dirty = _dirty(gen, clean, np.random.default_rng(0))
    jsch = jax_sz.Schwarz([JaxCSR(a) for a in dirty], gen.neighbors,
                          gen.mappings, d=gen.d, renumber=renumber)
    sch = sz.Schwarz([MatrixCSR(a) for a in dirty], gen.neighbors,
                     gen.mappings, d=gen.d, renumber=renumber, device="cpu")
    jsch.exchange_matrices()
    sch.exchange_matrices()
    for s in range(S):
        got = sch.mats[s].scipy(expand=True).tocsr()
        ref = jsch.mats[s].scipy(expand=True).tocsr()
        for a, b in ((got.indptr, ref.indptr), (got.indices, ref.indices),
                     (got.data, ref.data)):
            np.testing.assert_array_equal(a, b)
        for idx in gen.mappings[s]:
            np.testing.assert_allclose(got[idx][:, idx].toarray(),
                                       clean[s][idx][:, idx].toarray(),
                                       atol=1e-12)


@pytest.mark.parametrize("renumber", [False, True])
def test_restriction_equals_jax(renumber):
    """restrict_pou and Schwarz.restriction give the JAX package's rounded
    POU (tests/test_matrix_exchange.py:68's case, 32x32, S=4, overlap 2),
    exactly, and a consistent 1 stays 1 under the scaled exchange."""
    gen = diffusion2d.generate_uniform(S, 32, 32, overlap=2)
    d_got = [np.asarray(d, dtype=np.float64).copy() for d in gen.d]
    d_ref = [d.copy() for d in d_got]
    assert restrict_pou(gen.neighbors, gen.mappings, d_got) is True
    assert jax_restrict(gen.neighbors, gen.mappings, d_ref) is True
    for a, b in zip(d_got, d_ref):
        np.testing.assert_array_equal(a, b)
    assert restrict_pou(gen.neighbors, gen.mappings, d_got) is False
    jsch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                          renumber=renumber)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     renumber=renumber, device="cpu")
    assert sch.restriction() is True and jsch.restriction() is True
    np.testing.assert_array_equal(sch.dec.d.numpy(), np.asarray(jsch.dec.d))
    assert sch.restriction() is False
    ones = torch.ones((S, sch.n_max, 1), dtype=torch.float64)
    out = sch.exchange_rhs(ones).numpy()
    np.testing.assert_allclose(out[sch.dec.row_mask.numpy()], 1.0,
                               atol=1e-12)


def test_setup_scale_case_small():
    """tests/test_matrix_exchange.py:87's case at 128x128, S=16 (the card
    runs 1024x1024, smoke phase 22 (c)): after exchange_matrices and
    restriction the POU is boolean and sums to 1 on every global dof,
    and the local matrices equal the JAX package's."""
    S16, N = 16, 128
    gen = diffusion2d.generate_uniform(S16, N, N, overlap=2)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     device="cpu")
    jsch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d)
    for s in (sch, jsch):
        s.exchange_matrices()
        assert s.restriction() is True
    d = sch.dec.d.numpy()
    dsum = np.zeros(N * N)
    for s, (i0, i1, j0, j1) in enumerate(gen.boxes):
        vals = d[s, : gen.n_loc[s]]
        assert np.all((vals == 0) | (vals == 1))
        jj, ii = np.meshgrid(np.arange(j0, j1), np.arange(i0, i1),
                             indexing="ij")
        np.add.at(dsum, (jj * N + ii).ravel(), vals)
    np.testing.assert_array_equal(dsum, 1.0)
    np.testing.assert_array_equal(d, np.asarray(jsch.dec.d))
    for a, b in zip(sch.mats, jsch.mats):
        assert (a.scipy() != b.scipy()).nnz == 0


def test_geneo_estimate_nu_counts_equal_jax(capsys):
    """tests/test_features.py:137's case: 40x40, S=4, geneo_nu=2,
    threshold 0.4, estimate_nu=1: the per-subdomain counts equal the JAX
    package's and pass geneo_nu; the verbosity line is its text."""
    kw = dict(schwarz_coarse_correction="deflated", geneo_nu=2,
              geneo_threshold=0.4, geneo_estimate_nu=1, verbosity=1)
    jgen = jax_d2.generate(S, 40, 40, overlap=1, with_neumann=True)
    gen = diffusion2d.generate(S, 40, 40, overlap=1, with_neumann=True)
    ref = jax_sz.Schwarz(jgen.mats, jgen.neighbors, jgen.mappings, d=jgen.d,
                         options=JaxOptions(**kw)).solve_gevp(jgen.neumann)
    jline = capsys.readouterr().out
    got = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(**kw), device="cpu"
                     ).solve_gevp(gen.neumann)
    assert capsys.readouterr().out == jline
    assert "GenEO estimate_nu" in jline
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert int(np.max(got)) > 2


@pytest.fixture(scope="module")
def bf16_grid():
    """tests/test_spmv.py:136's cell: generate_uniform 64x64, S=4,
    overlap 1, with the grid geometry attached (the JAX package's canvas
    form on its mirror planes; the port's flat form on its mirror)."""
    gen = diffusion2d.generate_uniform(S, 64, 64, overlap=1,
                                       dtype=np.float32, with_neumann=True)
    return gen


def _pair(gen, opts, N=64):
    j = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                       options=JaxOptions(**opts))
    p = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                   options=Options(**opts), device="cpu")
    for s in (j, p):
        s.set_grid_geometry(gen.boxes, N, N)
    return j, p


def test_gmv_bf16_mirror_matches_jax_f32(bf16_grid):
    gen = bf16_grid
    j, p = _pair(gen, dict(gmv_dtype="bfloat16"))
    _, full = _pair(gen, {})
    assert p.A.values_lp.dtype == torch.bfloat16
    assert p.A.values.dtype == torch.float32 and p.A.canvas_hw is not None
    np.testing.assert_array_equal(
        p.A.values_lp.float().numpy(),
        np.asarray(j.A.values_lp.astype(jnp.float32)))
    x = np.random.default_rng(2).normal(size=(S, p.n_max, 1)) \
        .astype(np.float32)
    y = sz.gmv(p.operator_state(), torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_sz.gmv(j.operator_state(), jnp.asarray(x)))
    np.testing.assert_allclose(y, ref, rtol=1e-6, atol=1e-6 * np.abs(
        ref).max())
    y32 = sz.gmv(full.operator_state(), torch.from_numpy(x)).numpy()
    rel = np.linalg.norm(y - y32) / np.linalg.norm(y32)
    assert 0 < rel < 1e-2, rel
    # the JAX package's bf16 state carried over (``A_values_lp``)
    arrays = jax_state_arrays(j.operator_state())
    arrays["A_values_lp"] = np.asarray(j.A.values_lp.astype(jnp.float32))
    st = interop.state_from_numpy(arrays, device="cpu", dtype=torch.float32)
    assert st.A.values_lp.dtype == torch.bfloat16
    np.testing.assert_allclose(sz.gmv(st, torch.from_numpy(x)).numpy(), ref,
                               rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_bf16_mirror_coarse_and_solve_match_jax():
    """The mirror in f64 on a 32x32 uniform grid, S=4 (values and vectors
    f64, the mirror bf16): the Galerkin E of both packages reads the
    mirror (it differs from the full-precision E by far more than their
    1e-12 agreement: ROADMAP C14), and the deflated two-level solve on the
    JAX package's GenEO vectors takes its count; update_matrices redoes
    the mirror."""
    gen = diffusion2d.generate_uniform(S, 32, 32, overlap=1,
                                       with_neumann=True)
    opts = dict(gmv_dtype="bfloat16", **TWO_LEVEL)
    j, p = _pair(gen, opts, N=32)
    j.solve_gevp(gen.neumann)
    p.set_vectors(j._deflation_vectors)
    jst, st = j.build(), p.build()
    co = st.coarse
    nu_loc = co.nu_loc.numpy()
    E = p._assemble_E(co.Z, nu_loc, co.nu_max).numpy()
    jE = np.asarray(j._assemble_E(jst.coarse.Z, nu_loc, co.nu_max,
                                  jnp.float64))
    np.testing.assert_allclose(E, jE, rtol=0, atol=1e-12 * np.abs(jE).max())
    _, full = _pair(gen, TWO_LEVEL, N=32)
    Efull = full._assemble_E(co.Z, nu_loc, co.nu_max).numpy()
    assert np.abs(Efull - E).max() > 1e-6 * np.abs(E).max()
    f = _rhs(gen, p.n_max)
    jres = jax_solve(jst, jnp.asarray(f), opt=j.opt)
    res = solve(st, torch.from_numpy(f), opt=p.opt)
    assert res.iterations == int(jres.iterations)
    p.update_matrices(_scaled(gen.mats, 1.002, MatrixCSR))
    assert p.A.values_lp is not None and p.A.canvas_hw is not None
