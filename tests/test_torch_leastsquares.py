"""Port vs JAX package on the CPU in f64: the matrix-file and
least-squares front ends (``models/fromfile.spsd_neumann``,
``solvers/leastsquares.py``) and the example twins of
``examples/{iterative,solver,custom_operator,schwarz_from_file,
least_squares}.py``.

* ``LeastSquaresSolver`` takes the JAX package's CGLS count at the two
  cases of ``tests/test_leastsquares.py`` (one level at 24x24, S=4; one
  level and GenEO at 48x48, S=16, the coerced asm + additive
  preconditioner), its solution within the JAX test's bounds of the
  direct solve, and the coercion notice;
* ``_spsd_splitting`` and ``spsd_neumann`` give the JAX package's local
  matrices element for element; the prolongated sum of the latter is the
  matrix and each is SPSD (``tests/test_fromfile.py:149``'s
  configuration);
* each twin exits 0 on the CPU at a small size.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.models import fromfile as jax_ff
from hpddm_tpu.core.csr import MatrixCSR as JaxCSR
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.solvers import leastsquares as jax_ls

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.examples import (custom_operator, iterative,
                                      least_squares, schwarz_from_file,
                                      solver)
from hpddm_tpu_torch.models import diffusion2d, fromfile
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.solvers import leastsquares as ls


def _gradient_problem(nx, delta, seed):
    """tests/test_leastsquares.py's problem: A = [grid gradient;
    sqrt(delta) I], A^T A = Laplacian + delta I."""
    n = nx * nx
    ids = np.arange(n).reshape(nx, nx)
    hedges = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    vedges = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    edges = np.concatenate([hedges, vedges], axis=0)
    ne = len(edges)
    G = sp.csr_matrix((np.tile(np.array([-1.0, 1.0]), ne),
                       (np.repeat(np.arange(ne), 2), edges.ravel())),
                      shape=(ne, n))
    A = sp.vstack([G, np.sqrt(delta) * sp.identity(n)]).tocsr()
    return A, np.random.default_rng(seed).normal(size=A.shape[0])


def _direct(A, b):
    return spla.spsolve(sp.csr_matrix(A.T @ A).tocsc(), A.T @ b)


@pytest.mark.parametrize("nx,delta,seed,S,tol,max_it,opts,err", [
    (24, 1e-3, 0, 4, 1e-10, 400, {}, 1e-6),
    (48, 1e-4, 1, 16, 1e-8, 500, {}, 1e-5),
    (48, 1e-4, 1, 16, 1e-8, 500,
     dict(schwarz_coarse_correction="balanced", geneo_nu=8), 1e-5),
], ids=["one level 24", "one level 48", "geneo 48"])
def test_cgls_counts(nx, delta, seed, S, tol, max_it, opts, err, capsys):
    A, b = _gradient_problem(nx, delta, seed)
    theirs = jax_ls.LeastSquaresSolver(A, n_subdomains=S, overlap=2,
                                       options=JaxOptions(**opts))
    jres = theirs.solve(b, tol=tol, max_it=max_it)
    capsys.readouterr()
    mine = ls.LeastSquaresSolver(A, n_subdomains=S, overlap=2,
                                 options=Options(**opts), device="cpu")
    assert capsys.readouterr().out.count("schwarz_method -> asm") == 1
    res = mine.solve(b, tol=tol, max_it=max_it)
    assert res.iterations == jres.iterations
    assert res.rel_res <= tol
    x_ref = _direct(A, b)
    assert np.linalg.norm(res.x - x_ref) <= err * np.linalg.norm(x_ref)
    np.testing.assert_allclose(res.x, jres.x, rtol=0, atol=1e-6 * np.abs(
        jres.x).max())
    if opts:
        assert mine.opt.val("schwarz_coarse_correction") == "additive"


def test_spsd_splitting_is_the_jax_packages():
    """The contained-row splitting of A^T A, element for element."""
    A, _ = _gradient_problem(16, 1e-2, 0)
    N = sp.csr_matrix(A.T @ A)
    gen = fromfile.decompose(MatrixCSR(N), 4, overlap=2)
    jgen = jax_ff.decompose(JaxCSR(N), 4, overlap=2)
    for a, b in zip(jax_ls._spsd_splitting(A, jgen.gids),
                    ls._spsd_splitting(A, gen.gids)):
        a, b = a.scipy(expand=True), b.scipy(expand=True)
        assert np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.data, b.data)


def test_spsd_neumann():
    """tests/test_fromfile.py:149's configuration (a 60x60 5-point matrix,
    S=8, overlap 2): the JAX package's matrices element for element, the
    exact prolongated sum, SPSD, and GenEO on them cuts the count."""
    K = diffusion2d.generate(1, 60, 60, overlap=0).mats[0].scipy(expand=True)
    Kj = jax_d2.generate(1, 60, 60, overlap=0).mats[0].scipy(expand=True)
    assert (abs(K - Kj)).max() == 0
    S = 8
    gen = fromfile.decompose(MatrixCSR(sp.csr_matrix(K)), S, overlap=2)
    jgen = jax_ff.decompose(JaxCSR(sp.csr_matrix(K)), S, overlap=2)
    neu = fromfile.spsd_neumann(gen)
    for a, b in zip(jax_ff.spsd_neumann(jgen), neu):
        a, b = a.scipy(expand=True), b.scipy(expand=True)
        assert np.array_equal(a.indptr, b.indptr)
        assert np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.data, b.data)
    acc = sp.csr_matrix(K.shape)
    for s in range(S):
        g = gen.gids[s]
        R = sp.csr_matrix((np.ones(len(g)), (np.arange(len(g)), g)),
                          shape=(len(g), K.shape[0]))
        acc = acc + R.T @ neu[s].scipy(expand=True) @ R
    Ksym = (K + K.T) * 0.5
    assert abs(acc - Ksym).max() < 1e-10 * abs(Ksym).max()
    for m in neu:
        w = np.linalg.eigvalsh(m.dense(expand=True))
        assert w.min() > -1e-10 * w.max()
    from hpddm_tpu_torch.precond.schwarz import Schwarz
    from hpddm_tpu_torch.solvers.krylov import solve
    its = {}
    for cc in (None, "deflated"):
        opt = Options(tol=1e-8, **({} if cc is None else dict(
            schwarz_coarse_correction=cc, geneo_nu=8)))
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt, device="cpu")
        if cc:
            sch.solve_gevp(neu)
        f = np.zeros((S, sch.n_max, 1))
        for s in range(S):
            f[s, : gen.n_loc[s]] = gen.f[s]
        its[cc] = solve(sch.build(), torch.as_tensor(f), opt=opt).iterations
    assert its["deflated"] < its[None] and its["deflated"] <= 16


@pytest.mark.parametrize("driver,argv", [
    (iterative, []),
    (solver, []),
    (custom_operator, ["-n", "60", "-S", "3"]),
    (custom_operator, ["-n", "60", "-S", "3", "-hpddm_krylov_method",
                       "bgmres"]),
    (schwarz_from_file, ["-N", "4", "-overlap", "2"]),
    (schwarz_from_file, ["-N", "4", "-overlap", "2",
                         "-hpddm_schwarz_coarse_correction", "deflated",
                         "-hpddm_geneo_nu", "6"]),
    (least_squares, ["-N", "4", "-Nx", "16"]),
    (least_squares, ["-N", "4", "-Nx", "16",
                     "-hpddm_schwarz_coarse_correction", "additive",
                     "-hpddm_geneo_nu", "4"]),
], ids=["iterative", "solver", "custom_operator", "custom_operator bgmres",
        "schwarz_from_file", "schwarz_from_file geneo", "least_squares",
        "least_squares geneo"])
def test_twins_exit_zero(driver, argv):
    assert driver.main(argv + ["-device", "cpu"]) == 0


def test_schwarz_from_file_reads_a_file(tmp_path):
    """The file path of the twin: a dumped matrix and a right-hand side."""
    path = str(tmp_path / "m.txt")
    diffusion2d.generate(1, 30, 30).mats[0].dump(path)
    rhs = str(tmp_path / "rhs.txt")
    np.savetxt(rhs, np.ones(900))
    assert schwarz_from_file.main(["-matrix_filename", path,
                                   "-rhs_filename", rhs, "-N", "3",
                                   "-device", "cpu"]) == 0
