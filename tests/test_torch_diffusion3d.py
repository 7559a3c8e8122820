"""Port vs JAX package: the 3D diffusion model on the CPU in f64 (slice 5b).

* ``diffusion3d.generate_uniform`` (with and without kappa, Neumann
  matrices and random right-hand sides), ``assemble_global`` and
  ``diffusion2d.generate_single`` are byte-equal to the JAX package's.
* gmv on the uniform boxes (DIA, 7 diagonals) equals the assembled
  7-point operator (``tests/test_diffusion3d.py:23``).
* Iteration counts equal the JAX package's: heterogeneous two-level GenEO
  against one-level, with the solution against ``spsolve``
  (``tests/test_diffusion3d.py:42``), the block-sparse coarse assembly on
  the 26-neighbour adjacency (``:87``), and plane-blocked banded local
  solves, which take ``inv``'s count (``tests/test_banded.py:130``).
* The driver twins of ``examples/{elasticity,diffusion3d}.py`` run at
  the JAX package's ``tests/test_examples.py`` arguments.

The JAX package's solves run op by op (``jax.disable_jit``: the same
arithmetic, no compile of its loops per solve).
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.models import diffusion3d as jax_d3
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch.examples import diffusion3d as d3_driver
from hpddm_tpu_torch.examples import elasticity as elast_driver
from hpddm_tpu_torch.models import diffusion2d, diffusion3d
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve


D3_ARGS = ["-N", "8", "-Nx", "16", "-contrast", "1e3",
           "-hpddm_schwarz_coarse_correction", "deflated",
           "-hpddm_geneo_nu", "6"]


def kappa(x, y, z):
    """The checkerboard of ``tests/test_diffusion3d.py:46-48``."""
    return np.where((np.floor(x / 2.5) + np.floor(y / 2.5)
                     + np.floor(z / 2.5)) % 2 == 0, 1.0, 1.0e3)


def _csr_bytes(m):
    c = m.scipy(expand=False)
    return tuple(np.ascontiguousarray(getattr(c, k)).tobytes()
                 for k in ("data", "indices", "indptr")) + (c.shape,)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(size_world=8, Nx=16, Ny=16, Nz=16),
    dict(size_world=12, Nx=12, Ny=12, Nz=12, overlap=1, kappa=kappa,
         with_neumann=True),
    dict(size_world=4, Nx=12, Ny=12, Nz=14, overlap=2, mu=3,
         with_neumann=True, dtype=np.float32),
    dict(size_world=1, Nx=6, Ny=5, Nz=4, kappa=kappa, with_neumann=True),
], ids=["plain", "kappa-neumann", "overlap2-mu3-f32", "one-box"])
def test_generate_uniform_is_byte_equal(kw):
    got, want = (m.generate_uniform(**kw) for m in (diffusion3d, jax_d3))
    assert [_csr_bytes(m) for m in got.mats] == \
        [_csr_bytes(m) for m in want.mats]
    if kw.get("with_neumann"):
        assert [_csr_bytes(m) for m in got.neumann] == \
            [_csr_bytes(m) for m in want.neumann]
    else:
        assert got.neumann is None and want.neumann is None
    assert got.neighbors == want.neighbors and got.n_loc == want.n_loc
    assert got.grid == want.grid and got.boxes == want.boxes
    for a, b in zip(got.mappings, want.mappings):
        assert len(a) == len(b) and all(map(_same, a, b))
    for key in ("d", "f", "gids"):
        assert all(map(_same, getattr(got, key), getattr(want, key))), key
    assert diffusion3d._grid3_of(kw["size_world"]) == \
        jax_d3._grid3_of(kw["size_world"])


@pytest.mark.parametrize("k", [None, kappa])
def test_assemble_global_is_byte_equal(k):
    (A, f), (jA, jf) = (m.assemble_global(10, 8, 6, kappa=k)
                        for m in (diffusion3d, jax_d3))
    for key in ("data", "indices", "indptr"):
        assert _same(getattr(A, key), getattr(jA, key))
    assert _same(f, jf)


def test_generate_single_is_byte_equal():
    got, want = (m.generate_single(30, 20, sym=True, mu=2)
                 for m in (diffusion2d, jax_d2))
    assert [_csr_bytes(m) for m in got.mats] == \
        [_csr_bytes(m) for m in want.mats]
    assert got.n_loc == want.n_loc == [600]
    assert all(map(_same, got.f, want.f)) and all(map(_same, got.d, want.d))


@pytest.mark.parametrize("S,N", [(8, 16), (4, 12), (2, 10)])
def test_gmv_exactness_3d(S, N):
    gen = diffusion3d.generate_uniform(S, N, N, N, overlap=1)
    A, _ = diffusion3d.assemble_global(N, N, N)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     device="cpu")
    assert len(sch.A.offsets) == 7
    g = np.random.default_rng(0).normal(size=N ** 3)
    x = np.zeros((S, sch.n_max, 1))
    for s in range(S):
        x[s, : gen.n_loc[s], 0] = g[gen.gids[s]]
    y = sz.gmv(sch.operator_state(), torch.as_tensor(x)).numpy()
    ref = A @ g
    for s in range(S):
        np.testing.assert_allclose(y[s, : gen.n_loc[s], 0],
                                   ref[gen.gids[s]], atol=1e-9)


def _pack(gen, n_max):
    f = np.zeros((len(gen.mats), n_max, 1))
    for s in range(len(gen.mats)):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return f


def _both(jgen, gen, kw, gevp=True, shapes=None):
    """{pkg: (iterations, x (S, n_max, 1), recomputed relres)} of one solve
    on each package's own setup."""
    out = {}
    for pkg in ("jax", "port"):
        g = jgen if pkg == "jax" else gen
        if pkg == "jax":
            sch = jax_sz.Schwarz(g.mats, g.neighbors, g.mappings, d=g.d,
                                 options=JaxOptions(**kw))
        else:
            sch = sz.Schwarz(g.mats, g.neighbors, g.mappings, d=g.d,
                             options=Options(**kw), device="cpu")
        if shapes is not None:
            sch.set_banded_shapes(shapes)
        f = _pack(g, sch.n_max)
        f = jnp.asarray(f) if pkg == "jax" else torch.as_tensor(f)
        if gevp:
            sch.solve_gevp(g.neumann)
        state = sch.build()
        assert kw.get("coarse_assembly") != "bsr" or \
            state.coarse.mode == "bsr"
        if pkg == "jax":
            with jax.disable_jit():
                res = jax_solve(state, f, opt=sch.opt)
            nb, nr = jax_sz.compute_residual(state, res.x, f)
        else:
            res = solve(state, f, opt=sch.opt)
            nb, nr = sz.compute_residual(state, res.x, f)
        out[pkg] = (int(res.iterations), np.asarray(res.x),
                    float(np.asarray(nr)[0] / np.asarray(nb)[0]))
    return out


@pytest.fixture(scope="module")
def hetero():
    return [m.generate_uniform(8, 16, 16, 16, overlap=1, kappa=kappa,
                               with_neumann=True) for m in (jax_d3,
                                                            diffusion3d)]


def test_two_level_geneo_3d_counts_equal_jax(hetero):
    """One-level and GenEO nu=8 counts equal the JAX package's, GenEO cuts
    them, and the two-level solution matches the global direct solve
    (``tests/test_diffusion3d.py:42``)."""
    jgen, gen = hetero
    its = {}
    for nu in (0, 8):
        kw = dict(tol=1e-8, max_it=200)
        if nu:
            kw.update(schwarz_coarse_correction="deflated", geneo_nu=nu)
        r = _both(jgen, gen, kw, gevp=bool(nu))
        assert r["port"][0] == r["jax"][0], (nu, r["port"][0], r["jax"][0])
        assert r["port"][2] < 1e-6
        its[nu] = r["port"][0]
    assert its[8] < its[0], its
    A, fg = diffusion3d.assemble_global(16, 16, 16, kappa=kappa)
    x_direct = spla.spsolve(A.tocsc(), fg)
    x = r["port"][1]
    for s in range(len(gen.mats)):
        np.testing.assert_allclose(x[s, : gen.n_loc[s], 0],
                                   x_direct[gen.gids[s]], rtol=1e-4,
                                   atol=1e-6 * np.abs(x_direct).max())


def test_bsr_coarse_3d_counts_equal_jax():
    """The block-sparse coarse assembly on the 26-neighbour adjacency of
    the 2x2x2 boxes with a nested level-2 solve at tol 1e-8
    (``tests/test_diffusion3d.py:87``)."""
    jgen, gen = (m.generate_uniform(8, 16, 16, 16, overlap=1,
                                    with_neumann=True)
                 for m in (jax_d3, diffusion3d))
    assert all(len(n) == 7 for n in gen.neighbors)
    kw = dict(tol=1e-8, max_it=200, schwarz_coarse_correction="deflated",
              geneo_nu=4, coarse_assembly="bsr", level_2_tol=1e-8)
    r = _both(jgen, gen, kw)
    assert r["port"][0] == r["jax"][0] <= 60, (r["port"][0], r["jax"][0])
    assert r["port"][2] < 1e-6


def test_banded_3d_plane_blocked_counts_equal_inv_and_jax():
    """Plane-major boxes make the 7-point operator block-tridiagonal in
    z-planes: the banded solve on (wz, wx wy) shapes takes ``inv``'s count,
    and each equals the JAX package's (``tests/test_banded.py:130``)."""
    jgen, gen = (m.generate_uniform(8, 16, 16, 16, overlap=1)
                 for m in (jax_d3, diffusion3d))
    shapes = [(k1 - k0, (i1 - i0) * (j1 - j0))
              for (i0, i1, j0, j1, k0, k1) in gen.boxes]
    its = {}
    for kind in ("inv", "banded"):
        r = _both(jgen, gen, dict(tol=1e-8, max_it=200, local_solver=kind),
                  gevp=False, shapes=shapes if kind == "banded" else None)
        assert r["port"][0] == r["jax"][0], (kind, r)
        assert r["port"][2] < 1e-6
        its[kind] = r["port"][0]
    assert its["banded"] == its["inv"], its


@pytest.mark.parametrize("driver,args", [
    (elast_driver, ["-N", "4", "-Nx", "16",
                    "-hpddm_schwarz_coarse_correction", "deflated",
                    "-hpddm_geneo_nu", "6"]),
    (elast_driver, ["-N", "4", "-Nx", "8", "-dim", "3",
                    "-hpddm_schwarz_coarse_correction", "deflated",
                    "-hpddm_geneo_nu", "8"]),
    (d3_driver, D3_ARGS),
    (d3_driver, D3_ARGS + ["-hpddm_local_solver", "banded"]),
], ids=["elasticity-dim2", "elasticity-dim3", "diffusion3d",
        "diffusion3d-banded"])
def test_driver_twins_run_on_the_cpu(driver, args):
    """The driver twins at ``tests/test_examples.py:63-71``'s arguments
    (3D diffusion also with banded local solves on the plane-blocked
    shapes) exit 0."""
    assert driver.main(args + ["-device", "cpu"]) == 0
