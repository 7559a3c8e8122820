"""Port vs JAX package: the interface-first layout (``renumber=True``) on
the CPU, in f64.

* The decomposition's permutation and its permuted per-dof arrays equal
  the JAX package's, element for element.
* The renumbered exchange and scaled exchange equal the JAX package's
  renumbered ones bitwise (the partner sums run in the same order), and
  the caller-numbering ones to 1e-13 (another order of the same sums).
* ``permute``/``unpermute`` round-trip exactly.
* Two-level solves take the JAX package's iteration count in both
  layouts, and the two layouts' solutions agree to 1e-8
  (``tests/test_renumbering.py``); the renumbered unstructured cases of
  ``tests/test_unstructured.py`` (dense GenEO, and RCM banded factors with
  Lanczos GenEO) take its counts at 60x60, S=8.
* ``global_mapping`` and ``distributed_csr`` equal the JAX package's
  (``tests/test_globalmapping.py``); ``zero_pad`` zeroes the pads only.
* The host refinement (``solve_refined``, ``true_relres``) reads f, x and
  the local matrices in the caller's numbering in both layouts.
* A JAX-built renumbered state carried by ``interop.state_from_numpy``
  gives the JAX package's ``gmv`` and ``apply`` to 1e-14.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.models import unstructured as jax_un
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.parallel import ops as jax_ops
from hpddm_tpu.parallel.decomposition import Decomposition as JaxDec
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.models import diffusion2d, unstructured
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel import ops
from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve
from hpddm_tpu_torch.solvers.refine import solve_refined, true_relres
from test_torch_schwarz import jax_state_arrays

DEC_ARRAYS = ("perm", "iperm", "d", "mult", "ov_mask", "if_idx", "if_gid",
              "if_mask", "inv_map", "is_if", "partners", "n_loc")


def _rhs(gen, n_max):
    f = np.zeros((len(gen.n_loc), n_max, 1))
    for s in range(len(gen.n_loc)):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return f


@pytest.fixture(scope="module")
def decs():
    gen = diffusion2d.generate(4, 24, 24, overlap=2)
    args = (gen.neighbors, gen.mappings, gen.n_loc)
    return dict(
        gen=gen,
        jax={r: JaxDec.from_subdomains(*args, d=gen.d, renumber=r)
             for r in (False, True)},
        port={r: Decomposition.from_subdomains(*args, d=gen.d, renumber=r,
                                               device="cpu")
              for r in (False, True)})


def test_decomposition_arrays_equal_jax(decs):
    ref, got = decs["jax"][True], decs["port"][True]
    assert got.renumbered and ref.renumbered
    for key in DEC_ARRAYS:
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)
    for key in ("S", "n_max", "m_max", "n_if", "n_global", "k_max",
                "sub_shifts"):
        assert getattr(got, key) == getattr(ref, key), key
    assert got.pexch is None and got.grid is None


@pytest.mark.parametrize("mu", [1, 2])
def test_exchange_bitwise_equal_jax(decs, mu):
    gen = decs["gen"]
    dj, dp = decs["jax"][True], decs["port"][True]
    rng = np.random.default_rng(mu)
    x = np.zeros((4, dp.n_max, mu))
    for s in range(4):
        x[s, : gen.n_loc[s]] = rng.normal(size=(gen.n_loc[s], mu))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for fn_j, fn_p in ((jax_ops.exchange, ops.exchange),
                       (jax_ops.scaled_exchange, ops.scaled_exchange)):
        ref = np.asarray(fn_j(dj, dj.permute(xj)))
        got = fn_p(dp, dp.permute(xt))
        np.testing.assert_array_equal(got.numpy(), ref)
        caller = fn_p(decs["port"][False], xt).numpy()
        np.testing.assert_allclose(dp.unpermute(got).numpy(), caller,
                                   rtol=0, atol=1e-13)
    assert torch.equal(dp.unpermute(dp.permute(xt)), xt)
    assert torch.equal(dp.permute(dp.unpermute(xt)), xt)
    assert torch.equal(dp.unpermute(dp.permute(xt[:, :, 0])), xt[:, :, 0])


def test_permute_host_equals_jax(decs):
    gen = decs["gen"]
    dj, dp = decs["jax"][True], decs["port"][True]
    rng = np.random.default_rng(3)
    for s in range(4):
        v = rng.normal(size=(gen.n_loc[s], 3))
        np.testing.assert_array_equal(dp.permute_host(v, s),
                                      dj.permute_host(v, s))
        assert decs["port"][False].permute_host(v, s) is v


def test_global_mapping_and_distributed_csr_equal_jax():
    gen = diffusion2d.generate(4, 20, 20, overlap=1)
    args = (gen.neighbors, gen.mappings, gen.n_loc)
    jdec = JaxDec.from_subdomains(*args, d=gen.d)
    gids, n_glob = Decomposition.global_mapping(*args)
    ref_gids, ref_n = jdec.global_mapping(*args)
    assert n_glob == ref_n == 400
    for a, b in zip(gids, ref_gids):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    d_list = [np.asarray(gen.d[s]) for s in range(4)]
    got = Decomposition.distributed_csr(gen.mats, gids, d_list, n_glob)
    ref = JaxDec.distributed_csr(gen.mats, ref_gids, d_list, ref_n)
    got.sort_indices()
    ref.sort_indices()
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data)


def test_zero_pad_equals_jax():
    gen = diffusion2d.generate(4, 21, 17, overlap=1)
    args = (gen.neighbors, gen.mappings, gen.n_loc)
    jdec = JaxDec.from_subdomains(*args, d=gen.d, renumber=True)
    pdec = Decomposition.from_subdomains(*args, d=gen.d, renumber=True,
                                         device="cpu")
    assert len(set(gen.n_loc)) > 1             # some subdomains have pads
    x = np.random.default_rng(4).normal(size=(4, pdec.n_max, 2)) + 1.0
    got = pdec.zero_pad(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdec.zero_pad(
        jnp.asarray(x))))
    assert (got[~pdec.row_mask.numpy()] == 0).all()


@pytest.fixture(scope="module")
def grid_solves():
    """The two-level solve of tests/test_renumbering.py (40x40, S=4, dense
    GenEO nu=4, deflated GMRES) in both layouts in the port, and in the
    interface-first layout in the JAX package (whose own test holds its
    two layouts to one count)."""
    S = 4
    jgen = jax_d2.generate(S, 40, 40, overlap=1, with_neumann=True)
    gen = diffusion2d.generate(S, 40, 40, overlap=1, with_neumann=True)
    jopt = JaxOptions(schwarz_coarse_correction="deflated", geneo_nu=4)
    jsch = jax_sz.Schwarz(jgen.mats, jgen.neighbors, jgen.mappings,
                          d=jgen.d, options=jopt, renumber=True)
    jsch.solve_gevp(jgen.neumann)
    jstate = jsch.build()
    f = _rhs(gen, jsch.n_max)
    jres = jax_solve(jstate, jnp.asarray(f), opt=jopt)
    out = {}
    for renum in (False, True):
        opt = Options(schwarz_coarse_correction="deflated", geneo_nu=4)
        sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=opt, renumber=renum, device="cpu")
        sch.solve_gevp(gen.neumann)
        state = sch.build()
        res = solve(state, torch.from_numpy(f), opt=opt)
        nb, nr = sz.compute_residual(state, res.x, torch.from_numpy(f))
        out[renum] = dict(jits=int(jres.iterations), its=res.iterations,
                          jx=np.asarray(jres.x), x=res.x.numpy(),
                          rel=float(nr[0] / nb[0]), jstate=jstate,
                          state=state, f=f, gen=gen, opt=opt)
    return out


def test_two_level_counts_equal_jax_both_layouts(grid_solves):
    for renum in (False, True):
        r = grid_solves[renum]
        assert r["its"] == r["jits"], (renum, r["its"], r["jits"])
        assert r["rel"] < 1e-6
    assert grid_solves[True]["its"] == grid_solves[False]["its"]
    np.testing.assert_allclose(grid_solves[True]["x"],
                               grid_solves[False]["x"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(grid_solves[True]["x"],
                               grid_solves[True]["jx"], rtol=0, atol=1e-8)


def test_host_refinement_in_caller_numbering(grid_solves):
    """``true_relres`` and ``solve_refined`` on the interface-first layout
    give the caller-numbered layout's residual of the same x (1e-10), and
    refine to the same solution (1e-9). d and if_idx are mapped back
    through perm on the host; the JAX package's ``solve_refined`` reads
    them unmapped (ROADMAP C15), so it has no renumbered case to hold."""
    gen, f = grid_solves[False]["gen"], grid_solves[False]["f"]
    x0 = grid_solves[False]["x"]
    rel, xr = {}, {}
    for renum in (False, True):
        r = grid_solves[renum]
        rel[renum] = true_relres(gen.mats, f, r["state"].dec, x0)
        xr[renum], info = solve_refined(
            lambda b, r=r: solve(r["state"], b, opt=r["opt"]), gen.mats, f,
            r["state"].dec, tol=1e-10)
        assert info["history"][-1] <= 1e-10, (renum, info["history"])
    assert 0 < rel[False] < 1e-6
    np.testing.assert_allclose(rel[True], rel[False], rtol=1e-10)
    np.testing.assert_allclose(xr[True], xr[False], rtol=0, atol=1e-9)


def test_state_from_numpy_carries_renumbered_state(grid_solves):
    """A JAX-built renumbered state: the port's runtime on it gives the
    JAX package's gmv and apply to 1e-14, and its solve the JAX count."""
    r = grid_solves[True]
    arrays = jax_state_arrays(r["jstate"])
    dec = r["jstate"].dec
    arrays.update(perm=np.asarray(dec.perm), iperm=np.asarray(dec.iperm),
                  renumbered=True)
    state = interop.state_from_numpy(arrays, device="cpu")
    assert state.dec.renumbered and state.dec.pexch is None
    x = np.random.default_rng(5).normal(size=(4, state.dec.n_max, 2))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for fj, fp in ((jax_sz.gmv, sz.gmv), (jax_sz.apply, sz.apply)):
        np.testing.assert_allclose(fp(state, xt).numpy(),
                                   np.asarray(fj(r["jstate"], xj)),
                                   rtol=0, atol=1e-14)
    opt = Options(schwarz_coarse_correction="deflated", geneo_nu=4)
    res = solve(state, torch.from_numpy(r["f"]), opt=opt)
    assert res.iterations == r["jits"]


@pytest.fixture(scope="module")
def mesh():
    """The 60x60-point mesh of tests/test_unstructured.py, S=8, in both
    packages (the generators are byte-equal, tests/test_torch_unstructured.py)."""
    kw = dict(overlap=2, with_neumann=True, seed=0)
    return (jax_un.generate(8, 60, 60, **kw),
            unstructured.generate(8, 60, 60, **kw))


@pytest.mark.parametrize("case", ["dense", "banded_lanczos"])
def test_unstructured_renumbered_counts_equal_jax(mesh, case):
    """tests/test_unstructured.py:100-130 in the interface-first layout:
    dense GenEO nu=8, and the production configuration (RCM banded
    factors + Lanczos GenEO, nu=8); the port takes the JAX package's
    count and reaches a true residual below 5e-8."""
    jgen, gen = mesh
    kw = dict(tol=1e-8, schwarz_coarse_correction="deflated", geneo_nu=8)
    if case == "banded_lanczos":
        kw["local_solver"] = "banded"
    method = "lanczos" if case == "banded_lanczos" else "dense"
    jopt = JaxOptions(**kw)
    jsch = jax_sz.Schwarz(jgen.mats, jgen.neighbors, jgen.mappings,
                          d=jgen.d, options=jopt, renumber=True)
    jsch.solve_gevp(jgen.neumann, method=method)
    f = _rhs(gen, jsch.n_max)
    jits = int(jax_solve(jsch.build(), jnp.asarray(f), opt=jopt).iterations)
    opt = Options(**kw)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=opt, renumber=True, device="cpu")
    sch.solve_gevp(gen.neumann, method=method)
    state = sch.build()
    assert state.dec.renumbered and state.dec.pexch is None
    res = solve(state, torch.from_numpy(f), opt=opt)
    assert res.iterations == jits, (case, res.iterations, jits)
    x = res.x.numpy()
    xg = np.zeros(gen.A_global.shape[0])
    for s in range(8):
        xg[gen.gids[s]] = x[s, : gen.n_loc[s], 0]
    fg = np.where(gen.boundary, 0.0, 1.0)
    assert np.linalg.norm(gen.A_global @ xg - fg) / np.linalg.norm(fg) < 5e-8


def test_banded_grid_boxes_refuse_renumbered_layout():
    """Banded factors on grid boxes need the caller's numbering: the
    interface-first layout raises ValueError, as in the JAX package
    (hpddm_tpu/precond/schwarz.py:1138-1141); set_grid_geometry attaches
    no slab plan and no canvas to it."""
    gen = diffusion2d.generate_uniform(4, 32, 32, overlap=1)
    jsch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                          options=JaxOptions(local_solver="banded"),
                          renumber=True)
    jsch.set_grid_geometry(gen.boxes, 32, 32)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(local_solver="banded"), renumber=True,
                     device="cpu")
    sch.set_grid_geometry(gen.boxes, 32, 32)
    for s in (jsch, sch):
        assert s.dec.grid is None
        assert getattr(s.A, "canvas_hw", None) is None
    for s in (jsch, sch):
        with pytest.raises(ValueError, match="non-renumbered"):
            s.build()
