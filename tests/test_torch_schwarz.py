"""Port vs JAX package: the two-level Schwarz preconditioner on the CPU.

* On identical operators (a JAX-built state carried over by
  ``interop.state_from_numpy``), the port's ``gmv``, ``apply`` and
  ``compute_residual`` equal the JAX package's at rtol 1e-12: the same
  products in f64, summed in another order.
* The port's own setup (decomposition, DIA packing, dense GenEO, ``inv``
  factors, dense Galerkin coarse operator) gives an ``apply`` within rtol
  1e-8 of the JAX package's. GenEO eigenvectors are defined only up to a
  basis change within each subdomain, so operator outputs are compared,
  never vectors; 1e-8 leaves room for the two eigensolvers' rounding in a
  pencil whose conditioning magnifies it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve

S, NX, NY, NU = 4, 40, 40, 4
CORRECTIONS = ["deflated", "additive", "balanced"]


def jax_state_arrays(state):
    """Flatten a hpddm_tpu SchwarzState (DIA or ELL, inv or banded, a
    direct or nested coarse solve with its levels, the grid plan and
    canvas where attached) to the numpy dict of interop.state_from_numpy."""
    dec = state.dec
    out = {k: np.asarray(getattr(dec, k)) for k in (
        "n_loc", "d", "if_idx", "if_gid", "if_mask", "ov_mask", "mult",
        "partners", "inv_map", "is_if")}
    out.update({k: getattr(dec, k) for k in interop.DEC_INT_KEYS})
    out["sub_shifts"] = dec.sub_shifts
    if getattr(dec, "grid", None) is not None:
        g = dec.grid
        out["grid"] = {k: getattr(g, k) for k in (
            "nbr", "sxw", "syw", "onehot", "H", "W", "t", "S", "gx", "gy",
            "regular", "sxw_s", "syw_s")}
    out["A_values"] = np.asarray(state.A.values)
    if hasattr(state.A, "cols"):                         # BatchedELL
        out["A_cols"] = np.asarray(state.A.cols)
    else:
        out["A_offsets"] = state.A.offsets
        out["A_canvas_hw"] = state.A.canvas_hw
    solver = state.solver
    if hasattr(solver, "Dinv"):                          # BandedSolver
        out.update({k: np.asarray(getattr(solver, k)) for k in (
            "Dinv", "cl", "cu", "idx_fwd", "msk_fwd", "idx_inv", "msk_inv")})
        out.update(wy_max=solver.wy_max, wx_max=solver.wx_max,
                   cw=solver.cw)
    elif solver is not None:
        out["factor"] = np.asarray(solver.factor)
    out["variant"] = state.variant
    out["bc"] = None if state.bc is None else np.asarray(state.bc)
    co = state.coarse
    if co is not None:
        def arr(v):
            return None if v is None else np.asarray(v)
        out.update(Z=np.asarray(co.Z), E_inv=arr(co.E_inv),
                   nu_loc=np.asarray(co.nu_loc), nu_max=co.nu_max,
                   correction=co.correction)
        out.update({k: arr(getattr(co, k)) for k in
                    interop.COARSE_ARRAYS + ("loc_idx", "nbr_oh")})
        out.update({k: getattr(co, k) for k in interop.COARSE_SCALARS})
        out.update({k: tuple(np.asarray(a) for a in getattr(co, k))
                    for k in interop.COARSE_CHAIN})
        out.update({k: getattr(co, k) for k in (
            "chain_modes", "chain_tols", "chain_max_its")})
    return out


def _rhs(gen, n_max):
    f = np.zeros((len(gen.n_loc), n_max, 1))
    for s in range(len(gen.n_loc)):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return f


@pytest.fixture(scope="module")
def jax_setup():
    gen = jax_d2.generate(S, NX, NY, overlap=1, with_neumann=True)
    opt = JaxOptions(geneo_nu=NU)
    sch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=opt)
    sch.solve_gevp(gen.neumann)
    return gen, sch


@pytest.fixture(scope="module")
def port_setup():
    gen = diffusion2d.generate(S, NX, NY, overlap=1, with_neumann=True)
    opt = Options(geneo_nu=NU)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=opt, device="cpu")
    sch.solve_gevp(gen.neumann)
    return gen, sch


def _jax_state(jax_setup, correction, variant="ras"):
    _, sch = jax_setup
    sch.opt["schwarz_method"] = variant
    if correction is None:
        sch.opt.remove("schwarz_coarse_correction")
    else:
        sch.opt["schwarz_coarse_correction"] = correction
    sch._state = None
    return sch.build()


def _vectors(n_max, mu=2, seed=0):
    return np.random.default_rng(seed).normal(size=(S, n_max, mu))


@pytest.mark.parametrize("variant,correction",
                         [("ras", c) for c in CORRECTIONS]
                         + [("ras", None), ("asm", None), ("soras", None),
                            ("asm", "additive"), ("soras", "deflated")])
def test_runtime_on_jax_state(jax_setup, variant, correction):
    jstate = _jax_state(jax_setup, correction, variant)
    state = interop.state_from_numpy(jax_state_arrays(jstate), device="cpu")
    x = _vectors(jstate.dec.n_max)
    # consistent inputs, as the Krylov loop feeds them
    xj = jax_sz.scaled_exchange(jstate.dec, jnp.asarray(x))
    xt = torch.tensor(np.asarray(xj))
    for fn, jfn in ((sz.gmv, jax_sz.gmv), (sz.apply, jax_sz.apply)):
        got = fn(state, xt).numpy()
        want = np.asarray(jfn(jstate, xj))
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    f = jnp.asarray(_rhs(jax_setup[0], jstate.dec.n_max))
    nb, nr = sz.compute_residual(state, xt[:, :, :1],
                                 torch.tensor(np.asarray(f)))
    jnb, jnr = jax_sz.compute_residual(jstate, xj[:, :, :1], f)
    np.testing.assert_allclose(nb.numpy(), np.asarray(jnb), rtol=1e-12)
    np.testing.assert_allclose(nr.numpy(), np.asarray(jnr), rtol=1e-12)


@pytest.mark.parametrize("correction", CORRECTIONS)
def test_own_setup_apply_matches_jax(jax_setup, port_setup, correction):
    jstate = _jax_state(jax_setup, correction)
    _, sch = port_setup
    sch.opt["schwarz_coarse_correction"] = correction
    state = sch.build()
    assert state.coarse.nu_max == jstate.coarse.nu_max == NU
    np.testing.assert_allclose(state.solver.factor.numpy(),
                               np.asarray(jstate.solver.factor),
                               rtol=1e-10, atol=1e-14)
    xj = jax_sz.scaled_exchange(jstate.dec,
                                jnp.asarray(_vectors(jstate.dec.n_max, 3, 1)))
    xt = torch.tensor(np.asarray(xj))
    want = np.asarray(jax_sz.apply(jstate, xj))
    got = sz.apply(state, xt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
    assert set(sch.timings) >= {"geneo", "factorize", "coarse"}


@pytest.mark.parametrize("ortho", ["cgs", "cgs2"])
def test_gmres_on_jax_state(jax_setup, ortho):
    """Port GMRES on the JAX-built operator: the same iteration count and
    the solution at rtol 1e-10 (identical operators; only summation order
    differs)."""
    jstate = _jax_state(jax_setup, "deflated")
    state = interop.state_from_numpy(jax_state_arrays(jstate), device="cpu")
    f = _rhs(jax_setup[0], jstate.dec.n_max)
    jres = jax_solve(jstate, jnp.asarray(f),
                     opt=JaxOptions(tol=1e-8, orthogonalization=ortho,
                                    gmres_restart=8))
    res = solve(state, torch.as_tensor(f),
                opt=Options(tol=1e-8, orthogonalization=ortho,
                            gmres_restart=8))
    assert res.iterations == int(jres.iterations)
    want = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(res.rel_res.numpy(), np.asarray(jres.rel_res),
                               rtol=1e-6)


def test_geneo_eigenvalues_match_jax(jax_setup):
    """The dense pencil's eigenvalues (basis-free) agree at rtol 1e-9."""
    from hpddm_tpu.core.formats import batched_dense_from as jdense
    from hpddm_tpu.core.formats import pack_local_matrices as jpack
    from hpddm_tpu.precond.geneo import scale_into_overlap as jscale
    from hpddm_tpu.precond.geneo import solve_gevp_dense as jgevp
    from hpddm_tpu_torch.core.formats import (batched_dense_from,
                                              pack_local_matrices)
    from hpddm_tpu_torch.precond.geneo import (scale_into_overlap,
                                               solve_gevp_dense)
    gen, jsch = jax_setup
    jA_neu = jdense(jpack(gen.neumann, n_max=jsch.n_max, fmt="dense"))
    jlam, _ = jgevp(jA_neu, jscale(jsch.A, jsch.dec), 6)
    psch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      device="cpu")
    A_neu = batched_dense_from(pack_local_matrices(gen.neumann,
                                                   n_max=psch.n_max,
                                                   device="cpu"))
    lam, V = solve_gevp_dense(A_neu, scale_into_overlap(psch.A, psch.dec), 6)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-9)
    np.testing.assert_allclose(torch.linalg.norm(V, dim=1).numpy(), 1.0,
                               rtol=1e-12)


def test_unported_branches_raise(port_setup, jax_setup):
    """The FFT local solver without grid geometry raises ``ValueError``,
    as in the JAX package; the nested block-sparse coarse solve builds,
    and one coarse solve takes the JAX package's inner iterations and
    values; Lanczos GenEO with the ``cheby`` inner solve (Jacobi-
    preconditioned inner CG) gives the JAX package's eigenvalues."""
    gen, _ = port_setup
    with pytest.raises(ValueError, match="set_grid_geometry"):
        sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                   options=Options(local_solver="fft"), device="cpu").build()
    kw = dict(schwarz_coarse_correction="deflated", coarse_assembly="bsr",
              level_2_tol=1e-2)
    co = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                    options=Options(**kw), device="cpu").build().coarse
    jgen, _ = jax_setup
    jco = jax_sz.Schwarz(jgen.mats, jgen.neighbors, jgen.mappings, d=jgen.d,
                         options=JaxOptions(**kw)).build().coarse
    assert co.mode == jco.mode == "bsr" and co.E_inv is None
    c = np.random.default_rng(5).normal(size=(S, co.nu_max, 2))
    y, its = sz._coarse_solve_bsr(co, torch.as_tensor(c), return_its=True)
    jy, jits = jax_sz._coarse_solve_bsr(jco, jnp.asarray(c), return_its=True)
    assert its == int(jits)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-12,
                               atol=1e-14)
    lam, _ = sz.Schwarz(
        gen.mats, gen.neighbors, gen.mappings, d=gen.d,
        options=Options(local_solver="cheby"),
        device="cpu")._solve_gevp_lanczos(gen.neumann, 6)
    jlam, _ = jax_sz.Schwarz(
        jgen.mats, jgen.neighbors, jgen.mappings, d=jgen.d,
        options=JaxOptions(local_solver="cheby"))._solve_gevp_lanczos(
            jgen.neumann, 6)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-8)


@pytest.mark.parametrize("options,call,match", [
    ({"local_solver": "fft"}, lambda sch, gen: sch.build(),
     "fft requires set_grid_geometry"),
    ({"local_solver": "dst_cheby"}, lambda sch, gen: sch.build(),
     "dst_cheby requires set_grid_geometry"),
    ({"local_solver": "fft"}, lambda sch, gen: sch.solve_gevp(
        gen.neumann, method="lanczos"), "fft requires set_grid_geometry"),
])
def test_left_out_options_raise(port_setup, options, call, match):
    """The DST local solve (``fft``, and the inner solve of ``dst_cheby``
    and of their Lanczos GenEO) needs the grid boxes: without
    ``set_grid_geometry`` each raises ``ValueError`` instead of running
    another path, as the JAX package's builds do. The solvers themselves
    are held to the JAX package in tests/test_torch_fft_cheby*.py; slice
    5a's options in tests/test_torch_features.py; factors in another
    dtype than the operator's in tests/test_torch_krylov.py."""
    gen, _ = port_setup
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(**options), device="cpu")
    with pytest.raises(ValueError, match=match):
        call(sch, gen)
