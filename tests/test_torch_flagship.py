"""Port vs JAX package: the flagship512 path on the CPU (slice 3c).

A twin of ``bench.py``'s flagship at generate_uniform(16, 64, 64) with the
bench's contrast-1e4 channel, Jacobi-scaled, banded local solves on the
grid boxes, Lanczos GenEO (nu=8), the block-sparse coarse assembly and a
replicated direct coarse solve, deflated:

* ``jacobi_scale`` is byte-equal to the JAX package's;
* the block-sparse blocks E_diag / E_nb equal the JAX package's on the
  same vectors (f64, 1e-13; both Galerkin forms), the scattered blocks
  equal the port's dense Galerkin E, accumulation equals multiplication,
  and the dense assembly switches to them above the memory cap;
* the port takes the JAX package's iteration count in f64 end to end,
  in f32 on the JAX package's f32 GenEO vectors, and in f32 end to end
  against the JAX package's f32 GenEO run op by op (jitted, XLA rounds
  the inner solve's refinement residual otherwise, and that residual is
  f32 noise: its vectors take 10 iterations on this twin, the op-by-op
  ones and the port's 8, f64 vectors 6);
* ``solve_refined`` follows the JAX package's history (f64, rtol 1e-6;
  1e-4 for the last pass, near roundoff) to <= 1e-10, on the JAX
  package's state carried across by ``interop``;
* the double-word primitives are exact against f64 and equal the JAX
  package's, and ``solve_refined_device`` follows its history.

The JAX package's solves are jitted once per tolerance with the state as
an argument (``bench.py:205-206``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hpddm_tpu.core.scaling import jacobi_scale as jax_jacobi_scale
from hpddm_tpu.core.scaling import unscale_solution as jax_unscale
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.ops import doubleword as jax_dw
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve
from hpddm_tpu.solvers.refine import solve_refined as jax_solve_refined
from hpddm_tpu.solvers.refine import \
    solve_refined_device as jax_solve_refined_device

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.core.scaling import jacobi_scale, unscale_solution
from hpddm_tpu_torch.examples import flagship
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.ops import doubleword as dw
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve
from hpddm_tpu_torch.solvers.refine import (solve_refined,
                                            solve_refined_device,
                                            true_relres)
from test_torch_schwarz import jax_state_arrays

S, N = 16, 64
INNER = dict(tol=1e-3, local_solver="banded",
             schwarz_coarse_correction="deflated", geneo_nu=8)


def _kw(dtype):
    return dict(tol=1e-6 if dtype == np.float32 else 1e-8,
                local_solver="banded", coarse_assembly="bsr",
                schwarz_coarse_correction="deflated", geneo_nu=8)


def _rhs(f_list, n_loc, n_max, dtype):
    f = np.zeros((len(n_loc), n_max, 1), dtype=dtype)
    for s in range(len(n_loc)):
        f[s, : n_loc[s]] = f_list[s]
    return f


def _setup(dtype):
    """JAX and port twins: {pkg: (scaled mats, f, Schwarz, state, raw)}."""
    out = {}
    for pkg, (d2, scale, Sch, Opt) in {
            "jax": (jax_d2, jax_jacobi_scale, jax_sz.Schwarz, JaxOptions),
            "port": (diffusion2d, jacobi_scale, sz.Schwarz, Options)}.items():
        gen = d2.generate_uniform(S, N, N, overlap=1, kappa=flagship.kappa,
                                  with_neumann=True, dtype=dtype)
        scaled = scale(gen.mats, gen.f, gen.neumann)
        kw = dict(options=Opt(**_kw(dtype)))
        if pkg == "port":
            kw["device"] = "cpu"
        sch = Sch(scaled[0], gen.neighbors, gen.mappings, d=gen.d, **kw)
        sch.set_grid_geometry(gen.boxes, N, N)
        sch.solve_gevp(scaled[2], method="lanczos")
        f = _rhs(scaled[1], gen.n_loc, sch.n_max, dtype)
        out[pkg] = (scaled, f, sch, sch.build(), gen)
    return out


@pytest.fixture(scope="module")
def twin64():
    return _setup(np.float64)


@pytest.fixture(scope="module")
def twin32():
    return _setup(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_run(dtype):
    """The JAX package's solve at the twin's options, jitted once per dtype
    with the state as an argument."""
    opt = JaxOptions(**_kw(dtype))
    return jax.jit(lambda st, b: jax_solve(st, b, opt=opt))


def _jax_its(case, dtype, state=None):
    """The JAX package's iteration count on the twin (its own state unless
    one is given)."""
    _, f, _, own, _ = case["jax"]
    res = _jax_run(dtype)(own if state is None else state, jnp.asarray(f))
    return int(res.iterations)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jacobi_scale_is_byte_equal(dtype):
    gens = [m.generate_uniform(S, N, N, overlap=1, kappa=flagship.kappa,
                               with_neumann=True, dtype=dtype)
            for m in (jax_d2, diffusion2d)]
    want = jax_jacobi_scale(gens[0].mats, gens[0].f, gens[0].neumann)
    got = jacobi_scale(gens[1].mats, gens[1].f, gens[1].neumann)
    for key in (0, 2):
        for a, b in zip(got[key], want[key]):
            a, b = a.scipy(), b.scipy()
            for k in ("data", "indices", "indptr"):
                assert getattr(a, k).tobytes() == getattr(b, k).tobytes()
    for key in (1, 3):
        for a, b in zip(got[key], want[key]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    x = np.random.default_rng(1).normal(size=(S, max(gens[1].n_loc), 2))
    np.testing.assert_array_equal(
        unscale_solution(torch.as_tensor(x), got[3]).numpy(),
        jax_unscale(x, want[3]))


def _blocks(case, galerkin):
    """(port blocks, JAX bsr CoarseState) on the JAX package's vectors."""
    _, _, jsch, jstate, _ = case["jax"]
    sch = case["port"][2]
    Z = torch.as_tensor(np.asarray(jstate.coarse.Z))
    nu_loc = np.asarray(jstate.coarse.nu_loc)
    sch.opt["coarse_galerkin"] = galerkin
    jsch.opt["coarse_galerkin"] = galerkin
    jsch.opt["level_2_tol"] = 1e-2            # the JAX package's bsr mode
    try:
        co = jsch._build_coarse("deflated", np.float64)
        got = sch._bsr_blocks(Z, nu_loc, int(Z.shape[2]))
    finally:
        for s in (sch, jsch):
            s.opt.remove("coarse_galerkin")
        jsch.opt.remove("level_2_tol")
    assert co.mode == "bsr"
    return got, co


@pytest.mark.parametrize("galerkin", ["multiplication", "accumulation"])
def test_bsr_blocks_equal_jax(twin64, galerkin):
    (E_diag, E_nb, nbr_sub), co = _blocks(twin64, galerkin)
    want_d, want_n = np.asarray(co.Eb_diag), np.asarray(co.Eb_nbr)
    scale = np.abs(want_d).max()
    np.testing.assert_allclose(E_diag.numpy(), want_d, rtol=0,
                               atol=1e-13 * scale)
    np.testing.assert_allclose(E_nb.numpy(), want_n, rtol=0,
                               atol=1e-13 * scale)
    oh = np.asarray(co.nbr_oh)[:, :, :S]            # one-hot of nbr_sub
    np.testing.assert_array_equal(
        np.where(nbr_sub < S, nbr_sub, -1),
        np.where(oh.any(axis=2), oh.argmax(axis=2), -1))


def test_bsr_scatter_equals_dense_and_accumulation(twin64):
    """The scattered blocks give the dense Galerkin E; accumulation gives
    the multiplication form's blocks; the direct inverse equals the JAX
    package's (pinv with the same cutoff, numpy on the host)."""
    _, _, sch, state, _ = twin64["port"]
    jstate = twin64["jax"][3]
    Z, nu = state.coarse.Z, state.coarse.nu_max
    nu_loc = state.coarse.nu_loc.numpy()
    E = sch._assemble_E(Z, nu_loc, nu).numpy()
    E_diag, E_nb, nbr_sub = sch._bsr_blocks(Z, nu_loc, nu)
    full = np.zeros_like(E)
    for s in range(S):
        full[s * nu:(s + 1) * nu, s * nu:(s + 1) * nu] = E_diag[s].numpy()
        for j, q in enumerate(nbr_sub[s]):
            if q < S:
                full[s * nu:(s + 1) * nu, q * nu:(q + 1) * nu] = E_nb[s, j]
    tol = 1e-13 * np.abs(E).max()
    np.testing.assert_allclose(full, E, rtol=0, atol=tol)
    sch.opt["coarse_galerkin"] = "accumulation"
    try:
        acc = sch._bsr_blocks(Z, nu_loc, nu)
    finally:
        sch.opt.remove("coarse_galerkin")
    np.testing.assert_allclose(acc[0].numpy(), E_diag.numpy(), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(acc[1].numpy(), E_nb.numpy(), rtol=0,
                               atol=tol)
    got = sch._bsr_direct_inverse(torch.as_tensor(np.asarray(
        jstate.coarse.Z)), nu_loc, nu, None).numpy()
    want = np.asarray(jstate.coarse.E_inv)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())
    assert {"coarse_bsr_blocks", "coarse_pinv"} <= set(sch.timings)


def _small(**kw):
    gen = diffusion2d.generate(4, 40, 40, overlap=1, with_neumann=True)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(schwarz_coarse_correction="deflated",
                                     geneo_nu=2, **kw), device="cpu")
    sch.solve_gevp(gen.neumann)
    return sch


def test_dense_assembly_switches_to_bsr_above_the_cap(monkeypatch, capsys):
    """Above the cap the coarse operator is assembled block-sparse, and an
    explicit coarse_assembly=dense is kept with a warning
    (``tests/test_multilevel.py:140``)."""
    dense = _small().build().coarse.E_inv
    bsr = _small(coarse_assembly="bsr").build().coarse.E_inv
    monkeypatch.setattr(sz, "_DENSE_COARSE_BYTES_CAP", 1)
    sch = _small(verbosity=1)
    auto = sch.build().coarse.E_inv
    assert "auto-switched to bsr" in capsys.readouterr().out
    assert "coarse_bsr_blocks" in sch.timings
    assert torch.equal(auto, bsr)
    np.testing.assert_allclose(auto.numpy(), dense.numpy(), rtol=1e-8,
                               atol=1e-10 * float(dense.abs().max()))
    kept = _small(coarse_assembly="dense").build().coarse.E_inv
    assert "WARNING -- coarse_assembly=dense" in capsys.readouterr().out
    assert torch.equal(kept, dense)


def test_level2_coarse_solves_still_raise():
    """The level-2 options on the block-sparse assembly give a ``bsr``
    state whose solve takes the JAX package's outer iterations and
    solution on the same GenEO vectors, through flexible GMRES."""
    kw = dict(coarse_assembly="bsr", level_2_tol=1e-2)
    sch = _small(**kw)
    state = sch.build()
    assert state.coarse.mode == "bsr" and state.coarse.lvl3 == "direct"
    jgen = jax_d2.generate(4, 40, 40, overlap=1, with_neumann=True)
    jsch = jax_sz.Schwarz(jgen.mats, jgen.neighbors, jgen.mappings,
                          d=jgen.d, options=JaxOptions(
                              schwarz_coarse_correction="deflated",
                              geneo_nu=2, **kw))
    jsch.set_vectors(sch._deflation_vectors)
    f = _rhs(jgen.f, jgen.n_loc, sch.n_max, np.float64)
    res = solve(state, torch.as_tensor(f), opt=sch.opt)
    jres = jax_solve(jsch.build(), jnp.asarray(f), opt=jsch.opt)
    assert res.iterations == int(jres.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-10, atol=1e-12)


def test_flagship_twin_f64_counts_equal_jax(twin64):
    _, f, _, state, _ = twin64["port"]
    res = solve(state, torch.as_tensor(f), opt=Options(**_kw(np.float64)))
    assert res.iterations == _jax_its(twin64, np.float64), res.iterations
    assert true_relres(twin64["port"][0][0], f, state.dec, res.x) <= 1e-8
    assert state.dec.grid is not None and state.A.canvas_hw is not None


def test_flagship_twin_f32_counts_on_jax_vectors(twin32):
    """f32: the port on the JAX package's f32 GenEO vectors takes its count
    (the bsr blocks, the f32 banded factors and the f32 solve)."""
    scaled, f, sch, _, _ = twin32["port"]
    jsch = twin32["jax"][2]
    want = _jax_its(twin32, np.float32)
    sch.set_vectors([np.asarray(v) for v in jsch._deflation_vectors])
    try:
        state = sch.build()
    finally:
        sch.solve_gevp(scaled[2], method="lanczos")
    opt = Options(**_kw(np.float32))
    assert solve(state, torch.as_tensor(f), opt=opt).iterations == want


def test_flagship_twin_f32_counts_equal_jax_op_by_op(twin32, monkeypatch):
    """f32 end to end: the port's own f32 Lanczos GenEO takes the count of
    the JAX package's f32 Lanczos run op by op (``jax.disable_jit``), the
    arithmetic the port's eager operations follow. Jitted, XLA fuses the
    Neumann DIA product of the inner solve's refinement residual and rounds
    it otherwise; that residual is f32 rounding noise (the product's terms
    are about 1e6 times the residual), so the JAX package's jitted vectors
    differ and take 10 iterations here, 27 at full size (PERF.md §7)."""
    from hpddm_tpu.precond import geneo as jax_geneo
    scaled, f, _, own, _ = twin32["port"]
    jscaled, _, jsch, _, _ = twin32["jax"]
    lanczos = jax_geneo.solve_gevp_lanczos

    def op_by_op(*args, **kwargs):
        with jax.disable_jit():
            return lanczos(*args, **kwargs)
    jitted = jsch._deflation_vectors
    monkeypatch.setattr(jax_geneo, "solve_gevp_lanczos", op_by_op)
    try:
        jsch.solve_gevp(jscaled[2], method="lanczos")
        jstate = jsch.build()
    finally:
        jsch._deflation_vectors = jitted
    want = _jax_its(twin32, np.float32, jstate)
    res = solve(own, torch.as_tensor(f), opt=Options(**_kw(np.float32)))
    assert bool(res.converged.all()) and res.iterations == want, \
        (res.iterations, want)


class _Captured(Exception):
    """Stops a GenEO solve once its Lanczos operators are built."""


def _lanczos_operators(sch, neumann, module, monkeypatch):
    """The (apply_Ainv, apply_B, aux) that ``sch.solve_gevp`` hands to
    ``module.solve_gevp_lanczos``, without running the Lanczos steps."""
    got = {}

    def capture(apply_Ainv, apply_B, *args, aux=None, **kwargs):
        got.update(Ainv=apply_Ainv, B=apply_B, aux=aux)
        raise _Captured
    with monkeypatch.context() as m:
        m.setattr(module, "solve_gevp_lanczos", capture)
        with pytest.raises(_Captured):
            sch.solve_gevp(neumann, method="lanczos")
    return got["Ainv"], got["B"], got["aux"]


def test_f32_lanczos_inner_refinement_is_rounding_noise(twin32, monkeypatch):
    """Why the f32 GenEO vectors differ between the JAX package jitted and
    op by op (ROADMAP queue C, C7; PERF.md section 7): the inner solve of
    the regularized Neumann matrix is x + solve(r - A_neu x). One f32 solve
    is accurate, but the residual's DIA terms are about 1e6 times the
    residual, so the f32 residual is rounding noise and the refinement
    spoils the solve, in both packages. XLA's fused DIA product rounds that
    residual otherwise than the same operations op by op; the port's
    residual is the op-by-op one, to the bit."""
    import inspect
    import scipy.sparse as sps
    import scipy.sparse.linalg as spl
    from hpddm_tpu.ops.spmv import spmm as jax_spmm
    from hpddm_tpu.precond import geneo as jax_geneo
    from hpddm_tpu_torch.ops.spmv import spmm as port_spmm
    from hpddm_tpu_torch.precond import geneo as port_geneo

    scaled, _, sch, _, _ = twin32["port"]
    jscaled, _, jsch, _, _ = twin32["jax"]
    jA, jB, aux = _lanczos_operators(jsch, jscaled[2], jax_geneo,
                                     monkeypatch)
    pA, _, _ = _lanczos_operators(sch, scaled[2], port_geneo, monkeypatch)
    n_max = sch.n_max
    x = np.random.default_rng(5).normal(size=(S, n_max, 1))
    r = np.array(jB(aux, jnp.asarray(x, dtype=jnp.float32)))
    eps = 1e-8 * float(np.mean([np.abs(m.scipy().diagonal()).mean()
                                for m in scaled[2]]))
    exact = np.zeros((S, n_max, 1))
    for s, m in enumerate(scaled[2]):
        reg = sps.csc_matrix(m.scipy(expand=True).astype(np.float64)
                             + eps * sps.identity(m.n))
        exact[s, : m.n, 0] = spl.spsolve(reg, r[s, : m.n, 0].astype(
            np.float64))

    def rel(y):
        return float(np.linalg.norm(np.asarray(y, np.float64) - exact)
                     / np.linalg.norm(exact))
    solver = inspect.getclosurevars(pA).nonlocals["Knb"]
    one = {"jax": rel(jax.jit(lambda k, b: k.solve(b))(aux[3], r)),
           "port": rel(solver.solve(torch.as_tensor(r)))}
    refined = {"jax": rel(jax.jit(jA)(aux, jnp.asarray(r))),
               "port": rel(pA(torch.as_tensor(r)))}
    # the residual of one solve's result, jitted, op by op and in the port
    x1 = solver.solve(torch.as_tensor(r))
    A_neu = aux[2]
    port_neu = sch.A.__class__(values=torch.as_tensor(
        np.asarray(A_neu.values)), offsets=A_neu.offsets, n_max=n_max)

    def jax_residual(a, b, y):
        return b - (jax_spmm(a, y) + eps * y)
    jitted = np.asarray(jax.jit(jax_residual)(A_neu, jnp.asarray(r),
                                              jnp.asarray(x1.numpy())))
    with jax.disable_jit():
        op_by_op = np.asarray(jax_residual(A_neu, jnp.asarray(r),
                                           jnp.asarray(x1.numpy())))
    port = (torch.as_tensor(r) - (port_spmm(port_neu, x1) + eps * x1)).numpy()
    terms = float(np.abs(x1.numpy()).max())
    print(f"one solve {one}, refined {refined}, residual "
          f"{np.abs(op_by_op).max():.3g} with terms ~{terms:.3g}, "
          f"jitted - op by op "
          f"{np.abs(jitted - op_by_op).max():.3g}")
    for pkg in ("jax", "port"):
        assert one[pkg] <= 1e-5 and refined[pkg] >= 1e4 * one[pkg], pkg
    assert terms >= 1e5 * np.abs(op_by_op).max()
    assert np.array_equal(port, op_by_op)
    assert not np.array_equal(jitted, op_by_op)


def test_solve_refined_follows_jax(twin64):
    """Host-f64 refinement around the f64 solve at inner tol 1e-3 on the JAX
    package's state carried across (the same operator, vectors and
    factors): the same inner counts and history to <= 1e-10."""
    scaled, f, _, jstate, _ = twin64["jax"]
    state = interop.state_from_numpy(jax_state_arrays(jstate), device="cpu")
    assert state.dec.grid is not None and state.A.canvas_hw is not None
    run = jax.jit(lambda st, b: jax_solve(st, b, opt=JaxOptions(**INNER)))
    _, want = jax_solve_refined(lambda b: run(jstate, jnp.asarray(b)),
                                scaled[0], f, jstate.dec, tol=1e-10,
                                max_refine=6)
    mats = twin64["port"][0][0]
    x, got = solve_refined(lambda b: solve(state, b, opt=Options(**INNER)),
                           mats, torch.as_tensor(f), state.dec, tol=1e-10,
                           max_refine=6)
    assert got["inner_iterations"] == want["inner_iterations"]
    np.testing.assert_allclose(got["history"][:-1], want["history"][:-1],
                               rtol=1e-6)
    # the last pass ends within 1e5 of f64 roundoff: the two solves'
    # differences in the last bits, grown by the 1e4 contrast, move it by
    # about 1e-5 of itself
    np.testing.assert_allclose(got["history"][-1], want["history"][-1],
                               rtol=1e-4)
    assert got["history"][-1] <= 1e-10
    assert true_relres(mats, f, state.dec, x) == got["history"][-1]


def _dw_inputs(seed, n=4096):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    b = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    return a, b


def test_doubleword_primitives_exact_and_equal_jax():
    a, b = _dw_inputs(0)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for name, exact in (("two_sum", a64 + b64), ("two_prod", a64 * b64)):
        s, e = (t.numpy() for t in getattr(dw, name)(ta, tb))
        np.testing.assert_array_equal(s.astype(np.float64)
                                      + e.astype(np.float64), exact)
        js, je = getattr(jax_dw, name)(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(s, np.asarray(js))
        np.testing.assert_array_equal(e, np.asarray(je))
    big, small = np.maximum(np.abs(a), np.abs(b)) * np.sign(a), \
        np.minimum(np.abs(a), np.abs(b))
    s, e = dw.fast_two_sum(torch.as_tensor(big), torch.as_tensor(small))
    np.testing.assert_array_equal(s.numpy().astype(np.float64)
                                  + e.numpy().astype(np.float64),
                                  big.astype(np.float64) + small)
    # double-word sums and products: relative error O(eps32^2) against f64
    x = dw.two_sum(ta, tb)
    y = dw.two_prod(tb, ta)
    for got, jgot, exact in (
            (dw.dw_add(x, y), jax_dw.dw_add(
                jax_dw.two_sum(jnp.asarray(a), jnp.asarray(b)),
                jax_dw.two_prod(jnp.asarray(b), jnp.asarray(a))),
             (a64 + b64) + b64 * a64),
            (dw.dw_mul_f32(ta, x), jax_dw.dw_mul_f32(
                jnp.asarray(a), jax_dw.two_sum(jnp.asarray(a),
                                               jnp.asarray(b))),
             a64 * (a64 + b64))):
        h, lo = (t.numpy() for t in got)
        np.testing.assert_array_equal(h, np.asarray(jgot[0]))
        np.testing.assert_array_equal(lo, np.asarray(jgot[1]))
        val = h.astype(np.float64) + lo.astype(np.float64)
        assert np.all(np.abs(val - exact) <= 2.0 ** -44 * np.abs(exact)
                      + 1e-300)


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_doubleword_spmm_equals_jax(fmt):
    """The double-word products on the slot-major ELL and the DIA batches
    equal the JAX package's (the same error-free terms, summed in slot or
    diagonal order), and their pairs hold the f64 product to O(eps32^2)."""
    from hpddm_tpu.core.formats import pack_local_matrices as jax_pack
    from hpddm_tpu_torch.core.formats import pack_local_matrices

    gen = diffusion2d.generate(4, 24, 24, overlap=1, dtype=np.float32)
    A = pack_local_matrices(gen.mats, fmt=fmt, device="cpu")
    jA = jax_pack(gen.mats, fmt=fmt)
    rng = np.random.default_rng(4)
    xh = rng.normal(size=(4, A.n_max, 2)).astype(np.float32)
    xl = (rng.normal(size=xh.shape) * 1e-8).astype(np.float32)
    h, lo = dw.spmm_dw(A, (torch.as_tensor(xh), torch.as_tensor(xl)))
    jh, jl = jax_dw.spmm_dw(jA, (jnp.asarray(xh), jnp.asarray(xl)))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jl))
    x64 = torch.as_tensor(xh, dtype=torch.float64) + \
        torch.as_tensor(xl, dtype=torch.float64)
    A64 = pack_local_matrices(gen.mats, fmt=fmt, dtype=np.float64,
                              device="cpu")
    from hpddm_tpu_torch.ops.spmv import spmm
    exact = spmm(A64, x64)
    got = dw.dw_to((h.double(), lo.double()))
    assert float((got - exact).abs().max()) <= 1e-11 * float(
        exact.abs().max())
    assert torch.equal(dw.dw_to((h, lo)), h + lo)


def test_solve_refined_device_follows_jax():
    """Double-word refinement of an f32 one-level solve (DIA operator) on
    the JAX package's state: the same inner counts, the history to the
    f32 solves' agreement."""
    gen = jax_d2.generate(4, 40, 40, overlap=1, dtype=np.float32)
    opt = dict(tol=1e-3)
    jsch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                          options=JaxOptions(**opt))
    jstate = jsch.build()
    state = interop.state_from_numpy(jax_state_arrays(jstate), device="cpu",
                                     dtype=torch.float32)
    f = _rhs(gen.f, gen.n_loc, jsch.n_max, np.float32)
    f = np.asarray(jsch.exchange_rhs(jnp.asarray(f)))
    _, want = jax_solve_refined_device(jstate, jnp.asarray(f),
                                       opt=JaxOptions(**opt), tol=1e-10,
                                       max_refine=6)
    _, got = solve_refined_device(state, torch.as_tensor(f),
                                  opt=Options(**opt), tol=1e-10, max_refine=6)
    assert got["inner_iterations"] == want["inner_iterations"]
    assert got["history"][-1] <= 1e-10
    np.testing.assert_allclose(got["history"], want["history"], rtol=5e-2)


def test_flagship_example_runs_on_the_cpu(capsys):
    assert flagship.main(["-N", "4", "-Nx", "32", "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "double-word refinement" in out and "time to true 1e-8" in out


@pytest.mark.slow
def test_flagship_constants_are_the_jax_counts():
    """``FLAGSHIP_ITS``: the JAX package's counts at the full flagship512
    configuration (f64 at tol 1e-8; f32 at tol 1e-6 on its own f32 Lanczos
    vectors, jitted and run op by op, and on its f64 run's vectors), which
    examples/flagship.py and chip_smoke.py phase 15 hold the card to.
    About 100 s."""
    from hpddm_tpu.precond import geneo as jax_geneo
    got = {}
    vectors = None
    lanczos = jax_geneo.solve_gevp_lanczos
    for dtype in (np.float64, np.float32):
        kw = _kw(dtype)
        gen = jax_d2.generate_uniform(16, 512, 512, overlap=1,
                                      kappa=flagship.kappa, with_neumann=True,
                                      dtype=dtype)
        mats, f_list, neu, _ = jax_jacobi_scale(gen.mats, gen.f, gen.neumann)
        sch = jax_sz.Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d,
                             options=JaxOptions(**kw))
        sch.set_grid_geometry(gen.boxes, 512, 512)
        sch.solve_gevp(neu, method="lanczos")
        f = jnp.asarray(_rhs(f_list, gen.n_loc, sch.n_max, dtype))
        run = jax.jit(lambda st, b: jax_solve(st, b, opt=JaxOptions(**kw)))
        name = np.dtype(dtype).name
        got[name] = int(run(sch.build(), f).iterations)
        if dtype == np.float64:
            vectors = sch._deflation_vectors
        else:
            sch.set_vectors([np.asarray(v, dtype=np.float32)
                             for v in vectors])
            got["float32, f64 vectors"] = int(run(sch.build(), f).iterations)

            def op_by_op(*args, **kwargs):
                with jax.disable_jit():
                    return lanczos(*args, **kwargs)
            jax_geneo.solve_gevp_lanczos = op_by_op
            try:
                sch.solve_gevp(neu, method="lanczos")
            finally:
                jax_geneo.solve_gevp_lanczos = lanczos
            got["float32, GenEO op by op"] = int(
                run(sch.build(), f).iterations)
    assert got == flagship.FLAGSHIP_ITS, got
