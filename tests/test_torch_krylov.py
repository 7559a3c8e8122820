"""Port vs JAX package: the Krylov dispatch on the CPU in f64.

Every case runs the JAX package's ``solve`` and the port's on identical
operators (the JAX-built two-level GenEO-RAS state, 40x40 grid, S=4,
nu=10, deflated, carried over by ``interop.state_from_numpy``) with the
same numpy-seeded right-hand sides: four random consistent ones
(``diffusion2d.generate(..., mu=4)``) or the closed-form single one. The
iteration counts per right-hand side must be equal, and the solutions agree
at rtol 1e-8 / atol 1e-10 (the same steps in f64, summed in another order;
the first crossing of the tolerance is far from a tie).

The JAX package's solves run under ``jax.disable_jit()``: the same
functions, one operation at a time, which spares the compile of every
solve's loops (seconds each on one core) and leaves the arithmetic as it
is.

Cases: GMRES left / right / flexible x CGS / MGS / CGS2, Richardson, CG
(its GMRES fallback under RAS, and CG proper with a one-level ASM), the
enlarged Krylov subspace, ``none``, factors in f32 (``build(dtype=...)``)
and the f32 coarse operator (``-hpddm_coarse_dtype float32``), which
switches GMRES to its flexible variant.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve
from test_torch_schwarz import jax_state_arrays

S, N = 4, 40
RTOL, ATOL = 1e-8, 1e-10


def rhs(gen, n_max):
    f = np.zeros((S, n_max, gen.f[0].shape[1]))
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return f


@pytest.fixture(scope="module")
def problem():
    """(JAX Schwarz setup, four consistent random right-hand sides, the
    closed-form right-hand side), GenEO paid once."""
    gen = jax_d2.generate(S, N, N, overlap=1, with_neumann=True, mu=4)
    sch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=JaxOptions(
                             schwarz_coarse_correction="deflated",
                             geneo_nu=10))
    sch.solve_gevp(gen.neumann)
    f4 = np.asarray(sch.exchange_rhs(jnp.asarray(rhs(gen, sch.n_max))))
    f1 = rhs(jax_d2.generate(S, N, N, overlap=1), sch.n_max)
    return sch, f4, f1


def states(sch, **build):
    """(JAX state, the port's copy of it) of the setup, rebuilt."""
    sch._state = None
    jstate = sch.build(**build)
    return jstate, interop.state_from_numpy(jax_state_arrays(jstate),
                                            device="cpu")


def jax_eager_solve(jstate, f, opt):
    """The JAX package's solve, run without compiling its loops."""
    with jax.disable_jit():
        return jax_solve(jstate, jnp.asarray(f), opt=opt)


def compare(jstate, state, f, rtol=RTOL, atol=ATOL, **opts):
    """Solve with both packages; equal iteration counts per right-hand
    side, solutions within rtol / atol. Returns the port's result."""
    jres = jax_eager_solve(jstate, f, JaxOptions(**opts))
    res = solve(state, torch.as_tensor(f), opt=Options(**opts))
    assert res.it_per_rhs.tolist() == np.asarray(jres.it_per_rhs).tolist()
    assert res.iterations == int(jres.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=rtol,
                               atol=atol)
    return res


@pytest.fixture(scope="module")
def ras(problem):
    sch, f4, f1 = problem
    sch.opt["schwarz_method"] = "ras"
    return states(sch) + (f4, f1)


@pytest.mark.parametrize("ortho", ["cgs", "mgs", "cgs2"])
@pytest.mark.parametrize("variant", ["left", "right", "flexible"])
def test_gmres_variant_ortho(ras, variant, ortho):
    jstate, state, f4, _ = ras
    compare(jstate, state, f4, tol=1e-6, variant=variant,
            orthogonalization=ortho)


@pytest.mark.parametrize("method,f,opts", [
    ("richardson", "f4", {}),
    ("richardson", "f4", {"richardson_damping_factor": 0.8}),
    ("cg", "f1", {}),                       # RAS + deflated: GMRES instead
    ("gmres", "f1", {"enlarge_krylov_subspace": 4}),         # as bgmres
    ("cg", "f1", {"enlarge_krylov_subspace": 2}),            # as bcg
    ("none", "f4", {}),
])
def test_methods(ras, method, f, opts):
    jstate, state, f4, f1 = ras
    res = compare(jstate, state, {"f4": f4, "f1": f1}[f], tol=1e-6,
                  krylov_method=method, **opts)
    assert tuple(res.x.shape) == {"f4": f4, "f1": f1}[f].shape


def test_cg_with_symmetric_preconditioner(problem):
    """CG proper: one-level ASM is symmetric, so no fallback."""
    sch, f4, _ = problem
    sch.opt["schwarz_method"] = "asm"
    sch.opt.remove("schwarz_coarse_correction")
    try:
        jstate, state = states(sch)
    finally:
        sch.opt["schwarz_method"] = "ras"
        sch.opt["schwarz_coarse_correction"] = "deflated"
    compare(jstate, state, f4, tol=1e-6, krylov_method="cg", max_it=200)


def test_factors_in_float32(problem):
    """``build(dtype=float32)``: f32 local factors and deflation vectors
    under an f64 operator and f64 Krylov vectors, each product promoted."""
    sch, _, f1 = problem
    jstate, state = states(sch, dtype=np.float32)
    assert state.solver.factor.dtype == torch.float32
    assert state.coarse.Z.dtype == torch.float32
    compare(jstate, state, f1, tol=1e-6)


def test_coarse_dtype_float32_switches_to_flexible(problem):
    """``-hpddm_coarse_dtype float32``: the coarse operator's inverse in
    f32 makes M^-1 vary, so GMRES runs flexible in both packages. The f32
    coarse products are summed in another order by the two packages, which
    perturbs each application of M^-1 by about f32's epsilon; the
    solutions are held at rtol 1e-5 for that reason."""
    sch, _, f1 = problem
    sch.opt["coarse_dtype"] = "float32"
    try:
        jstate, state = states(sch)
    finally:
        sch.opt.remove("coarse_dtype")
    assert state.coarse.E_inv.dtype == torch.float32
    res = compare(jstate, state, f1, rtol=1e-5, atol=1e-7, tol=1e-6)
    nb, nr = sz.compute_residual(state, res.x, torch.as_tensor(f1))
    assert float(nr[0] / nb[0]) < 1e-5


def test_own_setup_coarse_dtype_and_factor_dtype(problem):
    """The port's own setup takes both options: the coarse inverse in f32,
    the factors and deflation vectors in f32, and solves to the JAX
    package's iteration count (the two GenEO bases differ by rounding)."""
    from hpddm_tpu_torch.models import diffusion2d
    sch_j, _, f1 = problem
    gen = diffusion2d.generate(S, N, N, overlap=1, with_neumann=True)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(schwarz_coarse_correction="deflated",
                                     geneo_nu=10, coarse_dtype="float32"),
                     device="cpu")
    sch.solve_gevp(gen.neumann)
    state = sch.build(dtype=np.float32)
    assert state.coarse.E_inv.dtype == state.solver.factor.dtype \
        == torch.float32
    sch_j.opt["coarse_dtype"] = "float32"
    try:
        sch_j._state = None
        jstate = sch_j.build(dtype=np.float32)
    finally:
        sch_j.opt.remove("coarse_dtype")
    jres = jax_eager_solve(jstate, f1, JaxOptions(tol=1e-6))
    res = solve(state, torch.as_tensor(f1), opt=Options(tol=1e-6))
    assert res.iterations == int(jres.iterations)
    nb, nr = sz.compute_residual(state, res.x, torch.as_tensor(f1))
    assert float(nr[0] / nb[0]) < 1e-5
