"""Port vs JAX package: the whole main path on the CPU in f64.

Two-level GenEO-RAS (deflated, nu=10) + right-preconditioned GMRES (CGS,
restart 40) at tol 1e-6 and 1e-8. The port's iteration count must equal
the JAX package's exactly (both packages take the same steps; the first
crossing of the tolerance is far from a tie):

* at (4, 40, 40), each package with its own setup; the solutions agree at
  rtol 1e-7 (the two coarse spaces differ by an eigensolver-rounding basis
  change, and GMRES stops at tol 1e-6 or 1e-8, so the solutions agree to
  well below the tolerance);
* at the oracle (4, 100, 100), the port's runtime on the JAX package's own
  setup, carried over by ``interop.state_from_numpy``; the solutions agree
  at rtol 1e-10 (identical operators, only summation order differs). The
  oracle's dense GenEO costs each package tens of seconds on one core, so
  only the JAX package pays it here; the port's own setup is held to the
  same counts at the oracle on the card (``chip_smoke.py``).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.examples import schwarz as driver
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve
from test_torch_schwarz import jax_state_arrays

TOLS = (1e-6, 1e-8)


def root_chip_smoke():
    """The repository root's chip_smoke.py (the port's GPU smoke run),
    loaded by path: ``import chip_smoke`` can find ``tools/chip_smoke.py``
    instead, which tests/test_reference_parity.py puts first on sys.path
    when the whole suite is collected in one process."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("root_chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = root_chip_smoke()


def _rhs(gen, n_max):
    f = np.zeros((len(gen.n_loc), n_max, gen.f[0].shape[1]))
    for s in range(len(gen.n_loc)):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return f


def _jax_schwarz(S, N):
    """(JAX Schwarz setup after GenEO, rhs) for the main path at S
    subdomains of an N x N grid."""
    gen = jax_d2.generate(S, N, N, overlap=1, with_neumann=True)
    sch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=JaxOptions(
                             schwarz_coarse_correction="deflated",
                             geneo_nu=10))
    sch.solve_gevp(gen.neumann)
    return sch, _rhs(gen, sch.n_max)


def _jax_setup(S, N):
    """(JAX state, rhs) for the main path at S subdomains of an N x N grid."""
    sch, f = _jax_schwarz(S, N)
    return sch.build(), f


@pytest.fixture(scope="module")
def small():
    """(JAX state, the port's own state, rhs, rtol of x)."""
    jstate, f = _jax_setup(4, 40)
    gen = diffusion2d.generate(4, 40, 40, overlap=1, with_neumann=True)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(schwarz_coarse_correction="deflated",
                                     geneo_nu=10), device="cpu")
    sch.solve_gevp(gen.neumann)
    return jstate, sch.build(), f, 1e-7


@pytest.fixture(scope="module")
def oracle_schwarz():
    """(JAX Schwarz setup of the oracle after GenEO, rhs): GenEO paid once
    per module."""
    return _jax_schwarz(4, 100)


@pytest.fixture(scope="module")
def oracle(oracle_schwarz):
    """(JAX state, the port's copy of it, rhs, rtol of x)."""
    sch, f = oracle_schwarz
    jstate = sch.build()
    return (jstate,
            interop.state_from_numpy(jax_state_arrays(jstate), device="cpu"),
            f,
            1e-10)


_JAX_RESULTS = {}


def _jax_result(setup, tol):
    """The JAX solve of a setup at tol, computed once per module."""
    key = (id(setup), tol)
    if key not in _JAX_RESULTS:
        jstate, _, f, _ = setup
        _JAX_RESULTS[key] = jax_solve(jstate, jnp.asarray(f),
                                      opt=JaxOptions(tol=tol))
    return _JAX_RESULTS[key]


def _compare(setup, tol):
    _, state, f, rtol = setup
    jres = _jax_result(setup, tol)
    res = solve(state, torch.as_tensor(f), opt=Options(tol=tol))
    assert res.iterations == int(jres.iterations)
    assert bool(res.converged.all())
    want = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    nb, nr = sz.compute_residual(state, res.x, torch.as_tensor(f))
    assert float(nr[0] / nb[0]) <= 10 * tol
    return res.iterations


@pytest.mark.parametrize("tol", TOLS)
def test_small_iterations_and_solution(small, tol):
    _compare(small, tol)


@pytest.mark.parametrize("tol", TOLS)
def test_oracle_iterations_and_solution(oracle, tol):
    its = _compare(oracle, tol)
    assert its == {1e-6: 19, 1e-8: 22}[tol]


def test_chip_smoke_oracle_constants(oracle):
    """chip_smoke.py holds the card's f64 run to these counts: they must be
    the JAX package's CPU-f64 iteration counts at the oracle."""
    assert chip_smoke.ORACLE_ITS == {
        tol: int(_jax_result(oracle, tol).iterations) for tol in TOLS}


def test_driver_twin_exits_zero(capsys):
    argv = ["-N", "4", "-Nx", "40", "-Ny", "40", "-device", "cpu",
            "-hpddm_schwarz_coarse_correction", "deflated",
            "-hpddm_geneo_nu", "10", "-hpddm_verbosity", "1"]
    assert driver.main(argv) == 0
    out = capsys.readouterr().out
    assert "residual" in out and "GMRES converges after" in out


def test_driver_twin_one_level_random_rhs():
    assert driver.main(["-N", "4", "-Nx", "32", "-Ny", "32", "-device", "cpu",
                        "-generate_random_rhs", "2"]) == 0


@pytest.mark.parametrize("name", list(chip_smoke.MULTI_ITS))
def test_chip_smoke_multi_rhs_constants(oracle_schwarz, oracle, name):
    """chip_smoke.py holds the card's multi-RHS and block Krylov runs at the
    oracle to MULTI_ITS (and two residuals to MULTI_RES): they must be the
    JAX package's CPU-f64 counts per right-hand side, solve by solve of a
    sequence that shares one Options object. The JAX solves run without
    compiling their loops (``jax.disable_jit``), as in
    tests/test_torch_krylov.py."""
    from test_torch_krylov import jax_eager_solve
    sch, f1 = oracle_schwarz
    which, opts, setup, want = chip_smoke.MULTI_ITS[name]
    jstate = oracle[0]
    if setup:                       # setup options: a state of their own
        for k, v in setup.items():
            sch.opt[k] = v
        try:
            sch._state = None
            jstate = sch.build()
        finally:
            for k in setup:
                sch.opt.remove(k)
            sch._state = None
    if which == "f4":
        gen = jax_d2.generate(4, 100, 100, overlap=1, mu=4)
        f = np.asarray(jax_sz.scaled_exchange(
            jstate.dec, jnp.asarray(_rhs(gen, sch.n_max))))
    else:
        f = f1
    opt = JaxOptions(tol=1e-6, **opts)
    for k, want_k in enumerate(want):
        res = jax_eager_solve(jstate, f, opt)
        assert np.asarray(res.it_per_rhs).tolist() == want_k, (name, k)
        if name in chip_smoke.MULTI_RES:
            nb, nr = jax_sz.compute_residual(jstate, res.x, jnp.asarray(f))
            np.testing.assert_allclose(float(np.max(np.asarray(nr / nb))),
                                       chip_smoke.MULTI_RES[name], rtol=1e-3)
