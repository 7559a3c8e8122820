"""Port vs JAX package on the CPU in f64: Schwarz with the DST and
Chebyshev local solvers (slice 5d), iteration counts.

Each case builds the same problem in both packages. The Chebyshev bounds
come from a power iteration whose lo follows rounding on a wide spectrum
(tests/test_torch_fft_cheby.py, ROADMAP C17), so the port's state takes
the JAX package's lo and hi, and its count must then equal the JAX
package's exactly, with both recomputed relative residuals <= 1e-8 and
within 1e-9 of each other (the rounding floor of a contrast-1e4 system:
they come 2-3e-10 apart); the port's own bounds (its seeded start vector)
must come within 2 iterations of the JAX count.

* ``dst_cheby`` at ``generate_uniform(4, 128, 128)`` with
  ``tests/test_cheby.py``'s contrast-1e4 coefficient and 24 steps, one
  level; ``cheby`` with the Jacobi case's contrast-100 coefficient and 32
  steps (``tests/test_cheby.py:62``: at contrast 1e4 and 24 steps the
  Jacobi variant does not converge within 100 iterations in either
  package); Lanczos GenEO and ORAS in tests/test_torch_cheby_geneo.py;
* ``-hpddm_reuse_preconditioner`` keeps a Chebyshev solver across
  ``update_matrices``.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from hpddm_tpu.core.csr import MatrixCSR as JaxCSR
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.ops.cheby_solve import ChebyLocalSolver
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve

S, N = 4, 128


def kappa_channel(xx, yy):
    """``tests/test_cheby.py``'s channel and quadrant jump, contrast 1e4."""
    return (np.where((yy > 3.3) & (yy < 6.6), 1.0e4, 1.0)
            * np.where(xx > 5.0, 10.0, 1.0))


def kappa_jacobi(xx, yy):
    """``tests/test_cheby.py:62``'s contrast-100 channel."""
    return np.where((yy > 3.3) & (yy < 6.6), 100.0, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """The JAX package's solve compiles its GMRES loop around the unrolled
    Chebyshev steps anew on every call (21 s of a 26 s solve here);
    without XLA's optimization passes it takes about half, with the same
    operations. Restored for the modules that follow."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _robin(mats, d, cls):
    """Optimized local matrices: A + (1/h) on the rows where the POU is 0
    (the artificial boundary), h = 10/N."""
    return [cls(sp.csr_matrix(m.scipy() + (N / 10.0) * sp.diags(
        (np.asarray(ds) < 1e-12).astype(np.float64))))
        for m, ds in zip(mats, d)]


def _run(kind, kappa, steps, nu=0, variant="ras", optimized=False):
    """(JAX count, its relres, port count on the JAX bounds, its relres,
    port count on its own bounds, JAX lam, port lam, port Schwarz)."""
    kw = dict(tol=1e-8, local_solver=kind, local_cheby_steps=steps,
              schwarz_method=variant)
    if nu:
        kw.update(schwarz_coarse_correction="deflated", geneo_nu=nu)
    out = {}
    for pkg, d2, Sch, O, CSR in (
            ("jax", jax_d2, jax_sz.Schwarz, JaxOptions, JaxCSR),
            ("port", diffusion2d, sz.Schwarz, Options, MatrixCSR)):
        gen = d2.generate_uniform(S, N, N, overlap=1, kappa=kappa,
                                  with_neumann=bool(nu))
        extra = dict(optimized_mats=_robin(gen.mats, gen.d, CSR)) \
            if optimized else {}
        if pkg == "port":
            extra["device"] = "cpu"
        sch = Sch(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=O(**kw), **extra)
        sch.set_grid_geometry(gen.boxes, N, N)
        if pkg == "jax":
            if nu:
                sch.solve_gevp(gen.neumann)
            state = sch.build()
            f = jnp.asarray(diffusion2d.padded_rhs(gen.f, sch.n_max))
            res = jax_solve(state, f, opt=O(**kw))
            nb, nr = jax_sz.compute_residual(state, res.x, f)
            out.update(jits=int(res.iterations), jrel=float(nr[0] / nb[0]),
                       jlo=np.array(state.solver.lo),
                       jhi=np.array(state.solver.hi))
            continue
        if nu:
            sch.solve_gevp(gen.neumann)
        state = sch.build()
        f = torch.as_tensor(diffusion2d.padded_rhs(gen.f, sch.n_max))
        assert isinstance(state.solver, ChebyLocalSolver)
        res = solve(state, f, opt=Options(**kw))
        out["own"] = int(res.iterations)
        carried = dataclasses.replace(state, solver=dataclasses.replace(
            state.solver, lo=torch.as_tensor(out["jlo"]),
            hi=torch.as_tensor(out["jhi"])))
        res = solve(carried, f, opt=Options(**kw))
        nb, nr = sz.compute_residual(carried, res.x, f)
        out.update(pits=int(res.iterations), prel=float(nr[0] / nb[0]),
                   sch=sch, state=state)
    return out


def _assert_counts(out):
    assert out["pits"] == out["jits"], (out["pits"], out["jits"])
    # the recomputed residual of a contrast-1e4 system at tol 1e-8 is at
    # its rounding floor (cond(A) eps is about 1e-8 here): the packages'
    # summation orders put it 2-3e-10 apart at equal counts
    assert abs(out["prel"] - out["jrel"]) <= 1e-9
    assert max(out["prel"], out["jrel"]) <= 1e-8
    assert abs(out["own"] - out["jits"]) <= 2, (out["own"], out["jits"])


@pytest.mark.parametrize("kind,kappa,steps", [
    ("dst_cheby", kappa_channel, 24), ("cheby", kappa_jacobi, 32)],
    ids=["dst_cheby", "cheby"])
def test_one_level_counts_equal_jax(kind, kappa, steps):
    out = _run(kind, kappa, steps)
    _assert_counts(out)
    inner = out["state"].solver.inner
    assert (inner is None) == (kind == "cheby")


def test_reuse_keeps_the_chebyshev_solver():
    gen = diffusion2d.generate_uniform(S, 64, 64, overlap=1,
                                       kappa=kappa_channel)
    opt = Options(local_solver="dst_cheby", local_cheby_steps=8,
                  reuse_preconditioner=1, tol=1e-6, max_it=200)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=opt, device="cpu")
    sch.set_grid_geometry(gen.boxes, 64, 64)
    first = sch.build()
    sch.update_matrices([MatrixCSR(m.scipy() * 1.001) for m in gen.mats])
    again = sch.build()
    assert again.solver is first.solver and again.A is sch.A
    f = torch.as_tensor(diffusion2d.padded_rhs(gen.f, sch.n_max))
    res = solve(again, f, opt=opt)
    nb, nr = sz.compute_residual(again, res.x, f)
    assert bool(res.converged.all()) and float(nr[0] / nb[0]) < 1e-5
