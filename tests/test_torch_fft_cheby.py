"""Port vs JAX package on the CPU in f64: the DST and Chebyshev local
solvers (slice 5d, ``ops/fft_solve.py`` and ``ops/cheby_solve.py``).

* ``dst1`` equals the JAX package's to 1e-13 at lengths 17 and 258 (the
  card cell's boxes: an odd extension of 518, not a power of two) and is
  its own inverse up to 2/(m+1) to 1e-12.
* The DST solve is exact on a single separable block (1e-10,
  ``tests/test_fft_solver.py:23``); the matmul and FFT modes agree to
  1e-12 on mixed box sizes (``tests/test_fft_solver.py:99``), and each
  mode's ``solve`` equals the JAX package's on the same state carried
  through ``interop.dst_solver_from_numpy`` (1e-12); ``mode="auto"``
  switches at 128 a side; pad rows stay 0.
* A ``ChebyLocalSolver`` (DST and Jacobi inner solves) carried from the
  JAX package solves as the JAX package's does (1e-12), and is linear
  (``tests/test_cheby.py:99``).
* ``build_cheby_solver``'s bounds with the JAX package's start vector
  (``v0``) at 1e-10 relative where the estimate is determined: the
  constant coefficient, and a smooth coefficient at 10 power steps. The
  shifted power iteration starts from the lmax vector, in which the
  lowest modes of a wide spectrum are below rounding after 30 steps: there
  lo follows rounding (the JAX package's own jitted and op-by-op runs of
  the same call differ by 20%, ROADMAP queue C, C17) and only hi is held;
  the Schwarz-level counts of tests/test_torch_fft_cheby_schwarz.py carry
  the JAX package's bounds.
* The FFT-RAS oracle (100x100, S=4, one level) takes the JAX package's
  count, which is smoke phase 23 (a)'s constant ``FFT_ORACLE_ITS``.
* Complex matrices raise ``TypeError`` for fft/cheby/dst_cheby (C16).
* The driver twin ``examples/hetero.py`` runs at -device cpu and exits 0.
* ``-m slow``: the JAX package's Chebyshev bounds (``HETERO_JAX_BOUNDS``)
  and counts by start vector (``HETERO_JAX_ITS``) at the twin's full
  cell, which bound smoke phase 23 (b), and the port's count there on the
  JAX package's bounds (equal).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.ops import cheby_solve as jax_cs
from hpddm_tpu.ops import fft_solve as jax_fs
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.precond import schwarz as jax_sz
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.examples import hetero
from hpddm_tpu_torch.models import diffusion2d, helmholtz
from hpddm_tpu_torch.ops import cheby_solve as cs
from hpddm_tpu_torch.ops import fft_solve as fs
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.precond import schwarz as sz
from hpddm_tpu_torch.solvers.krylov import solve
from test_torch_gmres import chip_smoke

S = 4


def jax_dst_arrays(sol):
    """The leaves of a JAX DST solver, for
    ``interop.dst_solver_from_numpy``."""
    if hasattr(sol, "Uy"):
        out = {k: np.asarray(getattr(sol, k)) for k in (
            "Uy", "Ux", "inv_eigs", "idx_fwd", "msk_fwd", "idx_inv",
            "msk_inv")}
        out.update(wy_max=sol.wy_max, wx_max=sol.wx_max)
    else:
        out = dict(inv_eigs=tuple(np.asarray(a) for a in sol.inv_eigs),
                   members=sol.members, shapes=sol.shapes)
    out.update(n_max=sol.n_max, S=sol.S)
    return out


def jax_cheby_arrays(sol):
    """The leaves of a JAX ``ChebyLocalSolver``, for
    ``interop.cheby_solver_from_numpy``."""
    A = sol.A
    out = dict(A_values=np.asarray(A.values), lo=np.asarray(sol.lo),
               hi=np.asarray(sol.hi), k=sol.k,
               dinv=None if sol.dinv is None else np.asarray(sol.dinv),
               scale=None if sol.scale is None else np.asarray(sol.scale),
               inner=None if sol.inner is None else
               jax_dst_arrays(sol.inner))
    if hasattr(A, "cols"):
        out["A_cols"] = np.asarray(A.cols)
    else:
        out.update(A_offsets=A.offsets, A_canvas_hw=A.canvas_hw)
    return out


def kappa_smooth(xx, yy):
    return 1.0 + 0.5 * np.sin(xx) * np.cos(yy)


@pytest.mark.parametrize("m", [17, 258])
def test_dst1_matches_jax_and_inverts(m):
    x = np.random.default_rng(m).normal(size=(3, m, 2))
    for dim in (1, 0, -1):
        y = fs.dst1(torch.as_tensor(x), dim=dim).numpy()
        np.testing.assert_allclose(
            y, np.asarray(jax_fs.dst1(jnp.asarray(x), axis=dim)), rtol=0,
            atol=1e-13 * np.abs(y).max())
    back = fs.dst1(fs.dst1(torch.as_tensor(x), dim=1), dim=1) * \
        (2.0 / (m + 1))
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-12)
    assert fs.dst1(torch.as_tensor(x, dtype=torch.float32)).dtype == \
        torch.float32


def test_fft_exact_on_separable_block():
    gen = diffusion2d.generate(1, 24, 24, overlap=1)
    for mode in ("fft", "matmul"):
        solver = fs.build_fft_solver(gen.boxes, 24, 24, gen.n_loc[0],
                                     dtype=torch.float64, mode=mode,
                                     device="cpu")
        b = np.random.default_rng(1).normal(size=(1, gen.n_loc[0], 1))
        x = solver.solve(torch.as_tensor(b)).numpy()
        r = b[0, :, 0] - gen.mats[0].scipy() @ x[0, :, 0]
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10, mode


@pytest.fixture(scope="module")
def mixed_boxes():
    """Mixed box sizes (overlap 2 at 100x100, S=4) with one padded row
    past the largest box, and a random panel."""
    gen = jax_d2.generate(S, 100, 100, overlap=2)
    n_max = max(gen.n_loc) + 1
    b = np.random.default_rng(0).normal(size=(S, n_max, 2))
    return gen.boxes, n_max, b


@pytest.mark.parametrize("mode", ["fft", "matmul"])
def test_dst_modes_match_each_other_and_jax(mixed_boxes, mode):
    boxes, n_max, b = mixed_boxes
    sol = fs.build_fft_solver(boxes, 100, 100, n_max, dtype=torch.float64,
                              mode=mode, device="cpu")
    other = fs.build_fft_solver(boxes, 100, 100, n_max,
                                dtype=torch.float64, device="cpu",
                                mode="matmul" if mode == "fft" else "fft")
    x = sol.solve(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, other.solve(torch.as_tensor(b)).numpy(),
                               rtol=0, atol=1e-12)
    jsol = jax_fs.build_fft_solver(boxes, 100, 100, n_max,
                                   dtype=jnp.float64, mode=mode)
    jx = np.asarray(jsol.solve(jnp.asarray(b)))
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12)
    carried = interop.dst_solver_from_numpy(jax_dst_arrays(jsol),
                                            device="cpu")
    assert type(carried) is type(sol)
    np.testing.assert_allclose(carried.solve(torch.as_tensor(b)).numpy(),
                               jx, rtol=0, atol=1e-12)
    n_loc = [(i1 - i0) * (j1 - j0) for (i0, i1, j0, j1) in boxes]
    assert all(np.all(x[s, n:] == 0) for s, n in enumerate(n_loc))


def test_auto_mode_switches_at_128():
    small = [(0, 128, 0, 100)] * 2
    big = [(0, 129, 0, 10), (0, 10, 0, 10)]
    assert isinstance(fs.build_fft_solver(small, 256, 200, 128 * 100,
                                          device="cpu"), fs.DSTMatmulSolver)
    assert isinstance(fs.build_fft_solver(big, 258, 20, 1290,
                                          device="cpu"), fs.FFTLocalSolver)


@pytest.fixture(scope="module")
def jax_cheby_states():
    """The JAX package at generate_uniform(4, 64, 64) with the smooth
    coefficient: (its Schwarz, the generator, the DST solve, the dst_cheby
    and the cheby ChebyLocalSolver, k=12)."""
    gen = jax_d2.generate_uniform(S, 64, 64, overlap=1, kappa=kappa_smooth)
    sch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=JaxOptions())
    sch.set_grid_geometry(gen.boxes, 64, 64)
    inner = jax_fs.build_fft_solver(gen.boxes, 64, 64, sch.n_max,
                                    dtype=jnp.float64)
    rm = sch.dec.row_mask
    return (sch, gen, inner,
            jax_cs.build_cheby_solver(sch.A, rm, inner=inner, k=12),
            jax_cs.build_cheby_solver(sch.A, rm, k=12))


@pytest.mark.parametrize("which", [3, 4], ids=["dst_cheby", "cheby"])
def test_cheby_solve_matches_jax_and_is_linear(jax_cheby_states, which):
    jsol = jax_cheby_states[which]
    sol = interop.cheby_solver_from_numpy(jax_cheby_arrays(jsol),
                                          device="cpu")
    assert (sol.inner is None) == (which == 4)
    rng = np.random.default_rng(which)
    x = rng.normal(size=(S, sol.A.n_max, 3))
    y = rng.normal(size=x.shape)
    got = sol.solve(torch.as_tensor(x)).numpy()
    want = np.asarray(jsol.solve(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    lhs = sol.solve(torch.as_tensor(1.7 * x - 0.4 * y)).numpy()
    rhs = 1.7 * got - 0.4 * sol.solve(torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kappa,power_its", [(None, 30), (kappa_smooth, 10)],
                         ids=["constant-30", "smooth-10"])
def test_cheby_bounds_match_jax_with_its_start_vector(kappa, power_its):
    gen = jax_d2.generate_uniform(S, 64, 64, overlap=1, kappa=kappa)
    sch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=JaxOptions())
    inner = jax_fs.build_fft_solver(gen.boxes, 64, 64, sch.n_max,
                                    dtype=jnp.float64)
    jsol = jax_cs.build_cheby_solver(sch.A, sch.dec.row_mask, inner=inner,
                                     k=12, power_its=power_its)
    A = interop._matrix({"A_values": np.asarray(sch.A.values),
                         "A_offsets": sch.A.offsets}, sch.n_max, "cpu",
                        torch.float64)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                      (S, sch.n_max, 1), jnp.float64))
    sol = cs.build_cheby_solver(
        A, torch.as_tensor(np.asarray(sch.dec.row_mask)),
        inner=fs.build_fft_solver(gen.boxes, 64, 64, sch.n_max,
                                  dtype=torch.float64, device="cpu"),
        k=12, power_its=power_its, v0=torch.as_tensor(v0))
    np.testing.assert_allclose(sol.lo.numpy(), np.asarray(jsol.lo),
                               rtol=1e-10)
    np.testing.assert_allclose(sol.hi.numpy(), np.asarray(jsol.hi),
                               rtol=1e-10)
    np.testing.assert_allclose(sol.scale.numpy(), np.asarray(jsol.scale),
                               rtol=1e-15)


def test_own_start_vector_and_hi(jax_cheby_states):
    """From the port's own start vector (its seeded generator) hi comes
    within 2% of the JAX package's (30 power steps do not converge it to
    rounding on every subdomain: 1.1% apart on one here), lo is a positive
    bound below hi, and a rebuild draws the same vector."""
    sch, gen, _, jsol, _ = jax_cheby_states
    psch = sz.Schwarz(diffusion2d.generate_uniform(
        S, 64, 64, overlap=1, kappa=kappa_smooth).mats, gen.neighbors,
        gen.mappings, d=gen.d, options=Options(local_solver="dst_cheby",
                                               local_cheby_steps=12),
        device="cpu")
    psch.set_grid_geometry(gen.boxes, 64, 64)
    sol = psch.build().solver
    assert isinstance(sol, cs.ChebyLocalSolver) and sol.k == 12
    np.testing.assert_allclose(sol.hi.numpy(), np.asarray(jsol.hi),
                               rtol=2e-2)
    assert torch.all((sol.lo > 0) & (sol.lo < sol.hi))
    again = psch.build().solver
    assert torch.equal(again.lo, sol.lo)


def test_jacobi_diagonal_in_every_format(jax_cheby_states):
    """``_extract_dinv`` reads the same diagonal from DIA (a canvas batch
    too), ELL and dense."""
    from hpddm_tpu_torch.core.formats import pack_local_matrices
    sch, gen, _, _, jsol = jax_cheby_states
    mats = diffusion2d.generate_uniform(S, 64, 64, overlap=1,
                                        kappa=kappa_smooth).mats
    want = np.asarray(jsol.dinv)
    for fmt in ("dia", "ell", "dense"):
        A = pack_local_matrices(mats, n_max=sch.n_max, fmt=fmt,
                                device="cpu")
        np.testing.assert_array_equal(
            cs._extract_dinv(A, sch.n_max).numpy(), want)
    A = dataclasses.replace(pack_local_matrices(mats, n_max=sch.n_max,
                                                device="cpu"),
                            canvas_hw=(66, 66))
    np.testing.assert_array_equal(cs._extract_dinv(A, sch.n_max).numpy(),
                                  want)


@pytest.fixture(scope="module")
def oracle_counts():
    """(JAX, port) one-level FFT-RAS counts at the 100x100, S=4 oracle
    (``tests/test_fft_solver.py:38``), and the port's state."""
    counts, state = [], None
    for pkg in (jax_d2, diffusion2d):
        gen = pkg.generate(S, 100, 100, overlap=1)
        if pkg is jax_d2:
            opt = JaxOptions(local_solver="fft")
            sch = jax_sz.Schwarz(gen.mats, gen.neighbors, gen.mappings,
                                 d=gen.d, options=opt)
        else:
            opt = Options(local_solver="fft")
            sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                             options=opt, device="cpu")
        sch.set_grid_geometry(gen.boxes, 100, 100)
        f = diffusion2d.padded_rhs(gen.f, sch.n_max)
        st = sch.build()
        if pkg is jax_d2:
            res = jax_solve(st, jnp.asarray(f), opt=opt)
            nb, nr = jax_sz.compute_residual(st, res.x, jnp.asarray(f))
        else:
            state = st
            res = solve(st, torch.as_tensor(f), opt=opt)
            nb, nr = sz.compute_residual(st, res.x, torch.as_tensor(f))
        assert float(nr[0] / nb[0]) < 1e-2
        counts.append(int(res.iterations))
    return counts, state


def test_fft_oracle_counts_equal_jax_and_smoke_constant(oracle_counts):
    (jits, pits), state = oracle_counts
    assert isinstance(state.solver, fs.DSTMatmulSolver)
    assert pits == jits == chip_smoke.FFT_ORACLE_ITS <= 45


@pytest.mark.parametrize("kind", ["fft", "cheby", "dst_cheby"])
def test_complex_matrices_raise(kind):
    gen = helmholtz.generate(S, 20, 20)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(local_solver=kind), device="cpu")
    sch.set_grid_geometry(gen.boxes, 20, 20)
    with pytest.raises(TypeError, match="C16"):
        sch.build()


@pytest.mark.parametrize("kind,lanczos", [("fft", False),
                                          ("dst_cheby", False),
                                          ("dst_cheby", True)],
                         ids=["fft", "dst_cheby", "lanczos dst_cheby"])
def test_renumbered_layout_raises(kind, lanczos):
    """The DST solve reads rows in box order: grid geometry on the
    interface-first layout raises, where the JAX package reads its
    permuted rows as box rows."""
    gen = diffusion2d.generate_uniform(S, 20, 20, overlap=1,
                                       with_neumann=lanczos)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(local_solver=kind, geneo_nu=4),
                     renumber=True, device="cpu")
    sch.set_grid_geometry(gen.boxes, 20, 20)
    with pytest.raises(ValueError, match="non-renumbered"):
        if lanczos:
            sch.solve_gevp(gen.neumann, method="lanczos")
        else:
            sch.build()


def test_hetero_twin_runs_on_cpu(capsys):
    assert hetero.main(["-N", "4", "-Nx", "64", "-hpddm_geneo_nu", "6",
                        "-hpddm_local_cheby_steps", "12",
                        "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dst_cheby (k=12)" in out and "iterations" in out


@pytest.mark.slow
def test_hetero_smoke_bounds_are_the_jax_bounds():
    """``HETERO_JAX_BOUNDS``, the Chebyshev bounds that smoke phase 23 (b)
    carries into the port's solver: the JAX package's at
    examples/hetero.py's cell (Jacobi-scaled, dst_cheby k=32, 30 power
    steps, its default start vector) on the CPU; about 25 s."""
    from hpddm_tpu.core.scaling import jacobi_scale

    S, N = 16, 1024
    gen = jax_d2.generate_uniform(S, N, N, overlap=1, kappa=hetero.kappa)
    mats = jacobi_scale(gen.mats)[0]
    sch = jax_sz.Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=JaxOptions(local_solver="dst_cheby",
                                            local_cheby_steps=32))
    sch.set_grid_geometry(gen.boxes, N, N)
    sol = sch.build().solver
    assert {"lo": np.asarray(sol.lo).tolist(),
            "hi": np.asarray(sol.hi).tolist()} == chip_smoke.HETERO_JAX_BOUNDS


@pytest.mark.slow
def test_hetero_port_count_on_the_jax_bounds():
    """The port on the CPU at examples/hetero.py's full cell, its
    Chebyshev bounds replaced by the JAX package's (``HETERO_JAX_BOUNDS``),
    takes the JAX package's count ``HETERO_JAX_ITS[7]`` exactly, residual
    <= 1e-8; smoke phase 23 (b) holds the card within 1 of it. About 4
    minutes."""
    S, N = 16, 1024
    opt = Options(tol=1e-8, **hetero.DEFAULTS)
    sch, f, _ = hetero.setup(S, N, opt, np.float64, "cpu")
    state = sch.build()
    bounds = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in chip_smoke.HETERO_JAX_BOUNDS.items()}
    state = dataclasses.replace(state, solver=dataclasses.replace(
        state.solver, **bounds))
    res = solve(state, f, opt=opt)
    nb, nr = sz.compute_residual(state, res.x, f)
    assert float(nr[0] / nb[0]) <= 1e-8
    assert res.iterations == chip_smoke.HETERO_JAX_ITS[7]


@pytest.mark.slow
def test_hetero_smoke_constants_are_the_jax_counts():
    """``HETERO_JAX_ITS``, the counts that bound smoke phase 23 (b): the
    JAX package's run of examples/hetero.py's cell (tools/bench_hetero.py's
    configuration in f64, its solve jitted with the state as an argument)
    on the CPU, with the Chebyshev bounds of each start vector's seed;
    about 45 minutes and 6 GB. With seed 6 the solve stops unconverged at
    its max_it of 100."""
    from hpddm_tpu.core.scaling import jacobi_scale

    S, N = 16, 1024
    gen = jax_d2.generate_uniform(S, N, N, overlap=1, kappa=hetero.kappa,
                                  with_neumann=True)
    mats, f_list, neumann, _ = jacobi_scale(gen.mats, gen.f, gen.neumann)
    opt = JaxOptions(tol=1e-8, **hetero.DEFAULTS)
    sch = jax_sz.Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d,
                         options=opt)
    sch.set_grid_geometry(gen.boxes, N, N)
    sch.solve_gevp(neumann, method="lanczos")
    state = sch.build()
    f = jnp.asarray(diffusion2d.padded_rhs(f_list, sch.n_max))
    run = jax.jit(lambda st, b: jax_solve(st, b, opt=opt))
    counts = {}
    for seed in chip_smoke.HETERO_JAX_ITS:
        sol = jax_cs.build_cheby_solver(
            state.solver.A, sch.dec.row_mask, inner=state.solver.inner,
            k=state.solver.k, power_its=30, seed=seed)
        st = dataclasses.replace(state, solver=sol)
        res = run(st, f)
        nb, nr = jax_sz.compute_residual(st, res.x, f)
        counts[seed] = int(res.iterations)
        assert (float(nr[0] / nb[0]) <= 1e-8) == (counts[seed] < 100)
    assert counts == chip_smoke.HETERO_JAX_ITS
