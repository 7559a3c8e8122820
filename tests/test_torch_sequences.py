"""Port vs JAX package: the recycling sequence on the CPU in f64 (slice 5b).

* ``sequences.drifting_diffusion`` is byte-equal to the JAX package's.
* On the first three systems of the driver's sequence (GMRES(40) and
  GCRODR(40,20), tol 1e-10, the recycled pair carried across solves in
  the Options' storage), the port's GMRES total equals the JAX package's,
  and its GCRODR strategy A total lies within 5 of it: harmonic Ritz
  selection moves the JAX package's own counts by up to 5 under a 1e-15
  change of b (ROADMAP queue C, C5).
* The port's driver twin over the whole 10-system sequence lands in the
  reference-derived windows (GMRES 1871 +- 10, GCRODR strategy A 1561 +-
  25).

The JAX package's solves run op by op (``jax.disable_jit``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hpddm_tpu.models import sequences as jax_seq
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.solvers.base import LinearOperator as JaxLinearOperator
from hpddm_tpu.solvers.krylov import solve as jax_solve

from hpddm_tpu_torch.examples import driver
from hpddm_tpu_torch.models import sequences
from hpddm_tpu_torch.options import Options

PREFIX = 3


@pytest.mark.parametrize("kw", [dict(), dict(n_sys=4, nx=7, ny=5, seed=3,
                                             mass=0.5)])
def test_drifting_diffusion_is_byte_equal(kw):
    got, want = sequences.drifting_diffusion(**kw), \
        jax_seq.drifting_diffusion(**kw)
    assert len(got) == len(want) == kw.get("n_sys", 10)
    for (A, b), (jA, jb) in zip(got, want):
        for k in ("data", "indices", "indptr"):
            a, j = getattr(A, k), getattr(jA, k)
            assert a.dtype == j.dtype and np.array_equal(a, j)
        assert b.dtype == jb.dtype and np.array_equal(b, jb)


def _jax_totals(n_sys):
    """The JAX driver's loop (``examples/driver.py``) over the first
    ``n_sys`` systems: (GMRES total, GCRODR total)."""
    opt_r = JaxOptions(krylov_method="gcrodr", recycle=20, tol=1e-10,
                       max_it=1000, gmres_restart=40)
    opt_g = opt_r.copy()
    opt_g["krylov_method"] = "gmres"
    total_g = total_r = 0
    for A, rhs in jax_seq.drifting_diffusion(n_sys=10, nx=45,
                                             ny=45)[:n_sys]:
        Ad = jnp.asarray(A.todense())
        op = JaxLinearOperator(
            gmv=lambda x, Ad=Ad: jnp.einsum("nk,skm->snm", Ad, x))
        b = jnp.asarray(np.asarray(rhs)[None, :, None])
        with jax.disable_jit():
            total_g += int(jax_solve(op, b, opt=opt_g).iterations)
            total_r += int(jax_solve(op, b, opt=opt_r).iterations)
    return total_g, total_r


def test_sequence_prefix_totals_follow_jax():
    want_g, want_r = _jax_totals(PREFIX)
    got_g, got_r, cfg = driver.totals(Options(), torch.device("cpu"),
                                      n_sys=PREFIX)
    assert cfg == (40, 20, 1e-10)
    assert got_g == want_g, (got_g, want_g)
    assert abs(got_r - want_r) <= 5, (got_r, want_r)
    assert got_r < got_g


def test_driver_windows_on_the_whole_sequence(capsys):
    """The driver twin's exit code: GCRODR below GMRES and both totals in
    the reference-derived windows (about 7 s on one core)."""
    assert driver.main(["-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "GMRES(40) = " in out and "GCRODR(40,20) = " in out
