"""Port vs JAX package: the grid runtime on the CPU in f64 (slice 3b).

* ``build_grid_plan`` gives the JAX package's plan (every field), and
  refuses the same decompositions.
* ``grid_exchange`` equals the JAX package's value for value at mu = 1, 2,
  3 on uniform grids (``generate_uniform``) and on 2x2 ``generate`` grids
  (overlap 1 and 3, t > 2 overlap), through the static shifts of a
  regular grid and the one-hot take of an irregular one; it agrees with
  the port's general exchange to 1e-13, as the JAX package's two
  exchanges do (``tests/test_grid_exchange.py:37-45``).
* ``Schwarz.set_grid_geometry`` routes ``exchange`` through the slab plan:
  the port's exchange on that decomposition equals the JAX package's.
* ``spmm_dia_canvas`` equals the JAX package's and the flat plain form;
  an operator with a seam coupling keeps the flat form in both.
* ``gmv`` on ``operator_state`` equals the JAX package's, also on a JAX
  state carried across by ``interop``.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from hpddm_tpu.core.csr import MatrixCSR as JaxCSR
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.ops import spmv as jax_spmv
from hpddm_tpu.parallel import grid as jax_grid
from hpddm_tpu.parallel import ops as jax_ops
from hpddm_tpu.precond import schwarz as jax_sz

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.ops import spmv
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel import grid
from hpddm_tpu_torch.parallel.ops import exchange
from hpddm_tpu_torch.precond import schwarz as sz
from test_torch_schwarz import jax_state_arrays

PROBLEMS = {
    "uniform 9 24x24 overlap 2": ("generate_uniform", (9, 24, 24), 2),
    "uniform 16 64x64 overlap 1": ("generate_uniform", (16, 64, 64), 1),
    "2x2 100x100 overlap 1": ("generate", (4, 100, 100), 1),
    "2x2 100x100 overlap 3": ("generate", (4, 100, 100), 3),
}


def _pair(key):
    """(JAX Schwarz, port Schwarz, generator name) with
    set_grid_geometry."""
    fn, args, overlap = PROBLEMS[key]
    jgen = getattr(jax_d2, fn)(*args, overlap=overlap)
    gen = getattr(diffusion2d, fn)(*args, overlap=overlap)
    jsch = jax_sz.Schwarz(jgen.mats, jgen.neighbors, jgen.mappings,
                          d=jgen.d, options=JaxOptions())
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=Options(), device="cpu")
    for s in (jsch, sch):
        s.set_grid_geometry(gen.boxes, args[1], args[2])
    return jsch, sch, fn


@pytest.fixture(scope="module", params=list(PROBLEMS))
def pair(request):
    return _pair(request.param)


def _plans_equal(p, q):
    for k in ("nbr", "sxw", "syw", "onehot"):
        np.testing.assert_array_equal(getattr(p, k).numpy(),
                                      np.asarray(getattr(q, k)))
    for k in ("H", "W", "t", "S", "gx", "gy", "regular", "sxw_s", "syw_s"):
        assert getattr(p, k) == getattr(q, k), k


def test_grid_plan_fields_equal_jax(pair):
    jsch, sch, fn = pair
    assert sch.dec.grid is not None and jsch.dec.grid is not None
    _plans_equal(sch.dec.grid, jsch.dec.grid)
    # generate's operators fail the seam check: no canvas in either
    assert sch.A.canvas_hw == jsch.A.canvas_hw
    assert (sch.A.canvas_hw is None) == (fn == "generate")


@pytest.mark.parametrize("boxes", [
    [(0, 10, 0, 10), (8, 20, 0, 10)],
    [(0, 10, 0, 10), (4, 14, 0, 10), (8, 18, 0, 10)],
    [(0, 10, 0, 3), (5, 15, 0, 3)],
    [(0, 4, 0, 4), (0, 4, 4, 8)],
    [(0, 10, 0, 10), (8, 18, 0, 10), (16, 26, 0, 10)],
], ids=["sizes differ", "non-adjacent overlap", "strip not below H",
        "no overlap", "three in a row"])
def test_plan_refused_where_jax_refuses(boxes):
    p, q = grid.build_grid_plan(boxes, device="cpu"), \
        jax_grid.build_grid_plan(boxes)
    assert (p is None) == (q is None)
    if p is not None:
        _plans_equal(p, q)


@pytest.mark.parametrize("mu", [1, 2, 3])
def test_grid_exchange_equals_jax_and_general(pair, mu):
    jsch, sch, _ = pair
    x = np.random.default_rng(mu).normal(size=(sch.dec.S, sch.dec.n_max, mu))
    got = grid.grid_exchange(sch.dec.grid, torch.as_tensor(x)).numpy()
    want = np.asarray(jax_grid.grid_exchange(jsch.dec.grid, jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    general = exchange(dataclasses.replace(sch.dec, grid=None),
                       torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, general, rtol=0.0, atol=1e-13)


def test_irregular_grid_one_hot_take_equals_jax():
    """Subdomains numbered against the process grid take the one-hot
    path: the same plan and values as the JAX package on the same x."""
    gen = diffusion2d.generate_uniform(9, 24, 24, overlap=2)
    boxes = [gen.boxes[i] for i in (4, 0, 8, 1, 7, 2, 6, 3, 5)]
    p = grid.build_grid_plan(boxes, device="cpu")
    q = jax_grid.build_grid_plan(boxes)
    assert not p.regular
    _plans_equal(p, q)
    x = np.random.default_rng(3).normal(size=(9, p.H * p.W + 5, 2))
    got = grid.grid_exchange(p, torch.as_tensor(x)).numpy()
    want = np.asarray(jax_grid.grid_exchange(q, jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_set_grid_geometry_routes_exchange_to_the_slab_plan():
    """The port's exchange on the decomposition that set_grid_geometry
    produced equals the JAX package's (its slab exchange), value for
    value: with the geometry stored and the general exchange kept, the two
    differed by about 1e-15."""
    jsch, sch, _ = _pair("uniform 16 64x64 overlap 1")
    x = np.random.default_rng(11).normal(size=(16, sch.dec.n_max, 1))
    got = exchange(sch.dec, torch.as_tensor(x)).numpy()
    want = np.asarray(jax_ops.exchange(jsch.dec, jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    general = exchange(dataclasses.replace(sch.dec, grid=None),
                       torch.as_tensor(x)).numpy()
    assert not np.array_equal(general, want)


@pytest.mark.parametrize("mu", [1, 3])
def test_canvas_spmm_equals_jax_and_flat(pair, mu):
    """On the problems without a canvas (generate's 2x2 grids) the product
    is the flat form in both packages."""
    jsch, sch, _ = pair
    x = np.random.default_rng(20 + mu).normal(size=(sch.dec.S, sch.n_max,
                                                    mu))
    if sch.A.canvas_hw is None:
        np.testing.assert_array_equal(
            spmv.spmm(sch.A, torch.as_tensor(x)).numpy(),
            np.asarray(jax_spmv.spmm(jsch.A, jnp.asarray(x))))
        return
    got = spmv.spmm_dia_canvas(sch.A, torch.as_tensor(x)).numpy()
    want = np.asarray(jax_spmv.spmm_dia_canvas(jsch.A, jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, spmv.spmm_dia(sch.A, torch.as_tensor(x)).numpy())
    assert torch.equal(spmv.spmm(sch.A, torch.as_tensor(x)),
                       torch.as_tensor(got))


def test_seam_coupling_keeps_the_flat_form():
    gen = diffusion2d.generate_uniform(4, 24, 24, overlap=1)
    W = gen.boxes[0][1] - gen.boxes[0][0]
    mats = []
    for m in gen.mats:
        A = m.scipy(expand=True).tolil()
        A[W - 1, W] = -0.5                      # across a canvas row seam
        mats.append(A.tocsr())
    port = sz.Schwarz([MatrixCSR(A) for A in mats], gen.neighbors,
                      gen.mappings, d=gen.d, device="cpu")
    jsch = jax_sz.Schwarz([JaxCSR(sp.csr_matrix(A)) for A in mats],
                          gen.neighbors, gen.mappings, d=gen.d)
    for s in (port, jsch):
        s.set_grid_geometry(gen.boxes, 24, 24)
    assert port.A.canvas_hw is None and jsch.A.canvas_hw is None
    assert port.dec.grid is not None                 # the exchange is kept


@pytest.mark.parametrize("mu", [1, 2])
def test_gmv_on_operator_state_equals_jax(pair, mu):
    jsch, sch, _ = pair
    x = np.random.default_rng(30 + mu).normal(size=(sch.dec.S, sch.n_max,
                                                    mu))
    want = np.asarray(jax_sz.gmv(jsch.operator_state(), jnp.asarray(x)))
    state = sch.operator_state()
    assert state.solver is None and state.coarse is None
    np.testing.assert_array_equal(sz.gmv(state, torch.as_tensor(x)).numpy(),
                                  want)
    carried = interop.state_from_numpy(
        jax_state_arrays(jsch.operator_state()), device="cpu")
    assert carried.A.canvas_hw == sch.A.canvas_hw
    _plans_equal(carried.dec.grid, jsch.dec.grid)
    np.testing.assert_array_equal(
        sz.gmv(carried, torch.as_tensor(x)).numpy(), want)
