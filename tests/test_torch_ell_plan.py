"""Port vs JAX package: the kernels' maps of the unstructured path, on the
CPU in f64.

* The ELL payload (``ops/ell_spmv.build_payload``: uint16 columns where
  n_max <= 65,535, else int32; each row's count of stored slots) and the
  plain version that reads it, ``ell_spmv_payload_reference``. It skips
  each row's trailing padding slots, which adds only +-0 to a sum that is
  never -0: bitwise equal to the full slot sum ``ell_spmv_reference`` for
  finite x, and at rtol 1e-12 of max|y| to the JAX package's einsum and
  its windowed kernel in interpret mode (which sum in other orders), as
  ``tests/test_unstructured.py``.
* The one-pass exchange plan (``parallel/pexchange.build_plan``: interior
  mask, slot rows, slot-major partner rows) and ``pexchange_reference`` on
  it: bitwise equal to the port's plain exchange and to the JAX package's
  XLA general path, and equal in value to its Pallas exchange in interpret
  mode (whose masking turns -0.0 into +0.0: ROADMAP queue C, C1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpddm_tpu.core.formats import BatchedELL as JaxELL
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.models import unstructured as jax_un
from hpddm_tpu.ops.pallas_ell import annotate_windowed, spmm_windowed
from hpddm_tpu.ops.spmv import spmm_ell as jax_spmm_ell
from hpddm_tpu.parallel import ops as jax_ops
from hpddm_tpu.parallel import pexchange as jax_pex
from hpddm_tpu.parallel.decomposition import Decomposition as JaxDec

from hpddm_tpu_torch import interop
from hpddm_tpu_torch.core.formats import BatchedELL, pack_local_matrices
from hpddm_tpu_torch.models import diffusion2d, unstructured
from hpddm_tpu_torch.ops import ell_spmv as ek
from hpddm_tpu_torch.ops.spmv import spmm
from hpddm_tpu_torch.parallel import ops, pexchange
from hpddm_tpu_torch.parallel.decomposition import Decomposition


@pytest.fixture(scope="module")
def parity():
    """The unstructured parity configuration's problem (60x60 mesh, S=8,
    overlap 2, k-way) in both packages."""
    kw = dict(overlap=2, with_neumann=False)
    return jax_un.generate(8, 60, 60, **kw), unstructured.generate(8, 60, 60,
                                                                   **kw)


def _ragged_ell(seed, S, n, w, band=6):
    """Slot-major (S, w, n) values and int32 columns: each row of a random
    length in [1, w] (every length present where n >= w) followed by
    padding (value 0, column 0), row 0 of subdomain 0 all padding."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n)[None, None, :]
    cols = np.clip(rows + rng.integers(-band, band + 1, size=(S, w, n)),
                   0, n - 1).astype(np.int32)
    vals = rng.normal(size=(S, w, n))
    length = rng.integers(1, w + 1, size=(S, 1, n))
    length[:, 0, :w] = np.arange(1, w + 1)[: n]
    length[0, 0, 0] = 0
    pad = np.arange(w)[None, :, None] >= length
    vals[pad] = 0.0
    cols[pad] = 0
    return vals, cols, length[:, 0, :]


def _jax_ell(vals, cols):
    """The JAX package's row-major batch of the slot-major arrays."""
    return JaxELL(values=jnp.asarray(vals.transpose(0, 2, 1)),
                  cols=jnp.asarray(np.ascontiguousarray(
                      cols.transpose(0, 2, 1))), n_max=vals.shape[2])


def _held_to_jax(A, jA, x, windowed=True):
    """The payload's plain version against the full slot sum (bitwise), the
    dispatch, and the JAX package's einsum and windowed kernel."""
    tx = torch.as_tensor(x)
    y = ek.ell_spmv_payload_reference(A.values, A.payload, tx)
    assert torch.equal(y, ek.ell_spmv_reference(A.values, A.cols, tx))
    assert torch.equal(spmm(A, tx), y)
    assert ek.launches == 0 and not ek.launches_by_mu  # CPU: plain only
    want = np.asarray(jax_spmm_ell(jA, jnp.asarray(x)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-12 * scale)
    if windowed:
        win = np.asarray(spmm_windowed(annotate_windowed(jA), jnp.asarray(x),
                                       interpret=True))
        np.testing.assert_allclose(y.numpy(), win, rtol=0,
                                   atol=1e-12 * scale)


@pytest.mark.parametrize("mu", [1, 3])
def test_payload_at_the_parity_config(parity, mu):
    jgen, gen = parity
    A = pack_local_matrices(gen.mats, device="cpu")
    S, w, n = A.values.shape
    assert A.payload.cols.dtype == torch.uint16
    assert torch.equal(A.payload.cols.long(), A.cols.long())
    # each row's count is its CSR length; padded rows hold one identity slot
    want = np.ones((S, n), dtype=np.uint8)
    for s, m in enumerate(gen.mats):
        want[s, : m.n] = np.diff(m.scipy(expand=True).indptr)
    np.testing.assert_array_equal(A.payload.counts.numpy(), want)
    x = np.random.default_rng(40 + mu).normal(size=(S, n, mu))
    from hpddm_tpu.core.formats import pack_local_matrices as jax_pack
    _held_to_jax(A, jax_pack(jgen.mats), x)


@pytest.mark.parametrize("S,n,w,mu", [(3, 50, 6, 1), (3, 50, 6, 3),
                                      (2, 40, 1, 2), (1, 33, 17, 1)])
def test_payload_on_ragged_batches(S, n, w, mu):
    """Random batches with an all-padding row and rows of every length
    1..w, one slot wide, and wider than the kernel's unrolled buckets."""
    vals, cols, length = _ragged_ell(S + n + w, S, n, w)
    A = BatchedELL.from_slot_major(torch.as_tensor(vals),
                                   torch.as_tensor(cols), n)
    np.testing.assert_array_equal(A.payload.counts.numpy(), length)
    x = np.random.default_rng(mu).normal(size=(S, n, mu))
    _held_to_jax(A, _jax_ell(vals, cols), x)


@pytest.mark.parametrize("n,narrow", [(65535, True), (65536, False)])
def test_payload_column_width_switch(n, narrow):
    """uint16 columns up to n_max = 65,535, int32 from 65,536 (S=1, w=2)."""
    vals, cols, _ = _ragged_ell(n, 1, n, 2, band=40)
    cols[0, 0, -1] = n - 1
    A = BatchedELL.from_slot_major(torch.as_tensor(vals),
                                   torch.as_tensor(cols), n)
    assert A.payload.cols.dtype == (torch.uint16 if narrow else torch.int32)
    assert torch.equal(A.payload.cols.long(), A.cols.long())
    x = np.random.default_rng(5).normal(size=(1, n, 1))
    _held_to_jax(A, _jax_ell(vals, cols), x, windowed=False)


def test_payload_rejects_columns_outside_the_rows():
    cols = torch.zeros((1, 2, 8), dtype=torch.int32)
    cols[0, 1, 3] = 8
    with pytest.raises(ValueError, match="outside"):
        ek.build_payload(torch.ones((1, 2, 8)), cols)


def test_astype_and_interop_keep_the_payload(parity):
    _, gen = parity
    A = pack_local_matrices(gen.mats, device="cpu")
    A32 = A.astype(torch.float32)
    assert A32.payload is A.payload and A32.values.dtype == torch.float32
    x = torch.as_tensor(np.random.default_rng(7).normal(
        size=(A.values.shape[0], A.n_max, 2))).float()
    assert torch.equal(spmm(A32, x), ek.ell_spmv_reference(
        A32.values, A32.cols, x))
    dec = Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                        gen.n_loc, d=gen.d, device="cpu")
    arrays = {k: getattr(dec, k).numpy() for k in (
        "n_loc", "d", "if_idx", "if_gid", "if_mask", "ov_mask", "mult",
        "partners", "inv_map", "is_if")}
    arrays.update({k: getattr(dec, k) for k in interop.DEC_INT_KEYS})
    arrays.update(A_values=A.values.transpose(1, 2).numpy(),
                  A_cols=A.cols.transpose(1, 2).numpy(),
                  factor=np.zeros((dec.S, 1, 1)), variant="ras")
    state = interop.state_from_numpy(arrays, device="cpu")
    assert state.A.payload is not None
    assert torch.equal(state.A.payload.cols, A.payload.cols)
    assert torch.equal(state.A.payload.counts, A.payload.counts)
    plan = state.dec.pexch
    for key in ("interior", "dst", "rows"):
        assert torch.equal(getattr(plan, key),
                           getattr(pexchange.build_plan(dec), key))


def _isolated():
    """Three subdomains, the last with no neighbor (no interface slot)."""
    idx = np.arange(4, 9)
    return dict(neighbors=[[1], [0], []], mappings=[[idx], [idx - 4], []],
                n_loc=[12, 10, 7])


def _dec_pair(case):
    if case == "parity":
        return None
    if case == "no interface":
        kw = _isolated()
        return (JaxDec.from_subdomains(**kw),
                Decomposition.from_subdomains(**kw, device="cpu"))
    S, Nx, Ny = {"k_max = 1": (2, 40, 24), "grid": (6, 30, 30)}[case]
    rg, g = jax_d2.generate(S, Nx, Ny, overlap=1), \
        diffusion2d.generate(S, Nx, Ny, overlap=1)
    return (JaxDec.from_subdomains(rg.neighbors, rg.mappings, rg.n_loc,
                                   d=rg.d),
            Decomposition.from_subdomains(g.neighbors, g.mappings, g.n_loc,
                                          d=g.d, device="cpu"))


@pytest.mark.parametrize("mu", [1, 3])
@pytest.mark.parametrize("case", ["parity", "k_max = 1", "no interface",
                                  "grid"])
def test_exchange_plan_against_jax(parity, case, mu):
    pair = _dec_pair(case)
    if pair is None:
        jgen, gen = parity
        pair = (JaxDec.from_subdomains(jgen.neighbors, jgen.mappings,
                                       jgen.n_loc, d=jgen.d),
                Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                              gen.n_loc, d=gen.d,
                                              device="cpu"))
    jdec, dec = pair
    plan = pexchange.build_plan(dec)
    S, n, m, k = dec.S, dec.n_max, dec.m_max, dec.k_max
    if case == "k_max = 1":
        assert k == 1
    if case == "no interface":
        assert not bool(dec.is_if[2].any()) and bool((plan.dst[2] < 0).all())
    # the maps: the interior mask, each slot's flat row, the slot-major
    # partner rows
    assert torch.equal(plan.interior, ~dec.is_if)
    assert plan.dst.dtype == plan.rows.dtype == torch.int32
    assert tuple(plan.rows.shape) == (S, k, m)
    on = dec.if_mask
    flat = torch.arange(S)[:, None] * n + dec.if_idx
    assert torch.equal(plan.dst[on].long(), flat[on])
    assert bool((plan.dst[~on] == -1).all())
    x = np.random.default_rng(60 + mu).normal(size=(S, n, mu))
    x[:, ::5] = -0.0                              # signed zeros: caveat C1
    tx = torch.as_tensor(x)
    got = pexchange.pexchange(plan, tx)
    assert pexchange.launches == 0 and not pexchange.launches_by_mu  # plain
    want = np.asarray(jax_ops.exchange(jdec, jnp.asarray(x)))
    assert got.numpy().tobytes() == want.tobytes()
    plain = ops.exchange(dataclasses.replace(dec, pexch=None), tx)
    assert got.numpy().tobytes() == plain.numpy().tobytes()
    jplan = jax_pex.build_plan(jdec)
    if jplan is not None:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_pex.pexchange(jplan, jnp.asarray(x),
                                                      interpret=True)))
