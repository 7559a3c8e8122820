"""Port vs JAX package: the non-overlapping substructuring model
(``models/nonoverlap.py``), element for element.

At ``tests/test_substructure.py``'s sizes and one contrast case of each
kind: the local Neumann matrices (structure and values), neighbour lists
and mappings (order and dtype), split right-hand sides, global ids,
interface masks, the assembled global matrix and right-hand side, and the
banded-mode metadata (grid shapes, slot maps, analytic kernels) are equal;
sum_s R_s^T K_s R_s is the global matrix.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from hpddm_tpu.models import nonoverlap as jax_nonoverlap

from hpddm_tpu_torch.models import nonoverlap

CASES = [((4, 20, 20), {}), ((2, 16, 24), {}), ((9, 24, 24), {}),
         ((4, 12, 12), {}), ((9, 24, 24), dict(contrast=1e4, checker=6)),
         ((4, 20, 20), dict(contrast=1e3)), ((6, 30, 17), dict(contrast=10.0)),
         ((64, 64, 64), {})]


def _same_csr(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.mark.parametrize("args,kw", CASES,
                         ids=[f"{a}{'-' + str(k) if k else ''}"
                              for a, k in CASES])
def test_generate_is_element_equal(args, kw):
    ref = jax_nonoverlap.generate(*args, **kw)
    gen = nonoverlap.generate(*args, **kw)
    assert gen.neighbors == ref.neighbors
    for mine, theirs in zip(gen.mappings, ref.mappings):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for m, r in zip(gen.mats, ref.mats):
        assert _same_csr(m.scipy(), r.scipy())
    A, B = gen.A_global.tocsr(), ref.A_global.tocsr()
    A.sort_indices()
    B.sort_indices()
    assert _same_csr(A, B)
    assert np.array_equal(gen.f_global, ref.f_global)
    for key in ("f", "gids", "interface_mask", "slot_maps"):
        for a, b in zip(getattr(gen, key), getattr(ref, key)):
            assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert gen.n_loc == ref.n_loc
    assert gen.grid_shapes == ref.grid_shapes
    for a, b in zip(gen.kernels, ref.kernels):
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("args", [(4, 20, 20), (2, 16, 24), (9, 24, 24)])
def test_splitting_assembles_the_global_matrix(args):
    gen = nonoverlap.generate(*args)
    N = gen.A_global.shape[0]
    acc = sp.csr_matrix((N, N))
    for s, m in enumerate(gen.mats):
        R = sp.csr_matrix((np.ones(len(gen.gids[s])),
                           (gen.gids[s], np.arange(len(gen.gids[s])))),
                          shape=(N, len(gen.gids[s])))
        acc = acc + R @ m.scipy() @ R.T
    assert abs(acc - gen.A_global).max() < 1e-12
    # the split right-hand side sums to the global one
    f = np.zeros(N)
    for s in range(len(gen.mats)):
        f[gen.gids[s]] += gen.f[s]
    np.testing.assert_allclose(f, gen.f_global, rtol=1e-14, atol=1e-14)
