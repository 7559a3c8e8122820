"""Batched device sparse formats (counterpart of ``hpddm_tpu/core/formats.py``).

Local matrices are stored in fixed-shape formats with a leading subdomain
axis ``S``:

* ``BatchedDIA``: diagonal storage for stencil matrices, values[s, k, i] =
  A_s[i, i + offsets[k]]. The SpMV streams the value planes once
  (ops/dia_spmv.py). Offsets are static per problem.
* ``BatchedDense``: explicit dense blocks; SpMV is a batched matmul.

``pack_local_matrices`` packs per-subdomain host ``MatrixCSR`` (auto: DIA
when the union of offsets is small). Rows are padded to ``n_max``; padded
rows are identity rows (diagonal 1) so factorizations stay non-singular.
The ELL format (unstructured operators) belongs to a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hpddm_tpu_torch.core.csr import MatrixCSR


@dataclasses.dataclass(frozen=True)
class BatchedDIA:
    """Diagonal-format batch: values[s, k, i] = A_s[i, i + offsets[k]]."""
    values: torch.Tensor                  # (S, ndiag, n_max), contiguous
    offsets: Tuple[int, ...]
    n_max: int


@dataclasses.dataclass(frozen=True)
class BatchedDense:
    """Dense batch (S, n_max, n_max); padded rows/cols are identity."""
    values: torch.Tensor
    n_max: int


def _diag_offsets(mats: Sequence[MatrixCSR],
                  cap: Optional[int] = 32) -> Optional[np.ndarray]:
    """Union of nonzero diagonals across subdomains, or None if > cap."""
    offsets: set = set()
    for m in mats:
        c = m.scipy(expand=True).tocoo()
        offsets.update(np.unique(c.col - c.row).tolist())
        if cap is not None and len(offsets) > cap:
            return None
    return np.array(sorted(offsets), dtype=np.int64)


def pack_local_matrices(mats: Sequence[MatrixCSR], n_max: Optional[int] = None,
                        fmt: str = "auto", dtype=None,
                        pad_identity: bool = True, device="cpu"):
    """Pack per-subdomain CSR matrices into a batched device format.

    fmt in {"auto", "dia", "dense"}; "auto" picks DIA when the union of
    diagonals has at most 32 offsets. Symmetric-stored inputs are expanded
    to full storage first.
    """
    S = len(mats)
    if n_max is None:
        n_max = max(m.n for m in mats)
    if dtype is None:
        dtype = np.result_type(*[m.dtype for m in mats])

    if fmt == "auto":
        offs = _diag_offsets(mats)
        if offs is None:
            raise NotImplementedError(
                "more than 32 diagonals: the ELL format is not ported yet "
                "(ROADMAP queue A, slice 3, unstructured path)")
        fmt = "dia"
    else:
        offs = _diag_offsets(mats, cap=None) if fmt == "dia" else None

    if fmt == "dia":
        ndiag = len(offs)
        vals = np.zeros((S, ndiag, n_max), dtype=dtype)
        off_pos = {int(o): k for k, o in enumerate(offs)}
        for s, m in enumerate(mats):
            c = m.scipy(expand=True).tocoo()
            k_idx = np.array([off_pos[int(o)] for o in (c.col - c.row)])
            vals[s, k_idx, c.row] = c.data
            if pad_identity and 0 in off_pos:
                vals[s, off_pos[0], m.n:] = 1.0
        return BatchedDIA(values=torch.as_tensor(vals, device=device),
                          offsets=tuple(int(o) for o in offs),
                          n_max=int(n_max))

    if fmt == "dense":
        vals = np.zeros((S, n_max, n_max), dtype=dtype)
        for s, m in enumerate(mats):
            vals[s, : m.n, : m.n] = m.dense(expand=True)
            if pad_identity:
                idx = np.arange(m.n, n_max)
                vals[s, idx, idx] = 1.0
        return BatchedDense(values=torch.as_tensor(vals, device=device),
                            n_max=int(n_max))

    if fmt == "ell":
        raise NotImplementedError(
            "the ELL format is not ported yet (ROADMAP queue A, slice 3, "
            "unstructured path)")
    raise ValueError(f"unknown format {fmt!r}")


def batched_dense_from(mat, sub: slice = slice(None)) -> torch.Tensor:
    """Materialize a batched format as dense (S', n, n) on its device, for
    the subdomains ``sub`` (all by default). A slice keeps the footprint
    of a setup loop to a few n^2 blocks at a time."""
    if isinstance(mat, BatchedDense):
        return mat.values[sub]
    if isinstance(mat, BatchedDIA):
        vals = mat.values[sub]
        Sb, nd, n = vals.shape
        out = vals.new_zeros((Sb, n, n))
        i = torch.arange(n, device=vals.device)
        for k, off in enumerate(mat.offsets):
            cols = i + off
            valid = (cols >= 0) & (cols < n)
            out[:, i[valid], cols[valid]] += vals[:, k, valid]
        return out
    raise TypeError(f"unsupported matrix type {type(mat)}")
