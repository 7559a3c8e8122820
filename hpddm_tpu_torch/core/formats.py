"""Batched device sparse formats (counterpart of ``hpddm_tpu/core/formats.py``).

Local matrices are stored in fixed-shape formats with a leading subdomain
axis ``S``:

* ``BatchedDIA``: diagonal storage for stencil matrices, values[s, k, i] =
  A_s[i, i + offsets[k]]. The SpMV streams the value planes once
  (ops/dia_spmv.py). Offsets are static per problem.
* ``BatchedELL``: padded fixed-width rows (values + int32 column
  indices) for unstructured operators, stored slot-major so that the
  SpMV kernel's threads (adjacent rows) read adjacent words; the SpMV is
  a gather and a sum over the row's slots (ops/ell_spmv.py). Every batch
  the port builds carries the kernel's payload (narrowed columns and row
  counts, ``ops/ell_spmv.build_payload``).
* ``BatchedDense``: explicit dense blocks; SpMV is a batched matmul.

``pack_local_matrices`` packs per-subdomain host ``MatrixCSR`` (auto: DIA
when the union of offsets has at most 32 diagonals, else ELL). Rows are
padded to ``n_max``; padded rows are identity rows (diagonal 1) so
factorizations stay non-singular, and padded ELL slots carry value 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.device import DEFAULT, as_device
from hpddm_tpu_torch.ops.ell_spmv import EllPayload, build_payload


@dataclasses.dataclass(frozen=True)
class BatchedDIA:
    """Diagonal-format batch: values[s, k, i] = A_s[i, i + offsets[k]].

    canvas_hw: the (H, W) grid box of every subdomain, set by
    ``Schwarz.set_grid_geometry`` on a uniform grid with seam-safe values.
    There the 2-D canvas form (``ops/spmv.spmm_dia_canvas``) computes
    the flat form's sums, so every product keeps the flat path (the DIA
    kernels on the card); the annotation records the seam check and
    gives the canvas form its shape. The JAX package also
    keeps pre-split per-diagonal planes (``values_planes``) to stop XLA
    from copying slices of the packed buffer inside a jitted loop; a torch
    view of a plane costs nothing, so the port has no such field.

    values_lp: the bfloat16 mirror of ``values`` (``-hpddm_gmv_dtype
    bfloat16``, ``hpddm_tpu/core/formats.py:51``), or None. Every product
    of ``ops/spmv.spmm`` and ``spmm_muT`` reads it where it is set, in the
    plain DIA form, accumulating in x's dtype; factorizations read
    ``values``."""
    values: torch.Tensor                  # (S, ndiag, n_max), contiguous
    offsets: Tuple[int, ...]
    n_max: int
    canvas_hw: Optional[Tuple[int, int]] = None
    values_lp: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class BatchedELL:
    """Padded slot-major ELL batch: values[s, j, i] = A_s[i, cols[s, j, i]]
    (the transpose of the JAX package's row-major (S, n_max, w) arrays);
    padding slots hold value 0 and column 0. ``payload``: the maps the
    CUDA kernel reads (``from_slot_major`` builds it); a CUDA product on a
    batch without one raises."""
    values: torch.Tensor                  # (S, w, n_max), contiguous
    cols: torch.Tensor                    # (S, w, n_max) int32, contiguous
    n_max: int
    payload: Optional[EllPayload] = None

    @staticmethod
    def from_slot_major(values: torch.Tensor, cols: torch.Tensor,
                        n_max: int) -> "BatchedELL":
        """The batch of contiguous slot-major values and int32 cols, with
        its kernel payload built on their device."""
        return BatchedELL(values=values, cols=cols, n_max=int(n_max),
                          payload=build_payload(values, cols))

    def astype(self, dtype) -> "BatchedELL":
        """The values in dtype; the columns and the payload are kept (a
        row count taken before the cast still bounds the row's stored
        slots, and a slot cast to 0 adds +-0)."""
        return dataclasses.replace(self, values=self.values.to(dtype))


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


def ell_pack(csr, n_max: int, width: int):
    """CSR -> padded (n_max, width) ELL arrays, each row's entries in CSR
    storage order (the numpy branch of ``hpddm_tpu/native`` ``ell_pack``;
    the port builds no host library). Real values are packed in f64,
    complex ones in c128: the imaginary part is never dropped."""
    n = csr.shape[0]
    values = np.zeros((n_max, width),
                      dtype=np.result_type(csr.dtype, np.float64))
    cols = np.zeros((n_max, width), dtype=np.int32)
    for i in range(n):
        lo, hi = csr.indptr[i], csr.indptr[i + 1]
        values[i, : hi - lo] = csr.data[lo:hi]
        cols[i, : hi - lo] = csr.indices[lo:hi]
    return values, cols


def pack_local_matrices(mats: Sequence[MatrixCSR], n_max: Optional[int] = None,
                        fmt: str = "auto", dtype=None,
                        pad_identity: bool = True, device=DEFAULT):
    """Pack per-subdomain CSR matrices into a batched device format.

    fmt in {"auto", "dia", "ell", "dense"}; "auto" picks DIA when the union
    of diagonals has at most 32 offsets, else ELL. Symmetric-stored inputs
    are expanded to full storage first.
    """
    device = as_device(device)
    S = len(mats)
    if n_max is None:
        n_max = max(m.n for m in mats)
    if dtype is None:
        dtype = np.result_type(*[m.dtype for m in mats])

    if fmt == "auto":
        offs = _diag_offsets(mats)
        fmt = "dia" if offs is not None else "ell"
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

    if fmt == "ell":
        width = 1
        rows_list = []
        for m in mats:
            csr = m.scipy(expand=True)
            counts = np.diff(csr.indptr)
            width = max(width, int(counts.max(initial=1)))
            rows_list.append(csr)
        vals = np.zeros((S, n_max, width), dtype=dtype)
        cols = np.zeros((S, n_max, width), dtype=np.int32)
        for s, csr in enumerate(rows_list):
            if np.issubdtype(csr.dtype, np.floating):
                csr = csr.astype(np.float64)
            v, c = ell_pack(csr, n_max, width)
            vals[s] = v.astype(dtype)
            cols[s] = c
            if pad_identity:
                n = csr.shape[0]
                vals[s, n:, 0] = 1.0
                cols[s, n:, 0] = np.arange(n, n_max)
        return BatchedELL.from_slot_major(
            torch.as_tensor(np.ascontiguousarray(vals.transpose(0, 2, 1)),
                            device=device),
            torch.as_tensor(np.ascontiguousarray(cols.transpose(0, 2, 1)),
                            device=device), n_max)

    if fmt == "dense":
        vals = np.zeros((S, n_max, n_max), dtype=dtype)
        for s, m in enumerate(mats):
            vals[s, : m.n, : m.n] = m.dense(expand=True)
            if pad_identity:
                idx = np.arange(m.n, n_max)
                vals[s, idx, idx] = 1.0
        return BatchedDense(values=torch.as_tensor(vals, device=device),
                            n_max=int(n_max))

    raise ValueError(f"unknown format {fmt!r}")


def batched_dense_from(mat, sub: slice = slice(None)) -> torch.Tensor:
    """Materialize a batched format as dense (S', n, n) on its device, for
    the subdomains ``sub`` (all by default). A slice keeps the footprint
    of a setup loop to a few n^2 blocks at a time."""
    if isinstance(mat, BatchedDense):
        return mat.values[sub]
    if isinstance(mat, BatchedELL):
        vals = mat.values[sub].transpose(1, 2)            # (S', n, w)
        Sb, n, _ = vals.shape
        out = vals.new_zeros((Sb, n, n))
        return out.scatter_add_(2, mat.cols[sub].transpose(1, 2).long(), vals)
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
