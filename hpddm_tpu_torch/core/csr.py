"""Host-side sparse matrix container.

Counterpart of ``hpddm_tpu/core/csr.py`` (numpy/scipy only), the analogue
of ``MatrixCSR<K>`` (reference: include/HPDDM_matrix.hpp:156-394). This is
*setup-path only*: on device the matrix lives in the batched formats of
core/formats.py. The container
wraps scipy.sparse for host manipulation and keeps HPDDM's conventions:

* optional symmetric storage (``sym=True``: only the lower triangle is
  stored, C numbering — HPDDM_matrix.hpp:156),
* text-file round-trip in the reference dump format
  (``# first line: n m sym nnz indexing`` then 1-based COO triplets,
  HPDDM_matrix.hpp:121-135 / :173-245) plus MatrixMarket, so matrices dumped
  by the C++ binaries can be re-solved here (the reference's
  ``-hpddm_dump_matrices`` / examples/solver.py workflow).
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np
import scipy.sparse as sp


class MatrixCSR:
    """CSR container with HPDDM symmetric-storage semantics."""

    def __init__(self, data: sp.spmatrix, sym: bool = False):
        self._csr = sp.csr_matrix(data)
        self._csr.sort_indices()
        self.sym = bool(sym)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_arrays(cls, n: int, m: int, a: np.ndarray, ia: np.ndarray,
                    ja: np.ndarray, sym: bool = False) -> "MatrixCSR":
        return cls(sp.csr_matrix((a, ja, ia), shape=(n, m)), sym=sym)

    @classmethod
    def from_coo(cls, n: int, m: int, rows, cols, vals, sym: bool = False) -> "MatrixCSR":
        return cls(sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr(), sym=sym)

    @classmethod
    def from_file(cls, path_or_stream: Union[str, io.TextIOBase],
                  dtype=np.float64) -> "MatrixCSR":
        """Parse the HPDDM dump format or MatrixMarket coordinate format."""
        if isinstance(path_or_stream, str):
            with open(path_or_stream) as fh:
                return cls.from_file(fh, dtype=dtype)
        fh = path_or_stream
        n = m = nnz = 0
        sym = False
        header = None
        for line in fh:
            line = line.strip()
            if not line or line[0] in "#%":
                continue
            parts = line.split()
            if len(parts) == 1:
                if n == 0:
                    n = m = int(parts[0])
                else:
                    nnz = int(parts[0])
                    header = True
            elif len(parts) == 3 and n == 0:
                n, m, nnz = int(parts[0]), int(parts[1]), int(parts[2])
                header = True
            else:
                n, m, sym, nnz = int(parts[0]), int(parts[1]), bool(int(parts[2])), int(parts[3])
                header = True
            if header and nnz:
                break
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vals = np.empty(nnz, dtype=dtype)
        complex_ = np.issubdtype(np.dtype(dtype), np.complexfloating)
        k = 0
        for line in fh:
            line = line.strip()
            if not line or line[0] in "#%":
                continue
            parts = line.replace("(", " ").replace(")", " ").replace(",", " ").split()
            if complex_:
                i, j = int(parts[0]), int(parts[1])
                v = complex(float(parts[2]), float(parts[3]))
            else:
                i, j = int(parts[0]), int(parts[1])
                v = float(parts[2])
            rows[k], cols[k], vals[k] = i - 1, j - 1, v
            k += 1
            if k == nnz:
                break
        return cls.from_coo(n, m, rows[:k], cols[:k], vals[:k], sym=sym)

    # -- properties -------------------------------------------------------
    @property
    def n(self) -> int:
        return self._csr.shape[0]

    @property
    def m(self) -> int:
        return self._csr.shape[1]

    @property
    def nnz(self) -> int:
        return self._csr.nnz

    @property
    def dtype(self):
        return self._csr.dtype

    @property
    def ia(self) -> np.ndarray:
        return self._csr.indptr

    @property
    def ja(self) -> np.ndarray:
        return self._csr.indices

    @property
    def a(self) -> np.ndarray:
        return self._csr.data

    # -- conversions ------------------------------------------------------
    def scipy(self, expand: bool = True) -> sp.csr_matrix:
        """scipy CSR; with `expand` a symmetric-stored matrix becomes full."""
        if self.sym and expand:
            lower = self._csr
            full = lower + lower.T - sp.diags(lower.diagonal())
            return sp.csr_matrix(full)
        return self._csr

    def dense(self, expand: bool = True) -> np.ndarray:
        return np.asarray(self.scipy(expand).todense())

    def structurally_symmetric(self) -> bool:
        """HPDDM_matrix.hpp:77-89."""
        c = self.scipy(expand=False)
        pattern = c.copy()
        pattern.data = np.ones_like(pattern.data)
        diff = (pattern - pattern.T)
        return diff.nnz == 0

    def symmetrized_structure(self) -> "MatrixCSR":
        """Add missing diagonal/symmetric entries (HPDDM_matrix.hpp:325-387)."""
        c = self.scipy(expand=False)
        pattern = c.copy()
        pattern.data = np.ones_like(pattern.data)
        full_pattern = pattern + pattern.T + sp.identity(self.n, format="csr")
        full_pattern.data = np.zeros_like(full_pattern.data)
        out = sp.csr_matrix(full_pattern + c)
        return MatrixCSR(out, sym=self.sym)

    def restriction(self, indices) -> "MatrixCSR":
        """Submatrix on a set of row/col indices (the restriction ctor,
        HPDDM_matrix.hpp:246-277)."""
        import numpy as _np
        idx = _np.asarray(indices)
        sub = self.scipy(expand=True)[idx, :][:, idx]
        return MatrixCSR(sp.csr_matrix(sub))

    def same_sparsity(self, other: "MatrixCSR") -> bool:
        """Pattern equality (``sameSparsity`` in-place reuse check,
        HPDDM_matrix.hpp:295-324)."""
        a, b = self.scipy(expand=False), other.scipy(expand=False)
        return (a.shape == b.shape and a.nnz == b.nnz
                and (a.indptr == b.indptr).all()
                and (a.indices == b.indices).all())

    def update_values(self, other: "MatrixCSR") -> None:
        """Replace values keeping the pattern (the sameSparsity fast path)."""
        if not self.same_sparsity(other):
            raise ValueError("sparsity patterns differ")
        self._csr.data[:] = other.scipy(expand=False).data

    # -- dump -------------------------------------------------------------
    def dump(self, path_or_stream: Union[str, io.TextIOBase]) -> None:
        """Write the reference dump format (HPDDM_matrix.hpp:121-135)."""
        if isinstance(path_or_stream, str):
            with open(path_or_stream, "w") as fh:
                self.dump(fh)
            return
        fh = path_or_stream
        fh.write("# First line: n m (is symmetric) nnz indexing\n")
        fh.write("# For each nonzero coefficient: i j a_ij such that "
                 "(i, j) \\in  {1, ..., n} x {1, ..., m}\n")
        fh.write(f"{self.n} {self.m} {int(self.sym)}  {self.nnz} C\n")
        coo = self._csr.tocoo()
        complex_ = np.issubdtype(self.dtype, np.complexfloating)
        for i, j, v in zip(coo.row, coo.col, coo.data):
            if complex_:
                fh.write(f"{i + 1:9d} {j + 1:9d} ({v.real:.15e},{v.imag:.15e})\n")
            else:
                fh.write(f"{i + 1:9d} {j + 1:9d} {v:.15e}\n")

    def __repr__(self) -> str:
        return (f"MatrixCSR(n={self.n}, m={self.m}, nnz={self.nnz}, "
                f"sym={self.sym}, dtype={self.dtype})")
