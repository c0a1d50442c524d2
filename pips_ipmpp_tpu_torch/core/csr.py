"""Host-side CSR sparse storage for problem intake.

Counterpart of `CsrMatrix` in `pips_ipmpp_tpu/core/csr.py` (the
reference's static SparseStorage, SparseStorage.C).  Device math runs in
the batched formats (dense tensors, batched ELL for genuinely sparse
blocks, core/sparse.py); CSR is what callers hand to
`make_sparse_arrowhead_lp`.  Plain numpy, no device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CsrMatrix:
    """Static CSR (the reference's SparseStorage, SparseStorage.C)."""
    indptr: np.ndarray    # [m+1] int64
    indices: np.ndarray   # [nnz] int32 column ids, sorted within each row
    data: np.ndarray      # [nnz] float64
    shape: tuple          # (m, n)

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_triplets(rows, cols, vals, shape) -> "CsrMatrix":
        """Build from (row, col, val) triplets; duplicates are SUMMED
        (the reference combines duplicates at assembly too)."""
        m, n = shape
        r = np.asarray(rows, np.int64)
        c = np.asarray(cols, np.int64)
        v = np.asarray(vals, np.float64)
        if r.size and (r.min() < 0 or r.max() >= m):
            raise ValueError(f"row id out of range [0, {m})")
        if c.size and (c.min() < 0 or c.max() >= n):
            raise ValueError(f"column id out of range [0, {n})")
        key = r * n + c
        uk, inv = np.unique(key, return_inverse=True)
        sv = np.zeros(len(uk), np.float64)
        np.add.at(sv, inv, v)
        ur = (uk // n).astype(np.int64)
        uc = (uk % n).astype(np.int32)
        indptr = np.zeros(m + 1, np.int64)
        np.add.at(indptr, ur + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CsrMatrix(indptr, uc, sv, (m, n))

    @staticmethod
    def from_dense(M) -> "CsrMatrix":
        M = np.asarray(M, np.float64)
        m, n = M.shape
        r, c = np.nonzero(M)
        return CsrMatrix.from_triplets(r, c, M[r, c], (m, n))

    @staticmethod
    def from_fortran(krow, jcol, vals, shape) -> "CsrMatrix":
        """From 1-based CSR arrays (the reference converts PARDISO/HSL
        Fortran indexing with shiftRows_*, SparseStorage.C)."""
        indptr = np.asarray(krow, np.int64) - 1
        indices = np.asarray(jcol, np.int32) - 1
        data = np.asarray(vals, np.float64).copy()
        return CsrMatrix(indptr, indices, data, tuple(shape))

    # ---- exporters ----------------------------------------------------
    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n))
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    def to_fortran(self):
        """(krow, jcol, vals) with 1-based indexing."""
        return (self.indptr + 1, self.indices.astype(np.int64) + 1,
                self.data.copy())

    def to_triplets(self):
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        return rows, self.indices.copy(), self.data.copy()

    def to_ell(self, K: int | None = None):
        """Single-block ELL arrays (val [m, K], col [m, K]); callers stack
        across blocks."""
        m, n = self.shape
        cnt = np.diff(self.indptr)
        Kr = max(int(cnt.max()) if m else 1, 1)
        if K is None:
            K = Kr
        elif K < Kr:
            raise ValueError(f"K={K} < max row nnz {Kr}")
        val = np.zeros((m, K))
        col = np.zeros((m, K), np.int32)
        rows = np.repeat(np.arange(m), cnt)
        slot = np.arange(self.data.size) - self.indptr[rows]
        val[rows, slot] = self.data
        col[rows, slot] = self.indices
        return val, col

    # ---- properties ----------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    # ---- products (reference SparseStorage::mult/transMult) ------------
    def matvec(self, x) -> np.ndarray:
        m, _ = self.shape
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        prod = self.data * np.asarray(x)[self.indices]
        return np.bincount(rows, weights=prod, minlength=m)

    def trans_matvec(self, y) -> np.ndarray:
        m, n = self.shape
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        out = np.zeros(n)
        np.add.at(out, self.indices, self.data * np.asarray(y)[rows])
        return out

    def transpose(self) -> "CsrMatrix":
        """Explicit transpose (the reference caches it per matrix for
        transMult, SparseMatrix.C)."""
        rows, cols, vals = self.to_triplets()
        return CsrMatrix.from_triplets(cols, rows, vals,
                                       (self.shape[1], self.shape[0]))

    # ---- scaling / diagonal (scaler + presolve support ops) -------------
    def scale_rows(self, s) -> None:
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        self.data *= np.asarray(s)[rows]

    def scale_cols(self, s) -> None:
        self.data *= np.asarray(s)[self.indices]

    def get_diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape))
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        on = rows == self.indices   # implies rows < min(m, n)
        d[rows[on]] = self.data[on]
        return d

    def row_abs_max(self) -> np.ndarray:
        out = np.zeros(self.shape[0])
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        np.maximum.at(out, rows, np.abs(self.data))
        return out

    def col_abs_max(self) -> np.ndarray:
        out = np.zeros(self.shape[1])
        np.maximum.at(out, self.indices, np.abs(self.data))
        return out
