"""Batched ELL sparse storage for the big per-block matrices.

Counterpart of `pips_ipmpp_tpu/core/sparse.py`.  The reference stores
every block sparsely (CSR, SparseStorage.C) and factorizes it with a
sparse direct solver (PardisoSchurSolver.C:84-252); this package keeps a
static-shape batched ELL:

    val [N, m, K]   per-row nonzero values, K = max row nnz (zero-padded)
    col [N, m, K]   int32 column ids (padded entries point at column 0 with
                    val 0, so no masking is needed in products)

The transpose is stored explicitly (built once on the host), so every
product is a gather with one writer per output row.  The products live in
`linalg/spmv.py` beside their CUDA kernel; leaf solves go matrix-free
(Jacobi-preconditioned CG, `linalg/sparse_backend.py`).

Builders run on the host in numpy and return CPU tensors (f64 values
unless the input says otherwise); `.to(device)` moves them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP, _maxabs


@dataclass
class Ell:
    """Batched fixed-width sparse rows: [N, m, K] values + column ids."""
    val: torch.Tensor   # [N, m, K] floating
    col: torch.Tensor   # [N, m, K] int32, padded entries -> col 0 / val 0

    @property
    def N(self) -> int:
        return self.val.shape[0]

    @property
    def m(self) -> int:
        return self.val.shape[1]

    @property
    def K(self) -> int:
        return self.val.shape[2]

    def astype(self, dtype) -> "Ell":
        """Cast the values; the column ids stay int32."""
        return Ell(self.val.to(dtype), self.col)

    def to(self, device) -> "Ell":
        return Ell(self.val.to(device), self.col.to(device))


def _ell(val: np.ndarray, col: np.ndarray) -> Ell:
    return Ell(torch.from_numpy(val), torch.from_numpy(col))


def _ell_fill(rows, cols, vals, m, K, dtype):
    """Pack (row, col, val) triplets with rows sorted into [m, K] ELL."""
    val = np.zeros((m, K), dtype)
    col = np.zeros((m, K), np.int32)
    # slot index within each equal-row run (rows must be sorted)
    slot = np.arange(len(rows)) - np.searchsorted(rows, rows, side="left")
    val[rows, slot] = vals
    col[rows, slot] = cols
    return val, col


def ell_from_triplets(rows, cols, vals, m, n, K: int | None = None) -> Ell:
    """Build ELL from per-block triplet lists (host-side).

    `rows`/`cols`/`vals` are length-N lists of 1-D arrays (one per block).
    Duplicate (row, col) entries are summed at construction (`ell_sq_diag`
    assumes unique column ids within each row).  Column ids are validated
    against `n`."""
    N = len(rows)
    combined = []
    for i in range(N):
        r = np.asarray(rows[i], np.int64)
        c = np.asarray(cols[i], np.int64)
        v = np.asarray(vals[i], np.float64)
        if len(c) and (c.min() < 0 or c.max() >= n):
            raise ValueError(f"block {i}: column id out of range [0, {n})")
        if len(r) and (r.min() < 0 or r.max() >= m):
            raise ValueError(f"block {i}: row id out of range [0, {m})")
        key = r * n + c
        uk, inv = np.unique(key, return_inverse=True)
        sv = np.zeros(len(uk), v.dtype)
        np.add.at(sv, inv, v)
        combined.append((uk // n, uk % n, sv))
    if K is None:
        K = 1
        for r, _, _ in combined:
            if len(r):
                K = max(K, int(np.bincount(r, minlength=m).max()))
    val = np.zeros((N, m, K), np.float64)
    col = np.zeros((N, m, K), np.int32)
    for i, (r, c, v) in enumerate(combined):
        val[i], col[i] = _ell_fill(r, c, v, m, K, val.dtype)
    return _ell(val, col)


def ell_from_dense(M, K: int | None = None) -> Ell:
    """Build ELL from a batched dense [N, m, n] matrix (host-side)."""
    M = np.asarray(M)
    N, m, n = M.shape
    if K is None:
        K = max(int((M != 0.0).sum(axis=2).max()), 1)
    val = np.zeros((N, m, K), M.dtype)
    col = np.zeros((N, m, K), np.int32)
    for i in range(N):
        r, c = np.nonzero(M[i])          # r already sorted (row-major)
        val[i], col[i] = _ell_fill(r, c, M[i][r, c], m, K, M.dtype)
    return _ell(val, col)


def ell_transpose(ell: Ell, n: int) -> Ell:
    """Explicit transpose ELL (host-side, once at build): rows of the
    transpose gather the same nonzeros by column, so a transpose product
    is a gather too.  Returned on the input's device."""
    val = ell.val.cpu().numpy()
    col = ell.col.cpu().numpy()
    N = val.shape[0]
    ents = []
    Kt = 1
    for i in range(N):
        r, k = np.nonzero(val[i])
        c = col[i][r, k]
        order = np.argsort(c, kind="stable")
        ents.append((c[order], r[order], val[i][r, k][order]))
        if len(c):
            Kt = max(Kt, int(np.bincount(c, minlength=n).max()))
    tval = np.zeros((N, n, Kt), val.dtype)
    tcol = np.zeros((N, n, Kt), np.int32)
    for i, (c, r, v) in enumerate(ents):
        tval[i], tcol[i] = _ell_fill(c, r, v, n, Kt, val.dtype)
    return _ell(tval, tcol).to(ell.val.device)


def ell_to_dense(ell: Ell, n: int) -> torch.Tensor:
    """Densify to [N, m, n] (tests and the densify route only);
    duplicate slots add."""
    N, m, _ = ell.val.shape
    out = torch.zeros((N, m, n), dtype=ell.val.dtype, device=ell.val.device)
    return out.scatter_add_(2, ell.col.long(), ell.val)


# ----------------------------------------------------------------------
# Sparse arrowhead LP
# ----------------------------------------------------------------------

@dataclass
class SparseArrowheadLP:
    """ArrowheadLP with the big diagonal blocks B [N,mE,n] / D [N,mI,n] in
    ELL form (forward + explicit transpose).  The borders to the small
    first stage (A, C: [N, m, n0]) and the thin linking strips
    (F, G: [N, ml, n]) stay dense: their minor dimension is the small
    root/link size.  The dense twin is core/lp.py:ArrowheadLP."""

    # ---- first stage (block 0): same as ArrowheadLP ----
    c0: torch.Tensor
    A0: torch.Tensor
    b0: torch.Tensor
    C0: torch.Tensor
    iclow0: torch.Tensor
    clow0: torch.Tensor
    icupp0: torch.Tensor
    cupp0: torch.Tensor
    ixlow0: torch.Tensor
    xlow0: torch.Tensor
    ixupp0: torch.Tensor
    xupp0: torch.Tensor

    # ---- per-block ----
    cN: torch.Tensor        # [N, n]
    A: torch.Tensor         # [N, mE, n0] dense border
    B: Ell                  # [N, mE, n] sparse diagonal block
    Bt: Ell                 # its transpose [N, n, mE]
    bN: torch.Tensor
    C: torch.Tensor         # [N, mI, n0] dense border
    D: Ell                  # [N, mI, n] sparse diagonal block
    Dt: Ell
    iclowN: torch.Tensor
    clowN: torch.Tensor
    icuppN: torch.Tensor
    cuppN: torch.Tensor
    ixlowN: torch.Tensor
    xlowN: torch.Tensor
    ixuppN: torch.Tensor
    xuppN: torch.Tensor

    # ---- linking rows ----
    F0: torch.Tensor
    F: torch.Tensor         # [N, mEl, n] dense strip
    bl: torch.Tensor
    G0: torch.Tensor
    G: torch.Tensor         # [N, mIl, n]
    iclowl: torch.Tensor
    clowl: torch.Tensor
    icuppl: torch.Tensor
    cuppl: torch.Tensor

    # ------------------------------------------------------------------
    @property
    def batch_shape(self) -> tuple:
        """Always (): a stack of sparse LPs is not ported (ROADMAP.md §1,
        the sparse batch)."""
        return ()

    @property
    def N(self) -> int:
        return self.cN.shape[0]

    @property
    def n0(self) -> int:
        return self.c0.shape[-1]

    @property
    def n(self) -> int:
        return self.cN.shape[1]

    @property
    def mE(self) -> int:
        return self.bN.shape[1]

    @property
    def mI(self) -> int:
        return self.iclowN.shape[1]

    @property
    def m0E(self) -> int:
        return self.b0.shape[0]

    @property
    def m0I(self) -> int:
        return self.iclow0.shape[0]

    @property
    def mEl(self) -> int:
        return self.bl.shape[0]

    @property
    def mIl(self) -> int:
        return self.iclowl.shape[0]

    @property
    def device(self) -> torch.device:
        return self.c0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.c0.dtype

    def total_vars(self) -> int:
        return self.n0 + self.N * self.n

    def total_eq(self) -> int:
        return self.m0E + self.N * self.mE + self.mEl

    def total_ineq(self) -> int:
        return self.m0I + self.N * self.mI + self.mIl

    def _map(self, on_tensor, on_ell) -> "SparseArrowheadLP":
        return SparseArrowheadLP(**{
            f.name: (on_ell if isinstance(v, Ell) else on_tensor)(v)
            for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),)})

    def astype(self, dtype) -> "SparseArrowheadLP":
        """Cast every floating field; ELL column ids stay int32."""
        return self._map(lambda t: t.to(dtype), lambda e: e.astype(dtype))

    def to(self, device) -> "SparseArrowheadLP":
        return self._map(lambda t: t.to(device), lambda e: e.to(device))

    def datanorm(self) -> torch.Tensor:
        """inf-norm over all problem data (reference Problem::datanorm)."""
        leaves = [self.c0, self.A0, self.b0, self.C0, self.cN, self.A,
                  self.B.val, self.bN, self.C, self.D.val, self.F0, self.F,
                  self.bl, self.G0, self.G,
                  self.clow0 * self.iclow0, self.cupp0 * self.icupp0,
                  self.xlow0 * self.ixlow0, self.xupp0 * self.ixupp0,
                  self.clowN * self.iclowN, self.cuppN * self.icuppN,
                  self.xlowN * self.ixlowN, self.xuppN * self.ixuppN,
                  self.clowl * self.iclowl, self.cuppl * self.icuppl]
        return torch.stack([_maxabs(t) for t in leaves]).max()


def make_sparse_arrowhead_lp(blocks: list, first_stage: dict,
                             linking_eq: dict | None = None,
                             linking_ineq: dict | None = None,
                             dtype=torch.float64, device="cpu",
                             K: int | None = None) -> SparseArrowheadLP:
    """Build a SparseArrowheadLP from per-block dicts without densifying
    the big diagonal blocks: `blocks[i]["B"]` / `["D"]` are
    `core.csr.CsrMatrix` (dense arrays are accepted and converted).
    Everything else follows `core.lp.make_arrowhead_lp`, including its
    exact-equivalence padding of heterogeneous blocks (a padded eq row is
    paired with a padded variable by a unit entry)."""
    from pips_ipmpp_tpu_torch.core.csr import CsrMatrix
    from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp

    blocks = [dict(b) for b in blocks]
    n_max = max(len(b["c"]) for b in blocks)
    mE_max = max(np.asarray(b["b"]).shape[0] for b in blocks)
    mI_max = max(np.asarray(b["clow"]).shape[0] for b in blocks)

    def as_csr(M, shape):
        if isinstance(M, CsrMatrix):
            if M.shape != shape:
                raise ValueError(f"CSR block shape {M.shape} != {shape}")
            return M
        return CsrMatrix.from_dense(np.asarray(M))

    # pull the sparse diagonals out, pad them in triplet space, and hand
    # the rest to the dense builder with zero-placeholder diagonals
    trips_B, trips_D = [], []
    for b in blocks:
        n_old = len(b["c"])
        mE_old = np.asarray(b["b"]).shape[0]
        mI_old = np.asarray(b["clow"]).shape[0]
        Bc = as_csr(b["B"], (mE_old, n_old))
        Dc = as_csr(b["D"], (mI_old, n_old))
        r, c, v = Bc.to_triplets()
        # pin padded eq row j to padded var j (cf. lp._pad_block)
        npair = min(mE_max - mE_old, n_max - n_old)
        pr = np.arange(mE_old, mE_old + npair)
        pc = np.arange(n_old, n_old + npair)
        trips_B.append((np.concatenate([r, pr]), np.concatenate([c, pc]),
                        np.concatenate([v, np.ones(npair)])))
        trips_D.append(Dc.to_triplets())
        b["B"] = np.zeros((mE_old, n_old))
        b["D"] = np.zeros((mI_old, n_old))

    dense = make_arrowhead_lp(blocks, first_stage, linking_eq, linking_ineq,
                              dtype=dtype, device=device)
    B = ell_from_triplets([t[0] for t in trips_B], [t[1] for t in trips_B],
                          [t[2] for t in trips_B], mE_max, n_max, K)
    D = ell_from_triplets([t[0] for t in trips_D], [t[1] for t in trips_D],
                          [t[2] for t in trips_D], mI_max, n_max, K)
    B = B.astype(dtype).to(device)
    D = D.astype(dtype).to(device)
    sp = sparse_from_dense(dense, K=1)   # reuse the field plumbing
    return dataclasses.replace(sp, B=B, Bt=ell_transpose(B, n_max),
                               D=D, Dt=ell_transpose(D, n_max))


def sparse_from_dense(lp: ArrowheadLP, K: int | None = None
                      ) -> SparseArrowheadLP:
    """Convert a dense ArrowheadLP whose B/D blocks are sparse in content
    into ELL storage (host-side; tests and small fixtures)."""
    B = ell_from_dense(lp.B.cpu().numpy(), K).to(lp.device)
    D = ell_from_dense(lp.D.cpu().numpy(), K).to(lp.device)
    kw = {f.name: getattr(lp, f.name) for f in dataclasses.fields(lp)}
    kw.update(B=B, Bt=ell_transpose(B, lp.n), D=D,
              Dt=ell_transpose(D, lp.n))
    return SparseArrowheadLP(**kw)


def dense_from_sparse(slp: SparseArrowheadLP) -> ArrowheadLP:
    """Densify a SparseArrowheadLP back into the batched-dense ArrowheadLP
    (the facade's route for problems whose dense twin fits
    `Options.sparse_densify_max_mb`)."""
    kw = {}
    for f in dataclasses.fields(ArrowheadLP):
        if f.name in ("B", "D"):
            kw[f.name] = ell_to_dense(getattr(slp, f.name), slp.n)
        else:
            kw[f.name] = getattr(slp, f.name)
    return ArrowheadLP(**kw)


def dense_bytes(slp: SparseArrowheadLP) -> int:
    """Bytes the densified B/D blocks would occupy (the densify budget)."""
    itemsize = slp.c0.element_size()
    return (slp.N * (slp.mE + slp.mI) * slp.n) * itemsize
