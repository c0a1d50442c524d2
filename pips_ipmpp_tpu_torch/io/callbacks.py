"""Callback-based problem input: the equivalent of the reference's
`DistributedInputTree` (Core/Readers/Distributed/DistributedInputTree.h:
11-39): the user supplies per-block callbacks that return sizes and data
on demand; the tree is materialized into the batched ArrowheadLP.  CSR
triplets are accepted and densified (the batched-dense layout is the
device storage format).

Counterpart of `pips_ipmpp_tpu/io/callbacks.py`: the same callbacks give
both packages the same arrays bit for bit.  `build_sparse` keeps the
diagonal blocks in ELL form (`core/sparse.py`).  The LP is built on
`device` (the CPU by default, like `io/blockfile.read_blocks`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp


def csr_to_dense(m: int, n: int, krow, jcol, vals) -> np.ndarray:
    """Row-major CSR triplets (the reference's FMAT callback format,
    DistributedInputTree.h:13) to dense."""
    out = np.zeros((m, n))
    krow = np.asarray(krow)
    jcol = np.asarray(jcol)
    vals = np.asarray(vals, dtype=np.float64)
    rows = np.repeat(np.arange(m), np.diff(krow))
    out[rows, jcol[:len(rows)]] = vals[:len(rows)]
    return out


def _dense_mat(cb, blk_id, m, n) -> np.ndarray:
    """A matrix callback's result, dense [m, n] (zeros without one)."""
    if cb is None:
        return np.zeros((m, n))
    out = cb(blk_id)
    if isinstance(out, tuple):
        return csr_to_dense(m, n, *out)
    out = np.asarray(out, dtype=np.float64)
    if out.shape != (m, n):
        raise ValueError(f"block {blk_id}: a matrix callback returned shape "
                         f"{out.shape}, expected {(m, n)}")
    return out


def _sparse_mat(cb, blk_id, m, n):
    """A diagonal-block callback's result as a CsrMatrix, never dense."""
    from pips_ipmpp_tpu_torch.core.csr import CsrMatrix

    if cb is None:
        return CsrMatrix.from_triplets([], [], [], (m, n))
    out = cb(blk_id)
    if isinstance(out, CsrMatrix):
        return out
    if isinstance(out, tuple):
        krow, jcol, vals = out
        indptr = np.asarray(krow, np.int64)
        nnz = int(indptr[-1])
        return CsrMatrix(indptr, np.asarray(jcol, np.int32)[:nnz],
                         np.asarray(vals, np.float64)[:nnz], (m, n))
    return CsrMatrix.from_dense(np.asarray(out, np.float64))


@dataclass
class BlockCallbacks:
    """Per-node data provider. Each callback takes the block id and returns
    numpy data; matrix callbacks may return either a dense array or a CSR
    triple (krow, jcol, vals) with shape metadata handled by the tree."""
    id: int
    n_vars: Callable[[int], int]
    n_eq: Callable[[int], int]
    n_ineq: Callable[[int], int]
    vec_c: Callable[[int], np.ndarray]
    mat_A: Callable[[int], object]      # border (eq) — ignored for id 0
    mat_B: Callable[[int], object]      # diagonal (eq); A0 for id 0
    vec_b: Callable[[int], np.ndarray]
    mat_C: Callable[[int], object]
    mat_D: Callable[[int], object]
    vec_clow: Callable[[int], np.ndarray]
    vec_iclow: Callable[[int], np.ndarray]
    vec_cupp: Callable[[int], np.ndarray]
    vec_icupp: Callable[[int], np.ndarray]
    vec_xlow: Callable[[int], np.ndarray]
    vec_ixlow: Callable[[int], np.ndarray]
    vec_xupp: Callable[[int], np.ndarray]
    vec_ixupp: Callable[[int], np.ndarray]
    mat_F: Optional[Callable[[int], object]] = None    # linking eq strip
    mat_G: Optional[Callable[[int], object]] = None    # linking ineq strip


_VECS = ("iclow", "clow", "icupp", "cupp", "ixlow", "xlow", "ixupp", "xupp")


@dataclass
class InputTree:
    """Root (id 0) + children (ids 1..N) + linking-row data."""
    root: BlockCallbacks
    children: list
    n_linking_eq: int = 0
    n_linking_ineq: int = 0
    vec_bl: Optional[Callable[[], np.ndarray]] = None
    vec_dllow: Optional[Callable[[], np.ndarray]] = None
    vec_idllow: Optional[Callable[[], np.ndarray]] = None
    vec_dlupp: Optional[Callable[[], np.ndarray]] = None
    vec_idlupp: Optional[Callable[[], np.ndarray]] = None

    def _gather(self, diag_mat):
        """(blocks, first_stage, linking_eq, linking_ineq) dicts for
        `make_arrowhead_lp` and `make_sparse_arrowhead_lp`; the children's
        B and D come from `diag_mat`."""
        mEl, mIl = self.n_linking_eq, self.n_linking_ineq

        def vecs(cb, i):
            return {k: np.asarray(getattr(cb, f"vec_{k}")(i), np.float64)
                    for k in ("c", "b") + _VECS}

        r = self.root
        n0 = r.n_vars(0)
        m0E, m0I = r.n_eq(0), r.n_ineq(0)
        first = dict(
            vecs(r, 0),
            # the root's diagonal is A0 (the reference's Bmat)
            A=_dense_mat(r.mat_B, 0, m0E, n0),
            C=_dense_mat(r.mat_D, 0, m0I, n0),
            F0=_dense_mat(r.mat_F, 0, mEl, n0),
            G0=_dense_mat(r.mat_G, 0, mIl, n0),
        )
        blocks = []
        for cb in self.children:
            i = cb.id
            ni, mEi, mIi = cb.n_vars(i), cb.n_eq(i), cb.n_ineq(i)
            blocks.append(dict(
                vecs(cb, i),
                A=_dense_mat(cb.mat_A, i, mEi, n0),
                B=diag_mat(cb.mat_B, i, mEi, ni),
                C=_dense_mat(cb.mat_C, i, mIi, n0),
                D=diag_mat(cb.mat_D, i, mIi, ni),
                F=_dense_mat(cb.mat_F, i, mEl, ni),
                G=_dense_mat(cb.mat_G, i, mIl, ni),
            ))

        def link(fn, m):
            return np.asarray(fn(), np.float64) if fn else np.zeros(m)

        linking_eq = {"b": link(self.vec_bl, mEl)}
        linking_ineq = {"iclow": link(self.vec_idllow, mIl),
                        "clow": link(self.vec_dllow, mIl),
                        "icupp": link(self.vec_idlupp, mIl),
                        "cupp": link(self.vec_dlupp, mIl)}
        return blocks, first, linking_eq, linking_ineq

    def build(self, dtype=torch.float64, max_block_vars: int | None = None,
              bucketed: bool = False, device="cpu"):
        """Assemble the batched problem (an ArrowheadLP, or with
        `bucketed` a BucketedArrowheadLP whose blocks keep their own
        sizes, `core/bucketed.py`).  `max_block_vars` splits oversized
        blocks at intake (core/dissect.refine_blocks).

        When blocks were split, `self.refine_placement[i]` holds the
        (new_block | FIRST, local_index) per original block-i variable so
        callers can map solutions back to the pre-split ordering."""
        blocks, first, linking_eq, linking_ineq = self._gather(_dense_mat)
        self.refine_placement = None
        if max_block_vars is not None:
            from pips_ipmpp_tpu_torch.core.dissect import refine_blocks
            blocks, first, self.refine_placement = refine_blocks(
                blocks, first, max_block_vars)
        if bucketed:
            from pips_ipmpp_tpu_torch.core.bucketed import \
                make_bucketed_arrowhead_lp
            return make_bucketed_arrowhead_lp(
                blocks, first, linking_eq, linking_ineq, dtype=dtype,
                device=device)
        return make_arrowhead_lp(blocks, first, linking_eq, linking_ineq,
                                 dtype=dtype, device=device)

    def build_sparse(self, dtype=torch.float64, K: int | None = None,
                     device="cpu"):
        """Build a SparseArrowheadLP keeping the diagonal blocks B/D in
        CSR->ELL form end-to-end — never densified (the intake for
        reference-class sparse instances; the reference's FMAT callbacks
        deliver CSR, DistributedInputTree.h:13, and SparseStorage keeps
        them sparse).  Borders (A, C) and linking strips (F, G) stay
        dense: their minor dimension is the small root/link size."""
        from pips_ipmpp_tpu_torch.core.sparse import make_sparse_arrowhead_lp

        blocks, first, linking_eq, linking_ineq = self._gather(_sparse_mat)
        return make_sparse_arrowhead_lp(blocks, first, linking_eq,
                                        linking_ineq, dtype=dtype,
                                        device=device, K=K)
