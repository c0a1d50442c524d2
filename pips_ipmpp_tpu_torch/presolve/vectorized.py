"""Vectorized row-scope machinery for the presolve passes (counterpart of
`pips_ipmpp_tpu/presolve/vectorized.py`, the same host numpy).

The reference presolves millions of rows through C++ loops over dynamic CSR
(PresolveData.C); the round-1 passes here iterated Python tuples per row —
O(rows) interpreter work per round.  This module replaces the row scans
with batched numpy over the padded block arrays: every scope (first-stage
rows, all block rows batched [N, m, k], linking rows) is processed with a
handful of array ops, and only the (few) rows/columns that actually reduce
are touched individually through the event-logging PresolveData API.

Scopes (matching the reference's per-node processing,
StochPresolverBase.C::updatePointersForCurrentNode):
  - "first": eq rows A0 [m0E, n0] / ineq C0 — columns are first-stage only
  - "block": eq rows [A|B] [N, mE, n0+n] / ineq [C|D] — batched over blocks
  - "link":  eq rows [F0 | F_1 .. F_N] [mEl, n0+N*n] / ineq [G0 | G..]
"""
from __future__ import annotations

import numpy as np

from pips_ipmpp_tpu_torch.presolve.data import FIRST, LINK, PresolveData


def var_bound_arrays(pd: PresolveData):
    """(lo0, up0, loN, upN) in +-inf form."""
    lo0 = np.where(pd.ixlow0 > 0, pd.xlow0, -np.inf)
    up0 = np.where(pd.ixupp0 > 0, pd.xupp0, np.inf)
    loN = np.where(pd.ixlowN > 0, pd.xlowN, -np.inf)
    upN = np.where(pd.ixuppN > 0, pd.xuppN, np.inf)
    return lo0, up0, loN, upN


class Scope:
    """One vectorized row scope: coefficient matrix K over flat columns,
    with maps back to (var_blk, j) and (row_blk, r).

    `parts` (optional) carries the UNCONCATENATED constituents as
    (array, tag, col_offset) tuples — tag "cols" for a plain column
    span ([m, k] or [N, m, k]), tag "linkstrip" for [N, mL, n] strips
    whose flat column is off + i*n + j.  CooScope extracts nonzero
    entries from the parts directly; dense consumers touching `.K`
    pay the concatenation lazily."""

    def __init__(self, kind: str, K, active: np.ndarray,
                 lo: np.ndarray, up: np.ndarray, parts=None):
        self.kind = kind          # "first" | "block" | "link"
        self._K = K               # [m, k] or [N, m, k] (or None: lazy)
        self.parts = parts
        self.active = active      # [m] or [N, m] bool
        self.lo = lo              # [k] or [N, k] column lower bounds
        self.up = up

    def row_nnz(self) -> np.ndarray:
        """Nonzeros per row without materializing the concatenated K."""
        if self.parts is None:
            return np.count_nonzero(self.K, axis=-1)
        out = np.zeros(self.active.shape, np.int64)
        for arr, tag, off in self.parts:
            if tag == "linkstrip":                   # [N, mL, n]
                out += np.count_nonzero(arr, axis=(0, 2))
            else:
                out += np.count_nonzero(arr, axis=-1)
        return out

    @property
    def K(self):
        if self._K is None:
            arrs = []
            for arr, tag, off in self.parts:
                if tag == "linkstrip":
                    arrs.append(np.swapaxes(arr, 0, 1)
                                .reshape(arr.shape[1], -1))
                else:
                    arrs.append(arr)
            self._K = np.concatenate(arrs, axis=-1)
        return self._K

    # ---- flat column index -> (var_blk, j) ----
    def col_id(self, i_blk, flat_j, n0, n):
        if self.kind == "first":
            return FIRST, int(flat_j)
        if self.kind == "block":
            return ((FIRST, int(flat_j)) if flat_j < n0
                    else (int(i_blk), int(flat_j - n0)))
        # link: [n0 | N*n]
        if flat_j < n0:
            return FIRST, int(flat_j)
        off = flat_j - n0
        return int(off // n), int(off % n)


def eq_scopes(pd: PresolveData):
    lo0, up0, loN, upN = var_bound_arrays(pd)
    N = pd.N
    n0 = lo0.size
    out = []
    if pd.A0.shape[0]:
        out.append((Scope("first", pd.A0, pd.rowE_active0, lo0, up0),
                    pd.b0, pd.b0))
    if pd.B.shape[0] and pd.B.shape[1]:
        lo = np.concatenate([np.broadcast_to(lo0, (N, lo0.size)), loN], 1)
        up = np.concatenate([np.broadcast_to(up0, (N, up0.size)), upN], 1)
        out.append((Scope("block", None, pd.rowE_activeN, lo, up,
                          parts=[(pd.A, "cols", 0), (pd.B, "cols", n0)]),
                    pd.bN, pd.bN))
    if pd.F0.shape[0]:
        lo = np.concatenate([lo0, loN.reshape(-1)])
        up = np.concatenate([up0, upN.reshape(-1)])
        out.append((Scope("link", None, pd.rowE_activel, lo, up,
                          parts=[(pd.F0, "cols", 0),
                                 (pd.F, "linkstrip", n0)]),
                    pd.bl, pd.bl))
    return out


def ineq_scopes(pd: PresolveData):
    lo0, up0, loN, upN = var_bound_arrays(pd)
    N = pd.N
    n0 = lo0.size
    out = []

    def rb(il, lo_r, iu, up_r):
        return (np.where(il > 0, lo_r, -np.inf),
                np.where(iu > 0, up_r, np.inf))

    if pd.C0.shape[0]:
        lo_r, up_r = rb(pd.iclow0, pd.clow0, pd.icupp0, pd.cupp0)
        out.append((Scope("first", pd.C0, pd.rowI_active0, lo0, up0),
                    lo_r, up_r))
    if pd.D.shape[0] and pd.D.shape[1]:
        lo = np.concatenate([np.broadcast_to(lo0, (N, lo0.size)), loN], 1)
        up = np.concatenate([np.broadcast_to(up0, (N, up0.size)), upN], 1)
        lo_r, up_r = rb(pd.iclowN, pd.clowN, pd.icuppN, pd.cuppN)
        out.append((Scope("block", None, pd.rowI_activeN, lo, up,
                          parts=[(pd.C, "cols", 0), (pd.D, "cols", n0)]),
                    lo_r, up_r))
    if pd.G0.shape[0]:
        lo = np.concatenate([lo0, loN.reshape(-1)])
        up = np.concatenate([up0, upN.reshape(-1)])
        lo_r, up_r = rb(pd.iclowl, pd.clowl, pd.icuppl, pd.cuppl)
        out.append((Scope("link", None, pd.rowI_activel, lo, up,
                          parts=[(pd.G0, "cols", 0),
                                 (pd.G, "linkstrip", n0)]),
                    lo_r, up_r))
    return out


# ======================================================================
# Compressed (COO) scope machinery — the padded block scopes are ~1%
# dense (10^3-row energy/stochastic blocks carry ~10 nnz/row), so the
# dense [N, m, k] candidate tensors of the round-2..3 implementation
# moved ~10 GB of zeros per pass at the 10^5-variable scale.  All
# activity/implied-bound work now runs on the nonzero entries only
# (the in-spirit equivalent of the reference's dynamic CSR scans,
# PresolveData.C).
# ======================================================================

class CooScope:
    """Nonzero entries of a Scope restricted to ACTIVE rows.

    Arrays over entries: b (block id or 0), r (row), c (flat column),
    v (value), lo_e/up_e (column bounds), rkey (flat row key).
    Per-flat-row aggregates: fin_min/fin_max/neg_inf/pos_inf/nnz and the
    inf-aware min_act/max_act.
    """

    def __init__(self, scope: Scope):
        self.kind = scope.kind
        if scope.parts is not None:
            # entry extraction per part — the big block/link scopes are
            # never concatenated into a dense K
            bs, rs, cs, vs = [], [], [], []
            for arr, tag, off in scope.parts:
                arr = np.asarray(arr)
                if tag == "linkstrip":            # [N, mL, n]
                    i, r_, j = np.nonzero(arr)
                    bs.append(np.zeros_like(r_))
                    rs.append(r_)
                    cs.append(off + i * arr.shape[2] + j)
                    vs.append(arr[i, r_, j])
                elif arr.ndim == 3:               # [N, m, k_part]
                    b_, r_, c_ = np.nonzero(arr)
                    bs.append(b_)
                    rs.append(r_)
                    cs.append(c_ + off)
                    vs.append(arr[b_, r_, c_])
                else:                             # [m, k_part]
                    r_, c_ = np.nonzero(arr)
                    bs.append(np.zeros_like(r_))
                    rs.append(r_)
                    cs.append(c_ + off)
                    vs.append(arr[r_, c_])
            b = np.concatenate(bs) if bs else np.zeros(0, np.int64)
            r = np.concatenate(rs) if rs else np.zeros(0, np.int64)
            c = np.concatenate(cs) if cs else np.zeros(0, np.int64)
            v = np.concatenate(vs) if vs else np.zeros(0)
            if scope.active.ndim == 2:
                keep = scope.active[b, r]
                self.m = scope.active.shape[1]
                n_rows = scope.active.size
            else:
                keep = scope.active[r]
                self.m = scope.active.shape[0]
                n_rows = scope.active.shape[0]
            b, r, c, v = b[keep], r[keep], c[keep], v[keep]
            lo_e = (scope.lo[b, c] if scope.lo.ndim == 2
                    else scope.lo[c])
            up_e = (scope.up[b, c] if scope.up.ndim == 2
                    else scope.up[c])
            rkey = (b * self.m + r) if scope.active.ndim == 2 else r
        else:
            K = scope.K
            if K.ndim == 3:
                b, r, c = np.nonzero(K)
                keep = scope.active[b, r]
                b, r, c = b[keep], r[keep], c[keep]
                v = K[b, r, c]
                lo_e = scope.lo[b, c]
                up_e = scope.up[b, c]
                self.m = K.shape[1]
                rkey = b * self.m + r
                n_rows = K.shape[0] * K.shape[1]
            else:
                r, c = np.nonzero(K)
                keep = scope.active[r]
                r, c = r[keep], c[keep]
                v = K[r, c]
                lo_e = scope.lo[c]
                up_e = scope.up[c]
                b = np.zeros_like(r)
                self.m = K.shape[0]
                rkey = r
                n_rows = K.shape[0]
        self.b, self.r, self.c, self.v = b, r, c, v
        self.lo_e, self.up_e = lo_e, up_e
        self.rkey, self.n_rows = rkey, n_rows

        with np.errstate(invalid="ignore"):
            mins = np.where(v > 0, v * lo_e, v * up_e)
            maxs = np.where(v > 0, v * up_e, v * lo_e)
        self.mins, self.maxs = mins, maxs
        neg = np.isneginf(mins)
        pos = np.isposinf(maxs)
        self.neg, self.pos = neg, pos
        self.fin_min = np.bincount(rkey, np.where(neg, 0.0, mins),
                                   minlength=n_rows)
        self.fin_max = np.bincount(rkey, np.where(pos, 0.0, maxs),
                                   minlength=n_rows)
        self.neg_inf = np.bincount(rkey, neg, minlength=n_rows)
        self.pos_inf = np.bincount(rkey, pos, minlength=n_rows)
        self.nnz = np.bincount(rkey, minlength=n_rows)

    def row_acts(self):
        """(min_act, max_act, nnz) per flat row (inf-aware)."""
        min_act = np.where(self.neg_inf > 0, -np.inf, self.fin_min)
        max_act = np.where(self.pos_inf > 0, np.inf, self.fin_max)
        return min_act, max_act, self.nnz

    def implied_entry_bounds(self, lo_r, up_r):
        """Per-ENTRY implied bounds on the entry's variable from its row
        (same math as the reference StochPresolverBoundStrengthening,
        computed on nonzeros only).  lo_r/up_r: per-row bounds in the
        scope's row shape; returns (cand_lo_e, cand_up_e)."""
        # both row-bound layouts ([m] and [N, m]) flatten to n_rows
        lo_rf = np.ravel(np.asarray(lo_r))[self.rkey]
        up_rf = np.ravel(np.asarray(up_r))[self.rkey]
        k = self.rkey
        inf_lo_others = self.neg_inf[k] - self.neg
        inf_hi_others = self.pos_inf[k] - self.pos
        min_others = np.where(
            inf_lo_others > 0, -np.inf,
            self.fin_min[k] - np.where(self.neg, 0.0, self.mins))
        max_others = np.where(
            inf_hi_others > 0, np.inf,
            self.fin_max[k] - np.where(self.pos, 0.0, self.maxs))
        v = self.v
        with np.errstate(invalid="ignore"):
            hi = up_rf - min_others        # v * x_j <= hi
            lo2 = lo_rf - max_others       # v * x_j >= lo2
            cand_up = np.where(v > 0, hi / v, lo2 / v)
            cand_lo = np.where(v > 0, lo2 / v, hi / v)
        usable = self.nnz[k] >= 2
        cand_up = np.where(usable & np.isfinite(cand_up), cand_up, np.inf)
        cand_lo = np.where(usable & np.isfinite(cand_lo), cand_lo, -np.inf)
        return cand_lo, cand_up

    def var_ids(self, n0: int, nv: int):
        """Global flat variable id per entry: FIRST j -> j,
        block (i, j) -> n0 + i*nv + j."""
        if self.kind == "first":
            return self.c.astype(np.int64)
        if self.kind == "block":
            return np.where(self.c < n0, self.c,
                            n0 + self.b * nv + (self.c - n0)).astype(np.int64)
        # link: columns already [n0 | N*nv] flat
        return self.c.astype(np.int64)

    def row_blk_r(self):
        """(row_blk, r) per entry in PresolveData convention."""
        if self.kind == "first":
            return np.full(self.r.shape, FIRST, np.int64), self.r
        if self.kind == "block":
            return self.b.astype(np.int64), self.r
        return np.full(self.r.shape, LINK, np.int64), self.r
