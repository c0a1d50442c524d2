"""Presolve passes (counterpart of `pips_ipmpp_tpu/presolve/passes.py`, the
same host numpy; the native scans come from `pips_ipmpp_tpu_torch.native`),
run in the reference's registration order
(StochPresolver.C:36-50): ModelCleanup -> SingletonRows -> ColumnFixation ->
ParallelRows -> BoundStrengthening.  Host-side numpy (control-heavy, off the
IPM hot path — the same position presolve occupies in the reference).

Each pass returns the number of reductions applied.
"""
from __future__ import annotations

import numpy as np

from pips_ipmpp_tpu_torch.presolve.data import FIRST, LINK, PresolveData

TINY_ABS = 1e-12
TINY_REL = 1e-10
FEASTOL = 1e-9


# ----------------------------------------------------------------------
# row iteration helpers: yield (blk, r, coeffs: list[(var_blk, j, a)],
#                               rhs-ish data)
# ----------------------------------------------------------------------

def _var_bounds(pd, vb, j):
    _, ixl, xl, ixu, xu, _ = pd.var_arrays(vb)
    lo = xl[j] if ixl[j] > 0 else -np.inf
    up = xu[j] if ixu[j] > 0 else np.inf
    return lo, up


# ======================================================================
# Pass 1: model cleanup (reference StochPresolverModelCleanup)
# ======================================================================

def _scope_blk(scope, ix):
    """Map a scope row index tuple to the PresolveData (blk, r) address."""
    if scope.kind == "first":
        return FIRST, int(ix[0])
    if scope.kind == "block":
        return int(ix[0]), int(ix[1])
    return LINK, int(ix[0])


def model_cleanup(pd: PresolveData) -> int:
    from pips_ipmpp_tpu_torch.presolve import vectorized as V

    n = 0

    def ranges_of(vb):
        _, ixl, xl, ixu, xu, _ = pd.var_arrays(vb)
        lo = np.where(ixl > 0, xl, -np.inf)
        up = np.where(ixu > 0, xu, np.inf)
        return up - lo

    # drop tiny matrix entries (relative to row max, and only when the
    # entry's IMPACT |a| * bound-range is negligible — a tiny coefficient
    # on an unbounded variable must stay)
    r0 = ranges_of(FIRST)
    for M in (pd.A0, pd.C0, pd.F0, pd.G0):
        n += _drop_tiny(M, r0)
    for M in (pd.A, pd.C):                    # first-stage borders
        n += _drop_tiny(M, r0)                # [N, m, n0], range broadcast
    rangesN = np.stack([ranges_of(i) for i in range(pd.N)])   # [N, n]
    for M in (pd.B, pd.D, pd.F, pd.G):        # block-variable columns
        n += _drop_tiny(M, rangesN)

    # empty rows (vectorized nnz over scopes).  Infeasibility tests are
    # RELATIVE to the substitution magnitudes this row absorbed: after
    # fixing variables at O(M) values, float cancellation legitimately
    # leaves an O(eps * M) residual on an emptied row
    for scope, b, _ in V.eq_scopes(pd):
        empty = (scope.row_nnz() == 0) & scope.active
        tol = FEASTOL * (1.0 + _eq_shift(pd, scope.kind))
        if np.any(empty & (np.abs(np.asarray(b)) > tol)):
            pd.infeasible = True
            return n
        for ix in np.argwhere(empty):
            pd.remove_eq_row(*_scope_blk(scope, ix), "empty_row")
            n += 1
    for scope, lo_r, up_r in V.ineq_scopes(pd):
        empty = (scope.row_nnz() == 0) & scope.active
        tol = FEASTOL * (1.0 + _ineq_shift(pd, scope.kind))
        if np.any(empty & ((np.asarray(lo_r) > tol)
                           | (np.asarray(up_r) < -tol))):
            pd.infeasible = True
            return n
        for ix in np.argwhere(empty):
            pd.remove_ineq_row(*_scope_blk(scope, ix), "empty_row")
            n += 1

    # redundant rows implied by variable bounds
    n += redundant_rows(pd)
    return n


def _eq_shift(pd, kind):
    return {"first": pd.rhs_shift0, "block": pd.rhs_shiftN,
            "link": pd.rhs_shiftl}[kind]


def _ineq_shift(pd, kind):
    return {"first": pd.rhs_shiftI0, "block": pd.rhs_shiftIN,
            "link": pd.rhs_shiftIl}[kind]


def _drop_tiny(M, col_range=None) -> int:
    """Zero entries that are both tiny and of negligible IMPACT.

    `col_range` [n] is each variable's bound range (inf when a side is
    missing): an entry may only be dropped when |a| * range is below the
    feasibility tolerance — a 1e-13 coefficient on an UNBOUNDED variable
    can carry arbitrarily large activity and must stay (the reference's
    PRESOLVE_MODEL_CLEANUP_MATRIX_ENTRY_IMPACT_FEASDIST rule)."""
    if M.size == 0:
        return 0
    from pips_ipmpp_tpu_torch import native
    if col_range is None:
        if M.dtype == np.float64 and M.flags.c_contiguous:
            return native.drop_tiny_entries(M, TINY_ABS, TINY_REL)
        col_range = np.zeros(M.shape[-1])
    elif M.dtype == np.float64 and M.flags.c_contiguous \
            and col_range.shape[-1] == M.shape[-1]:
        # fused one-pass native kernel (the numpy formulation below makes
        # ~6 full passes over each [N, m, n] block array — ~30 s at the
        # 102k-var energy instance, the round-4 presolve bottleneck)
        dropped = native.drop_tiny_impact(M, col_range, FEASTOL,
                                          TINY_ABS, TINY_REL)
        if dropped is not None:
            return dropped
    # col_range broadcasts along the row axis: [n] against [m, n] or
    # [N, 1, n] (via expand_dims) against batched [N, m, n]
    cr = np.expand_dims(col_range, -2) if col_range.ndim == M.ndim - 1 \
        else col_range
    rowmax = np.max(np.abs(M), axis=-1, keepdims=True)
    absM = np.abs(M)
    with np.errstate(invalid="ignore"):
        impact_ok = np.where(np.isfinite(cr),
                             absM * np.where(np.isfinite(cr),
                                             cr, 0.0) < FEASTOL,
                             False)
    mask = ((absM > 0) & impact_ok
            & ((absM < TINY_ABS) | (absM < TINY_REL * rowmax)))
    M[mask] = 0.0
    return int(mask.sum())


# ======================================================================
# Pass 2: singleton rows (reference StochPresolverSingletonRows)
# ======================================================================

def _scope_singletons(scope):
    """Vectorized singleton-row detection: yields the row index tuples of
    active rows with exactly one nonzero (candidates only — callers
    re-validate and re-locate the column against LIVE data)."""
    single = (scope.row_nnz() == 1) & scope.active
    for ix in np.argwhere(single):
        yield ix


def _live_eq_row(pd: PresolveData, kind: str, ix):
    """Current (row_vector, rhs, active) straight from pd (the scope
    snapshot is a copy — mutations during a sweep must be re-validated)."""
    if kind == "first":
        r = int(ix[0])
        return pd.A0[r], float(pd.b0[r]), bool(pd.rowE_active0[r])
    if kind == "block":
        i, r = int(ix[0]), int(ix[1])
        return (np.concatenate([pd.A[i][r], pd.B[i][r]]),
                float(pd.bN[i, r]), bool(pd.rowE_activeN[i, r]))
    r = int(ix[0])
    return (np.concatenate([pd.F0[r], np.ascontiguousarray(
        pd.F[:, r, :]).reshape(-1)]), float(pd.bl[r]),
        bool(pd.rowE_activel[r]))


def _live_ineq_row(pd: PresolveData, kind: str, ix):
    if kind == "first":
        r = int(ix[0])
        lo = float(pd.clow0[r]) if pd.iclow0[r] > 0 else -np.inf
        up = float(pd.cupp0[r]) if pd.icupp0[r] > 0 else np.inf
        return pd.C0[r], lo, up, bool(pd.rowI_active0[r])
    if kind == "block":
        i, r = int(ix[0]), int(ix[1])
        lo = float(pd.clowN[i, r]) if pd.iclowN[i, r] > 0 else -np.inf
        up = float(pd.cuppN[i, r]) if pd.icuppN[i, r] > 0 else np.inf
        return (np.concatenate([pd.C[i][r], pd.D[i][r]]), lo, up,
                bool(pd.rowI_activeN[i, r]))
    r = int(ix[0])
    lo = float(pd.clowl[r]) if pd.iclowl[r] > 0 else -np.inf
    up = float(pd.cuppl[r]) if pd.icuppl[r] > 0 else np.inf
    return (np.concatenate([pd.G0[r], np.ascontiguousarray(
        pd.G[:, r, :]).reshape(-1)]), lo, up, bool(pd.rowI_activel[r]))


def singleton_rows(pd: PresolveData) -> int:
    from pips_ipmpp_tpu_torch.presolve import vectorized as V

    n0v, nv = pd.c0.size, pd.cN.shape[1]
    n = 0
    changed = True
    while changed and not pd.infeasible:
        changed = False
        for scope, b, _ in V.eq_scopes(pd):
            for ix in _scope_singletons(scope):
                blk, r = _scope_blk(scope, ix)
                i_blk = ix[0] if scope.kind == "block" else 0
                # re-validate against LIVE data: an earlier fix in this
                # sweep may have changed this row since the scope
                # snapshot (shared variable between two singleton rows)
                rowv, brhs, row_active = _live_eq_row(pd, scope.kind, ix)
                if not row_active:
                    continue
                nz = np.nonzero(rowv)[0]
                if nz.size == 0:
                    # emptied by an earlier fix: contradictory rhs is
                    # infeasibility (scale-aware), ~0 rhs is cleanup's job
                    sh = _eq_shift(pd, scope.kind)[tuple(ix)]
                    if abs(brhs) > FEASTOL * (1.0 + sh):
                        pd.infeasible = True
                        return n
                    continue
                if nz.size != 1:
                    continue
                fj = int(nz[0])
                vb, j = scope.col_id(i_blk, fj, n0v, nv)
                a = float(rowv[fj])
                val = brhs / a
                lo, up = _var_bounds(pd, vb, j)
                if val < lo - FEASTOL or val > up + FEASTOL:
                    pd.infeasible = True
                    return n
                pd.remove_eq_row(blk, r, "singleton_row")
                pd.fix_variable(vb, j, val, reason="singleton_eq_row")
                # annotate the FIXED_COLUMN event with its defining row
                pd.events[-1].data.update(row_blk=blk, row_idx=r, row_coef=a)
                n += 1
                changed = True
        for scope, lo_arr, up_arr in V.ineq_scopes(pd):
            for ix in _scope_singletons(scope):
                blk, r = _scope_blk(scope, ix)
                i_blk = ix[0] if scope.kind == "block" else 0
                # re-validate against LIVE data (see eq loop above)
                rowv, lo_r, up_r, row_active = _live_ineq_row(
                    pd, scope.kind, ix)
                if not row_active:
                    continue
                nz = np.nonzero(rowv)[0]
                if nz.size != 1:
                    continue
                fj = int(nz[0])
                vb, j = scope.col_id(i_blk, fj, n0v, nv)
                a = float(rowv[fj])
                if a > 0:
                    nl = lo_r / a if np.isfinite(lo_r) else None
                    nu = up_r / a if np.isfinite(up_r) else None
                else:
                    nl = up_r / a if np.isfinite(up_r) else None
                    nu = lo_r / a if np.isfinite(lo_r) else None
                old_lo, old_up = _var_bounds(pd, vb, j)
                pd.remove_ineq_row(blk, r, "singleton_row", var_blk=vb, j=j,
                                   coef=a, old_var_bounds=(old_lo, old_up))
                pd.tighten_bounds(vb, j, nl, nu, reason="singleton_ineq_row",
                                  implied_lo=("ineq", blk, r),
                                  implied_upp=("ineq", blk, r))
                n += 1
                changed = True
                if pd.infeasible:
                    return n
    return n


# ======================================================================
# Pass 3: column fixation (reference StochPresolverColumnFixation)
# ======================================================================

def column_fixation(pd: PresolveData, tol: float = 1e-11) -> int:
    n = 0
    for vb in [FIRST] + list(range(pd.N)):
        c, ixl, xl, ixu, xu, active = pd.var_arrays(vb)
        for j in np.nonzero(active)[0]:
            if ixl[j] > 0 and ixu[j] > 0 and xu[j] - xl[j] < tol:
                if xu[j] < xl[j] - FEASTOL:
                    # crossed bounds (straight from user data): infeasible,
                    # NOT a fixing to the (bound-violating) midpoint
                    pd.infeasible = True
                    return n
                pd.fix_variable(vb, int(j), 0.5 * (xl[j] + xu[j]),
                                reason="column_fixation")
                n += 1
    return n


# ======================================================================
# Pass 4: parallel rows (reference StochPresolverParallelRows; exact only)
# ======================================================================

def parallel_rows(pd: PresolveData, tol: float = 1e-12) -> int:
    """Detect proportional rows within each scope (first-stage rows; rows
    of the same block; linking rows) and drop duplicates.  Rows of
    different blocks touch disjoint columns, so cross-block comparison is
    unnecessary (the reference likewise works per node,
    StochPresolverParallelRows.C:166-215)."""
    from pips_ipmpp_tpu_torch.presolve import vectorized as V

    n = 0
    for scope, b, _ in V.eq_scopes(pd):
        for sub, addr in _scope_submatrices(scope):
            n += _parallel_eq_apply(pd, sub, addr, tol)
            if pd.infeasible:
                return n
    for scope, _lo, _up in V.ineq_scopes(pd):
        for sub, addr in _scope_submatrices(scope):
            n += _parallel_ineq_apply(pd, sub, addr, tol)
            if pd.infeasible:
                return n
    return n


def _scope_submatrices(scope):
    """Yield (M [rows, k], addr list[(blk, r)]) per comparable row group:
    one group for first/link scopes, one per block for block scopes.
    Block scopes assemble per-block rows from the scope PARTS so the full
    [N, m, k] concatenation is never materialized."""
    if scope.kind == "block":
        nnz = scope.row_nnz()
        for i in range(scope.active.shape[0]):
            rows = np.nonzero(scope.active[i] & (nnz[i] > 0))[0]
            if rows.size >= 2:
                if scope.parts is not None:
                    M = np.concatenate(
                        [np.asarray(arr)[i][rows]
                         for arr, tag, off in scope.parts], axis=-1)
                else:
                    M = scope.K[i][rows]
                yield M, [(int(i), int(r)) for r in rows]
    else:
        blk = FIRST if scope.kind == "first" else LINK
        rows = np.nonzero(scope.active
                          & (scope.row_nnz() > 0))[0]
        if rows.size >= 2:
            yield scope.K[rows], [(blk, int(r)) for r in rows]


def _detect_parallel(M, tol):
    from pips_ipmpp_tpu_torch import native
    kept, dup, fct = native.detect_parallel_rows(
        np.ascontiguousarray(M, np.float64), tol)
    return zip(kept, dup, fct)


def _parallel_eq_apply(pd, M, addr, tol) -> int:
    n = 0
    for ki, di, k in _detect_parallel(M, tol):
        kept, cand = addr[int(ki)], addr[int(di)]
        b_k = _eq_rhs(pd, *kept)
        b_c = _eq_rhs(pd, *cand)
        if abs(b_c - k * b_k) > FEASTOL * max(1, abs(b_c)):
            pd.infeasible = True
            return n
        pd.remove_eq_row(cand[0], cand[1], "parallel_row",
                         kept_blk=kept[0], kept_r=kept[1], factor=float(k))
        n += 1
    return n


def _parallel_ineq_apply(pd, M, addr, tol) -> int:
    n = 0
    for ki, di, k in _detect_parallel(M, tol):
        kept, cand = addr[int(ki)], addr[int(di)]
        k = float(k)
        _, lo_c, up_c, act = _live_ineq_row(
            pd, "first" if cand[0] == FIRST else
            ("link" if cand[0] == LINK else "block"),
            (cand[1],) if cand[0] in (FIRST, LINK) else (cand[0], cand[1]))
        if not act:
            continue
        if k > 0:
            nl = lo_c / k if np.isfinite(lo_c) else None
            nu = up_c / k if np.isfinite(up_c) else None
        else:
            nl = up_c / k if np.isfinite(up_c) else None
            nu = lo_c / k if np.isfinite(lo_c) else None
        _merge_ineq_bounds(pd, kept[0], kept[1], nl, nu)
        pd.remove_ineq_row(cand[0], cand[1], "parallel_row",
                           kept_blk=kept[0], kept_r=kept[1], factor=k)
        n += 1
        if pd.infeasible:
            return n
    return n


def _merge_ineq_bounds(pd, blk, r, nl, nu):
    if blk == FIRST:
        il, lo, iu, up = pd.iclow0, pd.clow0, pd.icupp0, pd.cupp0
        idx = r
    elif blk == LINK:
        il, lo, iu, up = pd.iclowl, pd.clowl, pd.icuppl, pd.cuppl
        idx = r
    else:
        il, lo, iu, up = (pd.iclowN[blk], pd.clowN[blk],
                          pd.icuppN[blk], pd.cuppN[blk])
        idx = r
    if nl is not None and (il[idx] == 0 or nl > lo[idx]):
        il[idx] = 1.0
        lo[idx] = nl
    if nu is not None and (iu[idx] == 0 or nu < up[idx]):
        iu[idx] = 1.0
        up[idx] = nu
    if il[idx] > 0 and iu[idx] > 0 and lo[idx] > up[idx] + FEASTOL:
        pd.infeasible = True


# ======================================================================
# Nearly-parallel rows (reference StochPresolverParallelRows::
# twoNearlyParallelEqualityRows, StochPresolverParallelRows.C:788-876):
# two equality rows identical up to scale EXCEPT that each contains its
# own singleton variable (column nnz 1).  With rows
#     rest_s . x + a2 x2 = b_s        (row_singleton)
#     k rest_s . x + a1 x1 = b_o      (row_other, a1 may be 0)
# the combination eliminates x2:  x2 = t x1 + d,
#     t = a1 / (k a2),   d = (k b_s - b_o) / (k a2),
# after which row_singleton is exactly k^{-1} * row_other and is removed.
# ======================================================================

def nearly_parallel_rows(pd: PresolveData, tol: float = 1e-12) -> int:
    from pips_ipmpp_tpu_torch.presolve import vectorized as V

    n0v, nv = pd.c0.size, pd.cN.shape[1]
    cnt_eq0, cnt_iq0, cnt_eqN, cnt_iqN = _col_occurrence_counts(pd)
    single0 = (cnt_eq0 + cnt_iq0 == 1) & pd.var_active0
    singleN = (cnt_eqN + cnt_iqN == 1) & pd.var_activeN

    n = 0
    for scope, b, _ in V.eq_scopes(pd):
        # flat-column singleton mask for this scope.  For the batched
        # block scope, eligibility is computed PART-WISE (A and B
        # separately) so the [N, m, n0+n] concatenation, its singleton
        # mask, and the stripped copy are never materialized — only the
        # few eligible rows of the few eligible blocks are built densely
        # (that concatenation was ~10 s at the 102k-var energy instance).
        groups = []
        if scope.kind == "block":
            nsA = ((pd.A != 0) & single0[None, None, :]).sum(-1)
            nsB = ((pd.B != 0) & singleN[:, None, :]).sum(-1)
            n_single = nsA + nsB
            row_nnz = scope.row_nnz()
            eligible = (scope.active & (n_single <= 1)
                        & (row_nnz - n_single >= 1))
            smask_blocks = np.concatenate(
                [np.broadcast_to(single0, (pd.N, n0v)), singleN], axis=1)
            for i in np.nonzero(eligible.any(axis=1))[0]:
                rows = np.nonzero(eligible[i])[0]
                if rows.size < 2:
                    continue
                sub = np.concatenate([pd.A[i][rows], pd.B[i][rows]],
                                     axis=1)
                Ssub = (sub != 0) & smask_blocks[i][None, :]
                stripped_sub = np.where(Ssub, 0.0, sub)
                pos = {int(r): p for p, r in enumerate(rows)}
                groups.append((stripped_sub, Ssub, pos, int(i),
                               [(int(i), int(r)) for r in rows]))
        else:
            if scope.kind == "first":
                smask = single0[None, :]
            else:
                smask = np.concatenate([single0,
                                        singleN.reshape(-1)])[None, :]
            S = (scope.K != 0) & smask             # singleton entries
            n_single = S.sum(-1)
            stripped = np.where(S, 0.0, scope.K)
            eligible = (scope.active & (n_single <= 1)
                        & (np.count_nonzero(stripped, -1) >= 1))
            blk = FIRST if scope.kind == "first" else LINK
            rows = np.nonzero(eligible)[0]
            if rows.size >= 2:
                pos = {int(r): p for p, r in enumerate(rows)}
                groups.append((stripped[rows], S[rows], pos, 0,
                               [(blk, int(r)) for r in rows]))

        for M, Sm, pos, i_blk, addr in groups:
            done_rows = set()
            for ki, di, k in _detect_parallel(M, tol):
                kept, cand = addr[int(ki)], addr[int(di)]
                if kept in done_rows or cand in done_rows:
                    continue
                k = float(k)
                # locate each row's singleton entry (if any) in pd coords.
                # Sm rows are the SELECTED rows only; `pos` maps the pd
                # row index back to its position within the group.
                def singleton_of(a_addr):
                    ixr = (a_addr[1],) if a_addr[0] in (FIRST, LINK) \
                        else (a_addr[0], a_addr[1])
                    row_s = Sm[pos[int(a_addr[1])]]
                    js = np.nonzero(row_s)[0]
                    if js.size == 0:
                        return None
                    fj = int(js[0])
                    vb, j = scope.col_id(i_blk, fj, n0v, nv)
                    rowv, rhs, act = _live_eq_row(
                        pd, scope.kind, ixr)
                    return (vb, j, float(rowv[fj]), rhs, act)

                cs = singleton_of(cand)
                co = singleton_of(kept)
                # the row carrying a singleton becomes row_singleton; the
                # native kernel guarantees row[cand] = k * row[kept] on the
                # stripped support, and _apply needs row_o = kf * row_s.
                if cs is not None:
                    row_s, row_o, s_info, o_info = cand, kept, cs, co
                    kf = 1.0 / k        # row_kept = (1/k) * row_cand
                else:
                    if co is None:
                        continue        # exactly-parallel pair: other pass
                    row_s, row_o, s_info, o_info = kept, cand, co, cs
                    kf = k              # row_cand = k * row_kept
                if s_info is None or not s_info[4] or s_info[2] == 0.0:
                    continue
                if o_info is not None and not o_info[4]:
                    continue
                if _apply_nearly_parallel(pd, scope.kind, row_s, row_o,
                                          s_info, o_info, kf):
                    done_rows.update((row_s, row_o))
                    n += 1
                if pd.infeasible:
                    return n
    return n


def _apply_nearly_parallel(pd, kind, row_s, row_o, s_info, o_info, k):
    """Substitute x2 = t x1 + d and drop row_s (see nearly_parallel_rows).
    row_o = k * row_s on the stripped support."""
    vb2, j2, a2, b_s, _ = s_info
    b_o = _eq_rhs(pd, *row_o)
    c2_arr = pd.var_arrays(vb2)[0]
    c2 = float(c2_arr[j2])

    if o_info is None:
        # t = 0: x2 is fixed by the row combination
        d = (k * b_s - b_o) / (k * a2)
        lo2, up2 = _var_bounds(pd, vb2, j2)
        if d < lo2 - FEASTOL * max(1, abs(d)) \
                or d > up2 + FEASTOL * max(1, abs(d)):
            pd.infeasible = True
            return False
        # emitted BEFORE the fix so reverse replay runs it after x2 is
        # restored (dual transfer: y_s = c2/a2, y_o -= y_s/k)
        pd.emit("NEARLY_PARALLEL_SUB", vb2=vb2, j2=j2, a2=a2, c2=c2,
                vb1=None, j1=None, a1=0.0, t=0.0, d=d, k=k,
                row_s=row_s, row_o=row_o, b_s=b_s, b_o=b_o,
                x2_bounds=(lo2, up2))
        pd.fix_variable(vb2, j2, d, reason="nearly_parallel_fix")
        # after the substitution row_s == row_o / k exactly
        pd.remove_eq_row(row_s[0], row_s[1], "parallel_row",
                         kept_blk=row_o[0], kept_r=row_o[1], factor=1.0 / k)
        return True

    vb1, j1, a1, _b_o2, _ = o_info
    t = a1 / (k * a2)
    d = (k * b_s - b_o) / (k * a2)
    # transfer x2's bounds onto x1: t x1 + d in [l2, u2]
    lo2, up2 = _var_bounds(pd, vb2, j2)
    if t > 0:
        nl = (lo2 - d) / t if np.isfinite(lo2) else None
        nu = (up2 - d) / t if np.isfinite(up2) else None
    else:
        nl = (up2 - d) / t if np.isfinite(up2) else None
        nu = (lo2 - d) / t if np.isfinite(lo2) else None
    pd.emit("NEARLY_PARALLEL_SUB", vb2=vb2, j2=j2, a2=a2, c2=c2,
            vb1=vb1, j1=j1, a1=a1, t=t, d=d, k=k,
            row_s=row_s, row_o=row_o, b_s=b_s, b_o=b_o,
            x2_bounds=(lo2, up2))
    # fold objective: c2 x2 = c2 t x1 + c2 d
    c1_arr = pd.var_arrays(vb1)[0]
    c1_arr[j1] += c2 * t
    pd.objective_offset += c2 * d
    # remove row_s; deactivate x2 (its only entry was in row_s)
    pd.remove_eq_row(row_s[0], row_s[1], "nearly_parallel_row",
                     kept_blk=row_o[0], kept_r=row_o[1], factor=1.0 / k)
    _, ixl2, xl2, ixu2, xu2, act2 = pd.var_arrays(vb2)
    c2_arr[j2] = 0.0
    ixl2[j2] = 1.0
    xl2[j2] = -1.0
    ixu2[j2] = 1.0
    xu2[j2] = 1.0
    act2[j2] = False
    pd._zero_column(vb2, j2)
    if nl is not None or nu is not None:
        pd.tighten_bounds(vb1, j1, nl, nu, reason="nearly_parallel_rows")
    return True


# ======================================================================
# Pass 5: bound strengthening (reference StochPresolverBoundStrengthening)
# — vectorized over row scopes (presolve/vectorized.py); only the
# variables that actually tighten go through the event-logging API
# ======================================================================

def bound_strengthening(pd: PresolveData, max_tighten: float = 1e8) -> int:
    """Activity-based implied bounds from eq and ineq rows, computed on
    the NONZERO entries only (V.CooScope) — the padded scopes are ~1%
    dense at reference scale, so dense candidate tensors moved ~10 GB of
    zeros per pass.  Provenance (which row implied each accepted bound)
    is recovered for the few improved variables afterwards, for the
    exact postsolve dual transfer."""
    from pips_ipmpp_tpu_torch.presolve import vectorized as V

    n0, nv, N = pd.c0.size, pd.cN.shape[1], pd.N
    ntot = n0 + N * nv
    best_lo = np.full(ntot, -np.inf)
    best_up = np.full(ntot, np.inf)

    eqs = V.eq_scopes(pd)
    n_eq_scopes = len(eqs)
    scopes = ([(s, b, b) for (s, b, _b) in eqs]
              + list(V.ineq_scopes(pd)))
    entries = []     # (is_eq, coo, var_ids, cand_lo_e, cand_up_e)
    for si, (scope, lo_r, up_r) in enumerate(scopes):
        coo = V.CooScope(scope)
        if coo.v.size == 0:
            continue
        cand_lo_e, cand_up_e = coo.implied_entry_bounds(lo_r, up_r)
        vid = coo.var_ids(n0, nv)
        np.maximum.at(best_lo, vid, cand_lo_e)
        np.minimum.at(best_up, vid, cand_up_e)
        entries.append((1 if si < n_eq_scopes else 0, coo, vid,
                        cand_lo_e, cand_up_e))

    lo0, up0, loN, upN = V.var_bound_arrays(pd)
    cur_lo = np.concatenate([lo0, loN.reshape(-1)])
    cur_up = np.concatenate([up0, upN.reshape(-1)])
    active = np.concatenate([pd.var_active0,
                             pd.var_activeN.reshape(-1)])
    improve_lo = (np.isfinite(best_lo) & (np.abs(best_lo) <= max_tighten)
                  & (best_lo >= cur_lo + 1e-7) & active)
    improve_up = (np.isfinite(best_up) & (np.abs(best_up) <= max_tighten)
                  & (best_up <= cur_up - 1e-7) & active)
    improved = np.nonzero(improve_lo | improve_up)[0]
    if improved.size == 0:
        return 0

    # provenance: among the (few) improved variables, find the entry that
    # achieved the best candidate (first match across scopes)
    src_lo = {}
    src_up = {}
    imp_set_lo = set(int(j) for j in np.nonzero(improve_lo)[0])
    imp_set_up = set(int(j) for j in np.nonzero(improve_up)[0])
    for is_eq, coo, vid, cand_lo_e, cand_up_e in entries:
        rb_arr, r_arr = coo.row_blk_r()
        hit = np.nonzero(cand_lo_e == best_lo[vid])[0]
        for t in hit:
            j = int(vid[t])
            if j in imp_set_lo and j not in src_lo:
                src_lo[j] = ("eq" if is_eq else "ineq",
                             int(rb_arr[t]), int(r_arr[t]))
        hit = np.nonzero(cand_up_e == best_up[vid])[0]
        for t in hit:
            j = int(vid[t])
            if j in imp_set_up and j not in src_up:
                src_up[j] = ("eq" if is_eq else "ineq",
                             int(rb_arr[t]), int(r_arr[t]))

    n = 0
    for j in improved:
        j = int(j)
        vb, jj = (FIRST, j) if j < n0 else divmod(j - n0, nv)
        nl = float(best_lo[j]) if improve_lo[j] else None
        nu = float(best_up[j]) if improve_up[j] else None
        if pd.tighten_bounds(
                vb if vb == FIRST else int(vb), int(jj), nl, nu,
                reason="bound_strengthening",
                implied_lo=src_lo.get(j) if improve_lo[j] else None,
                implied_upp=src_up.get(j) if improve_up[j] else None):
            n += 1
        if pd.infeasible:
            return n
    return n


# ======================================================================
# Redundant rows (reference StochPresolverModelCleanup::removeRedundantRows,
# StochPresolverModelCleanup.h:34-36): an inequality row whose activity
# bounds prove both sides can never be violated is removed (dual 0)
# ======================================================================

def redundant_rows(pd: PresolveData) -> int:
    from pips_ipmpp_tpu_torch.presolve import vectorized as V

    n = 0
    for scope, lo_r, up_r in V.ineq_scopes(pd):
        coo = V.CooScope(scope)
        min_act, max_act, nnz = (a.reshape(np.shape(lo_r))
                                 for a in coo.row_acts())
        tol_lo = FEASTOL * np.maximum(1.0, np.abs(lo_r))
        tol_up = FEASTOL * np.maximum(1.0, np.abs(up_r))
        lo_ok = np.isneginf(lo_r) | (min_act >= lo_r - tol_lo)
        up_ok = np.isposinf(up_r) | (max_act <= up_r + tol_up)
        # also: provably infeasible rows
        bad = ((min_act > up_r + tol_up)
               | (max_act < lo_r - tol_lo))
        redundant = lo_ok & up_ok & scope.active & (nnz > 0)
        if np.any(bad & scope.active):
            pd.infeasible = True
            return n
        idx = np.argwhere(redundant)
        for ix in idx:
            if scope.kind == "first":
                pd.remove_ineq_row(FIRST, int(ix[0]), "redundant_row")
            elif scope.kind == "block":
                pd.remove_ineq_row(int(ix[0]), int(ix[1]), "redundant_row")
            else:
                pd.remove_ineq_row(LINK, int(ix[0]), "redundant_row")
            n += 1
    return n


# ======================================================================
# Pass 6: singleton columns (reference StochPresolverSingletonColumns;
# free column singletons in equality rows)
# ======================================================================

def _col_occurrence_counts(pd: PresolveData):
    """Vectorized (eq_count, ineq_count) per variable.  Deactivated rows
    and columns are zeroed by invariant, so plain nonzero counts are
    exact."""
    cnt_eq0 = (np.count_nonzero(pd.A0, 0) + np.count_nonzero(pd.F0, 0)
               + (np.count_nonzero(pd.A, (0, 1)) if pd.A.size else 0))
    cnt_iq0 = (np.count_nonzero(pd.C0, 0) + np.count_nonzero(pd.G0, 0)
               + (np.count_nonzero(pd.C, (0, 1)) if pd.C.size else 0))
    cnt_eqN = np.count_nonzero(pd.B, 1) + np.count_nonzero(pd.F, 1)
    cnt_iqN = np.count_nonzero(pd.D, 1) + np.count_nonzero(pd.G, 1)
    return cnt_eq0, cnt_iq0, cnt_eqN, cnt_iqN


def singleton_columns(pd: PresolveData) -> int:
    """A variable appearing in exactly one equality row can absorb the row
    when it is FREE, or when its bounds are IMPLIED by the row and the
    other variables' bounds (the reference's bounded singleton variant,
    StochPresolverSingletonColumns.C: implied-free detection): substitute
    x_j = (b_r - rest)/a_j, fold c_j into the objective and the row-mates'
    costs, and remove both the column and the row.  The row dual is
    determined at postsolve: y_r = c_j / a_j."""
    n = 0
    cnt_eq0, cnt_iq0, cnt_eqN, cnt_iqN = _col_occurrence_counts(pd)
    for vb in [FIRST] + list(range(pd.N)):
        c, ixl, xl, ixu, xu, active = pd.var_arrays(vb)
        if vb == FIRST:
            cand = active & (cnt_eq0 == 1) & (cnt_iq0 == 0)
        else:
            cand = active & (cnt_eqN[vb] == 1) & (cnt_iqN[vb] == 0)
        for j in np.nonzero(cand)[0]:
            j = int(j)
            eq = pd.eq_column(vb, j)
            if len(eq) != 1:      # re-validate (earlier subs this sweep)
                continue
            if (ixl[j] > 0 or ixu[j] > 0) and not _implied_free(
                    pd, vb, j, eq[0]):
                continue
            rb, r, a = eq[0]
            # the defining row's full coefficient list
            row_coeffs = _eq_row_coeffs(pd, rb, r)
            b_r = _eq_rhs(pd, rb, r)
            cj = float(c[j])
            # fold objective: c_j x_j = c_j/a (b_r - sum_{k != j} a_k x_k)
            pd.objective_offset += cj * b_r / a
            for (kb, k, ak) in row_coeffs:
                if kb == vb and k == j:
                    continue
                ck, *_rest = pd.var_arrays(kb)
                ck[k] -= cj * ak / a
            pd.emit("SINGLETON_COLUMN", vb=vb, j=j, a=a, c=cj,
                    row_blk=rb, row_idx=r, row_coeffs=row_coeffs, b=b_r)
            pd.remove_eq_row(rb, r, "singleton_column")
            # deactivate the variable (inert box, zero everywhere)
            pd._zero_column(vb, j)
            c[j] = 0.0
            ixl[j] = 1.0
            xl[j] = -1.0
            ixu[j] = 1.0
            xu[j] = 1.0
            active[j] = False
            n += 1

    # ---- inequality-row singletons (reference
    # StochPresolverSingletonColumns.C:200-290 removeSingletonColumn
    # inequality branch; removeFreeColumnSingletonInequalityRow,
    # PresolveData.C:2042-2095) ----
    for vb in [FIRST] + list(range(pd.N)):
        c, ixl, xl, ixu, xu, active = pd.var_arrays(vb)
        if vb == FIRST:
            cand = active & (cnt_eq0 == 0) & (cnt_iq0 == 1)
        else:
            cand = active & (cnt_eqN[vb] == 0) & (cnt_iqN[vb] == 1)
        for j in np.nonzero(cand)[0]:
            j = int(j)
            if pd.eq_column(vb, j):     # re-validate after earlier subs
                continue
            iq = pd.ineq_column(vb, j)
            if len(iq) != 1:
                continue
            rb, r, a = iq[0]
            il, lo, iu, up = _ineq_bounds(pd, rb, r)
            if (il > 0) == (iu > 0):
                # two-sided (incl. clow == cupp) or vacuous row: the
                # reference routes clow == cupp through the equality
                # machinery; we leave both to other passes
                continue
            # convert to <=-form: clow <= Cx  ==  -Cx <= -clow
            coeff_le = a if iu > 0 else -a
            cj = float(c[j])
            if coeff_le > 0 and cj >= 0:
                # decreasing x_j loosens the row AND improves the
                # objective: optimal at the lower bound (or free)
                if ixl[j] > 0:
                    pd.fix_variable(vb, j, float(xl[j]), "ineq_singleton")
                    n += 1
                elif cj == 0.0:
                    _remove_free_ineq_singleton(pd, vb, j, rb, r, a,
                                                bool(iu > 0))
                    n += 1
                # cj > 0 with no lower bound: LP is unbounded
                # (reference aborts); leave for the IPM to diagnose
            elif coeff_le < 0 and cj <= 0:
                if ixu[j] > 0:
                    pd.fix_variable(vb, j, float(xu[j]), "ineq_singleton")
                    n += 1
                elif cj == 0.0:
                    _remove_free_ineq_singleton(pd, vb, j, rb, r, a,
                                                bool(iu > 0))
                    n += 1
    return n


def _ineq_bounds(pd: PresolveData, blk, r):
    if blk == FIRST:
        return (float(pd.iclow0[r]), float(pd.clow0[r]),
                float(pd.icupp0[r]), float(pd.cupp0[r]))
    if blk == LINK:
        return (float(pd.iclowl[r]), float(pd.clowl[r]),
                float(pd.icuppl[r]), float(pd.cuppl[r]))
    return (float(pd.iclowN[blk, r]), float(pd.clowN[blk, r]),
            float(pd.icuppN[blk, r]), float(pd.cuppN[blk, r]))


def _ineq_row_coeffs(pd, blk, r):
    if blk == FIRST:
        return [(FIRST, int(j), float(pd.C0[r, j]))
                for j in np.nonzero(pd.C0[r])[0]]
    if blk == LINK:
        out = [(FIRST, int(j), float(pd.G0[r, j]))
               for j in np.nonzero(pd.G0[r])[0]]
        for i in range(pd.N):
            out += [(i, int(j), float(pd.G[i][r, j]))
                    for j in np.nonzero(pd.G[i][r])[0]]
        return out
    out = [(FIRST, int(j), float(pd.C[blk][r, j]))
           for j in np.nonzero(pd.C[blk][r])[0]]
    out += [(blk, int(j), float(pd.D[blk][r, j]))
            for j in np.nonzero(pd.D[blk][r])[0]]
    return out


def _remove_free_ineq_singleton(pd: PresolveData, vb, j, rb, r, a,
                                has_upp: bool):
    """Free (unbounded on the loosening side) singleton column in a
    one-sided inequality row: x_j can always absorb the row, and with a
    zero objective coefficient both the row and the column vanish
    (reference removeFreeColumnSingletonInequalityRow, PresolveData.C:
    2042-2095).  Postsolve sets x_j to make the row active (clamped into
    the variable's surviving one-sided box); the row dual is 0."""
    row_coeffs = _ineq_row_coeffs(pd, rb, r)
    il, lo, iu, up = _ineq_bounds(pd, rb, r)
    c, ixl, xl, ixu, xu, active = pd.var_arrays(vb)
    pd.emit("FREE_SINGLETON_COLUMN_INEQ", vb=vb, j=j, a=a,
            row_blk=rb, row_idx=r, row_coeffs=row_coeffs,
            rhs=(up if has_upp else lo),
            ixl=float(ixl[j]), xl=float(xl[j]),
            ixu=float(ixu[j]), xu=float(xu[j]))
    pd.remove_ineq_row(rb, r, "free_singleton_column")
    pd._zero_column(vb, j)
    c[j] = 0.0
    ixl[j] = 1.0
    xl[j] = -1.0
    ixu[j] = 1.0
    xu[j] = 1.0
    active[j] = False


def _implied_free(pd: PresolveData, vb, j, eq_entry) -> bool:
    """True when the bounds of x[vb,j] are implied by its single defining
    equality row plus the other variables' bounds: the implied value range
    (b - act_others)/a lies inside [xlow, xupp], so the explicit bounds
    can never bind and the variable may be treated as free (reference
    bounded-singleton-column case, StochPresolverSingletonColumns.C)."""
    rb, r, a = eq_entry
    b = _eq_rhs(pd, rb, r)
    lo_o, up_o = 0.0, 0.0
    for (kb, k, ak) in _eq_row_coeffs(pd, rb, r):
        if kb == vb and k == j:
            continue
        lo_k, up_k = _var_bounds(pd, kb, k)
        lo_o += ak * lo_k if ak > 0 else ak * up_k
        up_o += ak * up_k if ak > 0 else ak * lo_k
        if np.isneginf(lo_o) and np.isposinf(up_o):
            return False
    if a > 0:
        imp_lo, imp_up = (b - up_o) / a, (b - lo_o) / a
    else:
        imp_lo, imp_up = (b - lo_o) / a, (b - up_o) / a
    cur_lo, cur_up = _var_bounds(pd, vb, j)
    # tolerance from FINITE implied values only: an infinite implied
    # bound must FAIL the containment test (tol=inf made everything
    # "implied free" and dropped binding bounds)
    finite = [abs(v) for v in (imp_lo, imp_up) if np.isfinite(v)]
    tol = FEASTOL * max([1.0] + finite)
    return imp_lo >= cur_lo - tol and imp_up <= cur_up + tol


def _eq_row_coeffs(pd, blk, r):
    if blk == FIRST:
        return [(FIRST, int(j), float(pd.A0[r, j]))
                for j in np.nonzero(pd.A0[r])[0]]
    if blk == LINK:
        out = [(FIRST, int(j), float(pd.F0[r, j]))
               for j in np.nonzero(pd.F0[r])[0]]
        for i in range(pd.N):
            out += [(i, int(j), float(pd.F[i][r, j]))
                    for j in np.nonzero(pd.F[i][r])[0]]
        return out
    out = [(FIRST, int(j), float(pd.A[blk][r, j]))
           for j in np.nonzero(pd.A[blk][r])[0]]
    out += [(blk, int(j), float(pd.B[blk][r, j]))
            for j in np.nonzero(pd.B[blk][r])[0]]
    return out


def _eq_rhs(pd, blk, r):
    if blk == FIRST:
        return float(pd.b0[r])
    if blk == LINK:
        return float(pd.bl[r])
    return float(pd.bN[blk, r])
