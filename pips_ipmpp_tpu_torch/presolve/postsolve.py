"""Postsolve: reverse replay of presolve events to reconstruct the
original-space primal/dual solution.  Counterpart of
`pips_ipmpp_tpu/presolve/postsolve.py`, host numpy in both packages
(reference StochPostsolver.C:
`postsolve()` replays `ReductionType` notifications in reverse,
StochPostsolver.h:95-107).

Because presolve deactivates rather than compacts (see presolve.data), all
indices are original indices: the presolved solution arrays are already
index-aligned with the original problem; replay only needs to (1) write
fixed variables back, (2) reconstruct duals of removed rows, (3) transfer
multipliers from presolve-introduced variable bounds back to their
originating rows, and (4) recompute bound duals from reduced costs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP
from pips_ipmpp_tpu_torch.presolve.data import FIRST, LINK


def _host_lp(lp: ArrowheadLP):
    """Numpy f64 copies of every field of `lp`, from one host copy."""
    import dataclasses as dc
    host = lp.to("cpu").astype(torch.float64)
    lpn = type("LPnp", (), {})()
    for f in dc.fields(host):
        setattr(lpn, f.name, getattr(host, f.name).numpy().copy())
    lpn.N = lp.N
    return lpn

POSTSOLVE_TOLERANCE = 1e-6
# the dual transfer passes' tolerance on their dual-violation score
DUAL_TOL = 1e-7


@dataclass
class Solution:
    """Original-space solution in numpy (x0/xN etc. index-identical)."""
    x0: np.ndarray
    xN: np.ndarray
    y0: np.ndarray
    yN: np.ndarray
    yl: np.ndarray
    z0: np.ndarray
    zN: np.ndarray
    zl: np.ndarray
    gamma0: np.ndarray = None
    gammaN: np.ndarray = None
    phi0: np.ndarray = None
    phiN: np.ndarray = None

    def x(self, blk):
        return self.x0 if blk == FIRST else self.xN[blk]

    def ydual(self, blk):
        if blk == FIRST:
            return self.y0
        if blk == LINK:
            return self.yl
        return self.yN[blk]

    def zdual(self, blk):
        if blk == FIRST:
            return self.z0
        if blk == LINK:
            return self.zl
        return self.zN[blk]


# ---- numpy matvecs over the original arrowhead arrays ----

def np_ATy_col(lp, sol: Solution, blk, j):
    """(A'y + C'z) entry for variable (blk, j) against ORIGINAL matrices."""
    if blk == FIRST:
        val = (lp.A0[:, j] @ sol.y0 + lp.C0[:, j] @ sol.z0
               + lp.F0[:, j] @ sol.yl + lp.G0[:, j] @ sol.zl)
        val += sum(lp.A[i][:, j] @ sol.yN[i] + lp.C[i][:, j] @ sol.zN[i]
                   for i in range(lp.N))
        return val
    return (lp.B[blk][:, j] @ sol.yN[blk] + lp.D[blk][:, j] @ sol.zN[blk]
            + lp.F[blk][:, j] @ sol.yl + lp.G[blk][:, j] @ sol.zl)


def np_c(lp, blk, j):
    return lp.c0[j] if blk == FIRST else lp.cN[blk, j]


def np_row_activity_ineq(lp, sol: Solution, blk, r):
    if blk == FIRST:
        return lp.C0[r] @ sol.x0
    if blk == LINK:
        return lp.G0[r] @ sol.x0 + sum(
            lp.G[i][r] @ sol.xN[i] for i in range(lp.N))
    return lp.C[blk][r] @ sol.x0 + lp.D[blk][r] @ sol.xN[blk]


class _DualPassMemo:
    """What the dual transfer passes recompute after every tentative dual
    change, kept per scope (FIRST, LINK, block i) and recomputed only for
    the scopes a change touched.  `pips_ipmpp_tpu/presolve/postsolve.py`
    recomputes A'y over every block and the whole score for each
    candidate row, hours of host time at 96 blocks of 1062 columns.  Here
    each value is recomputed by the same operations in the same order
    (the first-stage columns' A'y and the score's running sum from the
    first changed part on), so the passes' decisions and results are the
    same bit for bit.  x does not change during the passes."""

    def __init__(self, N):
        self.N = N
        n_terms = 2 * N + 3
        self.aty = {}                       # scope -> A'y + C'z vector
        self.stale = {FIRST, LINK, *range(N)}
        self.border = [None] * N            # (A[i]'yN[i], C[i]'zN[i])
        self.border_stale = set(range(N))
        self.partial = [None] * (N + 1)     # first-stage A'y, running
        self.first_from = -1                # -1: base stale, N: none
        self.terms = [0.0] * n_terms        # the score's terms, in order
        self.terms_stale = set(range(n_terms))
        self.totals = [0.0] * (n_terms + 1)  # running sums of the terms
        self.act = {}                       # scope -> row activity

    # score term index: red FIRST 0, red block i 1 + i, z FIRST N + 1,
    # z LINK N + 2, z block i N + 3 + i
    def touch(self, rb):
        N = self.N
        if rb == LINK:
            self.stale.update((FIRST, LINK, *range(N)))
            self.first_from = -1
            self.terms_stale.update(range(N + 1))
            self.terms_stale.add(N + 2)
        elif rb == FIRST:
            self.stale.add(FIRST)
            self.first_from = -1
            self.terms_stale.update((0, N + 1))
        else:
            self.stale.update((FIRST, rb))
            self.border_stale.add(rb)
            self.first_from = min(self.first_from, rb) \
                if self.first_from >= 0 else -1
            self.terms_stale.update((0, 1 + rb, N + 3 + rb))


class Postsolver:
    """Replays the event log in reverse over the original problem."""

    def __init__(self, original_lp: ArrowheadLP):
        # numpy copies of the ORIGINAL (pre-presolve) problem
        self.lp = _host_lp(original_lp)

    def postsolve(self, events, sol: Solution) -> Solution:
        """Two-phase reverse replay: all PRIMAL restorations first (so
        row activities are exact), then the DUAL reconstructions, which
        test activities/tightness against the fully-restored primal
        (the reference replays once because its notifications carry the
        saved activities; here the primal pass makes them recomputable)."""
        for ev in reversed(events):
            self._replay_primal(ev, sol)
        for ev in reversed(events):
            self._replay_dual(ev, sol)

        # final: bound duals from reduced costs (recomputed inside), then
        # move any dual mass resting on presolve-tightened (non-original)
        # bounds onto the original rows that implied them: first the
        # DIRECTED pass using the implying rows recorded at tightening
        # time (exact per-reduction replay, reference StochPostsolver.C),
        # then the score-validated search for anything without provenance;
        # every helper of these passes reads and updates the one memo
        self._memo = _DualPassMemo(self.lp.N)
        self._directed_bound_dual_transfers(sol, events)
        self._transfer_interior_bound_duals(sol)
        self.dual_violation = self._dual_violation_score(sol, DUAL_TOL)
        return sol

    def postsolve_primal(self, events, sol: Solution) -> Solution:
        """The primal replay of `postsolve` alone: the same x (the dual
        reconstructions and transfers do not change it), without the
        dual passes' cost; y and z stay as given."""
        for ev in reversed(events):
            self._replay_primal(ev, sol)
        return sol

    def _orig_coef(self, kind, rb, r, blk, j) -> float:
        """Coefficient of variable (blk, j) in ORIGINAL row (kind, rb, r)."""
        lp = self.lp
        if kind == "eq":
            if rb == FIRST:
                return float(lp.A0[r, j]) if blk == FIRST else 0.0
            if rb == LINK:
                return float(lp.F0[r, j] if blk == FIRST
                             else lp.F[blk][r, j])
            if blk == FIRST:
                return float(lp.A[rb][r, j])
            return float(lp.B[rb][r, j]) if blk == rb else 0.0
        if rb == FIRST:
            return float(lp.C0[r, j]) if blk == FIRST else 0.0
        if rb == LINK:
            return float(lp.G0[r, j] if blk == FIRST else lp.G[blk][r, j])
        if blk == FIRST:
            return float(lp.C[rb][r, j])
        return float(lp.D[rb][r, j]) if blk == rb else 0.0

    def _directed_bound_dual_transfers(self, sol: Solution, events,
                                       tol: float = DUAL_TOL):
        """Exact reverse replay of TIGHTENED_BOUNDS duals: any reduced
        cost the presolved solve parked on a tightened (non-original)
        bound is moved onto the ROW RECORDED AS IMPLYING that bound at
        tightening time (dz = red / a_rj with the ORIGINAL coefficient).
        Replay runs in reverse event order so chains unwind naturally.
        Each transfer is still applied tentatively and kept only if the
        global dual-violation score strictly decreases — a stale
        provenance (row since modified by another reduction) can never
        corrupt the solution; it just falls through to the search pass."""
        score = self._dual_violation_score(sol, tol)
        if score <= tol:
            self._recompute_bound_duals(sol)
            return
        lp = self.lp
        for ev in reversed(events):
            if ev.kind != "TIGHTENED_BOUNDS":
                continue
            d = ev.data
            blk, j = d["blk"], d["j"]
            for src in (d.get("implied_lo"), d.get("implied_upp")):
                if src is None:
                    continue
                red = np_c(lp, blk, j) - np_ATy_col(lp, sol, blk, j)
                if abs(red) <= tol:
                    break
                kind, rb, r = src
                a = self._orig_coef(kind, rb, r, blk, j)
                if abs(a) < 1e-12:
                    continue
                dz = red / a
                duals = sol.ydual(rb) if kind == "eq" else sol.zdual(rb)
                duals[r] += dz
                self._memo.touch(rb)
                s = self._dual_violation_score(sol, tol)
                if s < score - 1e-12:
                    score = s
                else:
                    duals[r] -= dz
                    self._memo.touch(rb)
            if score <= tol:
                break
        self._recompute_bound_duals(sol)

    def _replay_primal(self, ev, sol: Solution):
        k, d = ev.kind, ev.data
        if k == "FIXED_COLUMN":
            sol.x(d["blk"])[d["j"]] = d["val"]
        elif k == "NEARLY_PARALLEL_SUB":
            if d["t"] != 0.0:
                x1 = sol.x(d["vb1"])[d["j1"]]
                sol.x(d["vb2"])[d["j2"]] = d["t"] * x1 + d["d"]
        elif k == "SINGLETON_COLUMN":
            vb, j, a = d["vb"], d["j"], d["a"]
            acc = 0.0
            for (kb, kk, ak) in d["row_coeffs"]:
                if kb == vb and kk == j:
                    continue
                acc += ak * sol.x(kb)[kk]
            sol.x(vb)[j] = (d["b"] - acc) / a
        elif k == "FREE_SINGLETON_COLUMN_INEQ":
            # x_j makes its one-sided row active; clamping into the
            # variable's surviving one-sided box only loosens the row
            # (reference notifyFreeColumnSingletonInequalityRow replay)
            vb, j, a = d["vb"], d["j"], d["a"]
            acc = 0.0
            for (kb, kk, ak) in d["row_coeffs"]:
                if kb == vb and kk == j:
                    continue
                acc += ak * sol.x(kb)[kk]
            xj = (d["rhs"] - acc) / a
            if d["ixl"] > 0:
                xj = max(xj, d["xl"])
            if d["ixu"] > 0:
                xj = min(xj, d["xu"])
            sol.x(vb)[j] = xj

    def _replay_dual(self, ev, sol: Solution):
        lp = self.lp
        k = ev.kind
        d = ev.data
        if k == "FIXED_COLUMN":
            blk, j, val = d["blk"], d["j"], d["val"]
            if d.get("reason") == "singleton_eq_row":
                rb, r, a = d["row_blk"], d["row_idx"], d["row_coef"]
                # y_r from the fixed variable's stationarity in the
                # problem state at removal time (stored active column)
                acc = 0.0
                for (cb, cr, ca) in d["eq_col"]:
                    if not (cb == rb and cr == r):
                        acc += ca * sol.ydual(cb)[cr]
                for (cb, cr, ca) in d["iq_col"]:
                    acc += ca * sol.zdual(cb)[cr]
                sol.ydual(rb)[r] = (d["c"] - acc) / a
        elif k == "NEARLY_PARALLEL_SUB":
            # rows: row_s: rest.x + a2 x2 = b_s; row_o = kf*row_s on
            # the shared support plus its own singleton a1 x1.
            # Presolve substituted x2 = t x1 + d and dropped row_s
            # (StochPresolverParallelRows.C:788-876).  Reverse:
            #   x2 = t x1 + d   (t = 0: x2 restored by FIXED_COLUMN)
            #   y_s = c2/a2 (x2 appears only in row_s originally)
            #   y_o -= y_s/kf  (shared-support stationarity)
            a2 = d["a2"]
            y_s = d["c2"] / a2
            rs, ro = d["row_s"], d["row_o"]
            sol.ydual(rs[0])[rs[1]] = y_s
            sol.ydual(ro[0])[ro[1]] -= y_s / d["k"]
        elif k == "SINGLETON_COLUMN":
            sol.ydual(d["row_blk"])[d["row_idx"]] = d["c"] / d["a"]
        elif k == "FREE_SINGLETON_COLUMN_INEQ":
            # stationarity of the removed free x_j: 0 = c_j - a z_r with
            # c_j = 0, so the removed row's multiplier is exactly 0
            sol.zdual(d["row_blk"])[d["row_idx"]] = 0.0
        elif k == "REMOVED_INEQ_ROW" and d["reason"] == "singleton_row":
            blk, r = d["blk"], d["r"]
            vb, j, a = d["var_blk"], d["j"], d["coef"]
            old_lo, old_up = d["old_var_bounds"]
            xj = sol.x(vb)[j]
            red = np_c(lp, vb, j) - np_ATy_col(lp, sol, vb, j)
            at_orig_lo = np.isfinite(old_lo) and xj <= old_lo + 1e-7
            at_orig_up = np.isfinite(old_up) and xj >= old_up - 1e-7
            if abs(red) > 1e-9 and not (at_orig_lo or at_orig_up):
                # multiplier belongs to the removed row
                sol.zdual(blk)[r] = red / a
        elif k == "REMOVED_INEQ_ROW" and d["reason"] == "parallel_row":
            blk, r = d["blk"], d["r"]
            kb, kr, fac = d["kept_blk"], d["kept_r"], d["factor"]
            zk = sol.zdual(kb)[kr]
            if abs(zk) < 1e-12:
                return
            # the multiplier belongs to whichever row's ORIGINAL bound
            # is tight at the signed side: compare slacks (the merged
            # bound the IPM saw may have come from either row)
            act_k = np_row_activity_ineq(lp, sol, kb, kr)
            krow = self._orig_ineq_bounds(kb, kr)
            crow = self._orig_ineq_bounds(blk, r)
            act_c = fac * act_k

            def side_slack(act, il, lo, iu, up, sign):
                if sign > 0:
                    return abs(act - lo) if il > 0 else np.inf
                return abs(up - act) if iu > 0 else np.inf

            # candidate multiplier zk/fac has sign(zk)*sign(fac)
            s_kept = side_slack(act_k, *krow, np.sign(zk))
            s_cand = side_slack(act_c, *crow,
                                np.sign(zk) * np.sign(fac))
            if s_cand < s_kept:
                # move it to the candidate row (scaled)
                sol.zdual(blk)[r] = zk / fac
                sol.zdual(kb)[kr] = 0.0
        # REMOVED_EQ_ROW / TIGHTENED_BOUNDS / other REMOVED_INEQ_ROW:
        # duals stay zero; bounds restored implicitly (original lp)

    def _orig_ineq_bounds(self, blk, r):
        lp = self.lp
        if blk == FIRST:
            return (lp.iclow0[r], lp.clow0[r], lp.icupp0[r], lp.cupp0[r])
        if blk == LINK:
            return (lp.iclowl[r], lp.clowl[r], lp.icuppl[r], lp.cuppl[r])
        return (lp.iclowN[blk, r], lp.clowN[blk, r],
                lp.icuppN[blk, r], lp.cuppN[blk, r])

    def _recompute_bound_duals(self, sol: Solution):
        lp = self.lp
        red0 = lp.c0 - self._ATy_full(sol, FIRST)
        sol.gamma0 = np.where(lp.ixlow0 > 0, np.maximum(red0, 0.0), 0.0)
        sol.phi0 = np.where(lp.ixupp0 > 0, np.maximum(-red0, 0.0), 0.0)
        gN, pN = [], []
        for i in range(lp.N):
            redi = lp.cN[i] - self._ATy_full(sol, i)
            gN.append(np.where(lp.ixlowN[i] > 0, np.maximum(redi, 0.0), 0.0))
            pN.append(np.where(lp.ixuppN[i] > 0, np.maximum(-redi, 0.0), 0.0))
        sol.gammaN = np.stack(gN) if gN else np.zeros_like(lp.cN)
        sol.phiN = np.stack(pN) if pN else np.zeros_like(lp.cN)

    def _transfer_interior_bound_duals(self, sol: Solution, rounds: int = 4,
                                       tol: float = DUAL_TOL,
                                       bound_tol: float = 1e-5):
        """Exact dual transfer for presolve-tightened bounds.

        A strengthened bound x_j >= t (or <= t) is implied by an original
        row r: when x_j sits exactly at t, row r is necessarily tight at
        the implying side and every other variable of r is at the bound
        used in the implication.  A bound multiplier the presolved solve
        left on the tightened bound therefore transfers exactly onto z_r
        (y_r for an equality): z_r += red_j / a_rj; the reduced-cost
        changes this induces on the other row-r variables land on
        variables that are at their bounds, so the final recompute stays
        complementary.  (The role of the reference's per-reduction dual
        replay for BOUNDS_TIGHTENED, StochPostsolver.C.)

        Detection is solution-driven: a nonzero bound dual on a variable
        strictly inside its ORIGINAL bounds marks a tightened-bound
        multiplier; we search j's original rows for one tight at the
        matching side and transfer.  Repeats a few rounds because a
        transfer can expose another variable's interior dual."""
        lp = self.lp
        score = self._dual_violation_score(sol, tol)
        plateau_budget = rounds  # bounds chains of score-neutral moves
        for _ in range(2 * rounds):
            if score <= tol:
                break
            moved = 0
            for blk, j in self._violating_vars(sol, tol):
                red = np_c(lp, blk, j) - np_ATy_col(lp, sol, blk, j)
                if abs(red) <= tol:
                    continue
                new = self._transfer_to_row(sol, blk, j, red, score, tol)
                if new is not None:
                    score = new
                    moved += 1
            if not moved:
                # a chain may pass through a score-neutral intermediate
                # state (e.g. nearly-parallel substitutions move the
                # violation from the substituted variable to a shared
                # one before it can land on the right row): allow one
                # plateau move, bounded by plateau_budget
                if plateau_budget <= 0:
                    break
                plateau_budget -= 1
                stepped = False
                for blk, j in self._violating_vars(sol, tol):
                    red = np_c(lp, blk, j) - np_ATy_col(lp, sol, blk, j)
                    if abs(red) <= tol:
                        continue
                    new = self._transfer_to_row(sol, blk, j, red,
                                                score + tol, tol)
                    if new is not None:
                        score = new
                        stepped = True
                        break
                if not stepped:
                    break
        self._recompute_bound_duals(sol)

    def _violating_vars(self, sol: Solution, tol, bound_tol=1e-5):
        """Variables whose recomputed bound dual rests on a bound the
        ORIGINAL problem does not have tight (or does not have at all)."""
        lp = self.lp
        self._recompute_bound_duals(sol)
        out = []
        for blk in [FIRST] + list(range(lp.N)):
            if blk == FIRST:
                x, g, p = sol.x0, sol.gamma0, sol.phi0
                ixl, xl = lp.ixlow0, lp.xlow0
                ixu, xu = lp.ixupp0, lp.xupp0
                red = lp.c0 - self._ATy_full(sol, FIRST)
            else:
                x, g, p = sol.xN[blk], sol.gammaN[blk], sol.phiN[blk]
                ixl, xl = lp.ixlowN[blk], lp.xlowN[blk]
                ixu, xu = lp.ixuppN[blk], lp.xuppN[blk]
                red = lp.cN[blk] - self._ATy_full(sol, blk)
            # at-bound detection uses a LOOSER tolerance than the dual
            # thresholds: the IPM parks actives at their bounds only to
            # ~mu accuracy, and misreading "at bound" as "interior"
            # wrongly transfers dual mass onto rows
            at_lo = (ixl > 0) & (x <= xl + bound_tol)
            at_up = (ixu > 0) & (x >= xu - bound_tol)
            # originally-free variables have gamma = phi = 0 forced, so
            # their leaked reduced cost must be tested directly
            free_leak = (ixl == 0) & (ixu == 0)
            bad = np.nonzero(((g > tol) & ~at_lo) | ((p > tol) & ~at_up)
                             | (free_leak & (np.abs(red) > tol)))[0]
            out.extend((blk, int(j)) for j in bad)
        return out

    def _dual_violation_score(self, sol: Solution, tol: float,
                              bound_tol: float = 1e-5) -> float:
        """Total dual inexactness: reduced cost that cannot be absorbed
        complementarily by an original-tight bound, plus ineq multipliers
        whose signed side is slack in the original problem."""
        lp = self.lp
        memo = self._memo

        def red_term(blk):
            if blk == FIRST:
                x = sol.x0
                ixl, xl, ixu, xu = lp.ixlow0, lp.xlow0, lp.ixupp0, lp.xupp0
                red = lp.c0 - self._ATy_full(sol, FIRST)
            else:
                x = sol.xN[blk]
                ixl, xl = lp.ixlowN[blk], lp.xlowN[blk]
                ixu, xu = lp.ixuppN[blk], lp.xuppN[blk]
                red = lp.cN[blk] - self._ATy_full(sol, blk)
            at_lo = (ixl > 0) & (x <= xl + bound_tol)
            at_up = (ixu > 0) & (x >= xu - bound_tol)
            # red > 0 needs a tight lower bound, red < 0 a tight upper
            return float(np.sum(np.where(
                red > 0, np.where(at_lo, 0.0, red),
                np.where(at_up, 0.0, -red))))

        # ineq multipliers: vectorized per scope (the score runs once per
        # tentative transfer, so the row sweep must not be a Python loop)
        def zscore(z, act, il, lo, iu, up):
            az = np.abs(z)
            live = az > tol
            if not live.any():
                return 0.0
            s = np.where(z > 0,
                         np.where(il > 0, np.abs(act - lo), 1.0 + az),
                         np.where(iu > 0, np.abs(up - act), 1.0 + az))
            return float(np.sum(np.where(live, az * np.minimum(s, 1.0),
                                         0.0)))

        def act(scope):
            if scope in memo.act:
                return memo.act[scope]
            if scope == FIRST:
                v = lp.C0 @ sol.x0
            elif scope == LINK:
                v = lp.G0 @ sol.x0 + sum(lp.G[i] @ sol.xN[i]
                                         for i in range(lp.N))
            else:
                v = lp.C[scope] @ sol.x0 + lp.D[scope] @ sol.xN[scope]
            memo.act[scope] = v
            return v

        def z_term(scope):
            if scope == FIRST:
                return zscore(sol.z0, act(FIRST), lp.iclow0, lp.clow0,
                              lp.icupp0, lp.cupp0)
            if scope == LINK:
                return zscore(sol.zl, act(LINK), lp.iclowl, lp.clowl,
                              lp.icuppl, lp.cuppl)
            return zscore(sol.zN[scope], act(scope), lp.iclowN[scope],
                          lp.clowN[scope], lp.icuppN[scope],
                          lp.cuppN[scope])

        N = lp.N
        order = ([(red_term, FIRST)] + [(red_term, i) for i in range(N)]
                 + [(z_term, FIRST), (z_term, LINK)]
                 + [(z_term, i) for i in range(N)])
        if memo.terms_stale:
            start = min(memo.terms_stale)
            for k in sorted(memo.terms_stale):
                fn, scope = order[k]
                memo.terms[k] = fn(scope)
            memo.terms_stale.clear()
            for k in range(start, len(order)):
                memo.totals[k + 1] = memo.totals[k] + memo.terms[k]
        return memo.totals[-1]

    def _rows_of_var(self, blk, j):
        """Original rows containing variable (blk, j):
        yields (kind, row_blk, r, coef) with kind in {eq, ineq}."""
        lp = self.lp
        if blk == FIRST:
            for r in np.nonzero(lp.A0[:, j])[0]:
                yield "eq", FIRST, int(r), float(lp.A0[r, j])
            for r in np.nonzero(lp.C0[:, j])[0]:
                yield "ineq", FIRST, int(r), float(lp.C0[r, j])
            for r in np.nonzero(lp.F0[:, j])[0]:
                yield "eq", LINK, int(r), float(lp.F0[r, j])
            for r in np.nonzero(lp.G0[:, j])[0]:
                yield "ineq", LINK, int(r), float(lp.G0[r, j])
            for i in range(lp.N):
                for r in np.nonzero(lp.A[i][:, j])[0]:
                    yield "eq", i, int(r), float(lp.A[i][r, j])
                for r in np.nonzero(lp.C[i][:, j])[0]:
                    yield "ineq", i, int(r), float(lp.C[i][r, j])
        else:
            for r in np.nonzero(lp.B[blk][:, j])[0]:
                yield "eq", blk, int(r), float(lp.B[blk][r, j])
            for r in np.nonzero(lp.D[blk][:, j])[0]:
                yield "ineq", blk, int(r), float(lp.D[blk][r, j])
            for r in np.nonzero(lp.F[blk][:, j])[0]:
                yield "eq", LINK, int(r), float(lp.F[blk][r, j])
            for r in np.nonzero(lp.G[blk][:, j])[0]:
                yield "ineq", LINK, int(r), float(lp.G[blk][r, j])

    def _transfer_to_row(self, sol, blk, j, red, score, tol):
        """Try moving reduced cost `red` of variable (blk, j) onto each of
        its original rows (dz = red / a_rj on the row multiplier); keep the
        transfer that lowers the global dual-violation score the most.
        Validating-by-score makes a wrong transfer impossible: every
        candidate is applied tentatively and reverted unless the total
        violation strictly decreases.  Returns the new score, or None."""
        best = None      # (new_score, kind, rb, r, dz)
        for kind, rb, r, a in self._rows_of_var(blk, j):
            if abs(a) < 1e-12:
                continue
            dz = red / a
            duals = sol.ydual(rb) if kind == "eq" else sol.zdual(rb)
            duals[r] += dz
            self._memo.touch(rb)
            s = self._dual_violation_score(sol, tol)
            duals[r] -= dz
            self._memo.touch(rb)
            if s < score - 1e-12 and (best is None or s < best[0]):
                best = (s, kind, rb, r, dz)
        if best is None:
            return None
        s, kind, rb, r, dz = best
        duals = sol.ydual(rb) if kind == "eq" else sol.zdual(rb)
        duals[r] += dz
        self._memo.touch(rb)
        return s

    def _ATy_full(self, sol: Solution, blk):
        """(A'y + C'z) over the columns of scope `blk`; the memo's copy
        (callers do not write into it)."""
        lp, memo = self.lp, self._memo
        if blk not in memo.stale:
            return memo.aty[blk]
        if blk == FIRST:
            val = self._first_aty(sol)
        else:
            val = (lp.B[blk].T @ sol.yN[blk] + lp.D[blk].T @ sol.zN[blk]
                   + lp.F[blk].T @ sol.yl + lp.G[blk].T @ sol.zl)
        memo.aty[blk] = val
        memo.stale.discard(blk)
        return val

    def _first_aty(self, sol: Solution):
        """The first-stage columns' A'y + C'z: the first-stage rows' part,
        then block by block; from the first block whose duals changed on."""
        lp, memo = self.lp, self._memo
        if memo.first_from < 0:
            val = (lp.A0.T @ sol.y0 + lp.C0.T @ sol.z0
                   + lp.F0.T @ sol.yl + lp.G0.T @ sol.zl)
            start = 0
        else:
            start = memo.first_from
            val = memo.partial[start]
        for i in range(start, lp.N):
            memo.partial[i] = val
            if i in memo.border_stale:
                memo.border[i] = (lp.A[i].T @ sol.yN[i],
                                  lp.C[i].T @ sol.zN[i])
                memo.border_stale.discard(i)
            a, c = memo.border[i]
            val = val + a + c
        memo.partial[lp.N] = val
        memo.first_from = lp.N
        return val


def postsolve_residuals(lp: ArrowheadLP, sol: Solution) -> dict:
    """Stationarity/feasibility/complementarity of the reconstructed
    original-space solution (checked against POSTSOLVE_TOLERANCE, like the
    reference's postsolve validation)."""
    lpn = _host_lp(lp)

    out = {}
    # primal feasibility
    eq0 = lpn.A0 @ sol.x0 - lpn.b0
    eqN = [lpn.A[i] @ sol.x0 + lpn.B[i] @ sol.xN[i] - lpn.bN[i]
           for i in range(lpn.N)]
    eql = lpn.F0 @ sol.x0 + sum(
        lpn.F[i] @ sol.xN[i] for i in range(lpn.N)) - lpn.bl
    out["eq"] = max([_mx(eq0)] + [_mx(e) for e in eqN] + [_mx(eql)])

    def ineq_violation(act, il, lo, iu, up):
        v = np.zeros_like(act)
        v = np.maximum(v, np.where(il > 0, lo - act, 0.0))
        v = np.maximum(v, np.where(iu > 0, act - up, 0.0))
        return _mx(v)

    act0 = lpn.C0 @ sol.x0
    out["ineq"] = ineq_violation(act0, lpn.iclow0, lpn.clow0,
                                 lpn.icupp0, lpn.cupp0)
    for i in range(lpn.N):
        acti = lpn.C[i] @ sol.x0 + lpn.D[i] @ sol.xN[i]
        out["ineq"] = max(out["ineq"], ineq_violation(
            acti, lpn.iclowN[i], lpn.clowN[i], lpn.icuppN[i], lpn.cuppN[i]))
    actl = lpn.G0 @ sol.x0 + sum(
        lpn.G[i] @ sol.xN[i] for i in range(lpn.N))
    out["ineq"] = max(out["ineq"], ineq_violation(
        actl, lpn.iclowl, lpn.clowl, lpn.icuppl, lpn.cuppl))

    def bound_violation(x, il, lo, iu, up):
        v = np.maximum(np.maximum(np.where(il > 0, lo - x, 0.0),
                                  np.where(iu > 0, x - up, 0.0)), 0.0)
        return _mx(v)

    out["bounds"] = bound_violation(sol.x0, lpn.ixlow0, lpn.xlow0,
                                    lpn.ixupp0, lpn.xupp0)
    for i in range(lpn.N):
        out["bounds"] = max(out["bounds"], bound_violation(
            sol.xN[i], lpn.ixlowN[i], lpn.xlowN[i],
            lpn.ixuppN[i], lpn.xuppN[i]))

    # complementarity: bound duals vs slack to the ORIGINAL bounds, and
    # ineq multipliers vs slack at the signed side (z>0 <-> lower tight)
    # products are slack-normalized (s/(1+s)): a microscopic multiplier
    # against a huge-slack bound measures as the multiplier, not as
    # multiplier * slack (matches KKT-check practice)
    def comp_bounds(x, il, lo, iu, up, g, p):
        sl = np.abs(x - lo)
        su = np.abs(up - x)
        cl = np.where(il > 0, np.abs(g) * sl / (1.0 + sl), 0.0)
        cu = np.where(iu > 0, np.abs(p) * su / (1.0 + su), 0.0)
        return max(_mx(cl), _mx(cu))

    out["comp"] = comp_bounds(sol.x0, lpn.ixlow0, lpn.xlow0,
                              lpn.ixupp0, lpn.xupp0, sol.gamma0, sol.phi0)
    for i in range(lpn.N):
        out["comp"] = max(out["comp"], comp_bounds(
            sol.xN[i], lpn.ixlowN[i], lpn.xlowN[i], lpn.ixuppN[i],
            lpn.xuppN[i], sol.gammaN[i], sol.phiN[i]))

    def comp_ineq(act, il, lo, iu, up, z):
        lo_slack = np.where(il > 0, np.abs(act - lo), np.inf)
        up_slack = np.where(iu > 0, np.abs(up - act), np.inf)
        slack = np.where(z > 0, lo_slack, np.where(z < 0, up_slack, 0.0))
        return _mx(np.where(np.isfinite(slack),
                            np.abs(z) * slack / (1.0 + slack),
                            np.abs(z)))

    out["comp"] = max(out["comp"], comp_ineq(
        act0, lpn.iclow0, lpn.clow0, lpn.icupp0, lpn.cupp0, sol.z0))
    for i in range(lpn.N):
        acti = lpn.C[i] @ sol.x0 + lpn.D[i] @ sol.xN[i]
        out["comp"] = max(out["comp"], comp_ineq(
            acti, lpn.iclowN[i], lpn.clowN[i], lpn.icuppN[i],
            lpn.cuppN[i], sol.zN[i]))
    out["comp"] = max(out["comp"], comp_ineq(
        actl, lpn.iclowl, lpn.clowl, lpn.icuppl, lpn.cuppl, sol.zl))

    # dual stationarity: c - A'y - C'z - gamma + phi = 0
    r0 = (lpn.c0 - lpn.A0.T @ sol.y0 - lpn.C0.T @ sol.z0
          - lpn.F0.T @ sol.yl - lpn.G0.T @ sol.zl
          - sum(lpn.A[i].T @ sol.yN[i] + lpn.C[i].T @ sol.zN[i]
                for i in range(lpn.N))
          - sol.gamma0 + sol.phi0)
    out["stat"] = _mx(r0)
    for i in range(lpn.N):
        ri = (lpn.cN[i] - lpn.B[i].T @ sol.yN[i] - lpn.D[i].T @ sol.zN[i]
              - lpn.F[i].T @ sol.yl - lpn.G[i].T @ sol.zl
              - sol.gammaN[i] + sol.phiN[i])
        out["stat"] = max(out["stat"], _mx(ri))
    return out


def _mx(v):
    return float(np.max(np.abs(v))) if np.size(v) else 0.0
