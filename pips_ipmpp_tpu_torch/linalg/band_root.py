r"""Banded root: 2-link / k-link structure exploitation in the dual Schur
complement.

Counterpart of `pips_ipmpp_tpu/linalg/band_root.py` (see its docstring
for the derivation).  Energy-system LPs couple scenarios or time steps
through linking rows whose block support is LOCAL (the reference's 2-link
rows, DistributedProblem.hpp:66-77): ordering those rows by their block
window makes the dual Schur complement banded.  `ArrowBackend(
band_root_plan=...)` then reverses the root elimination:

  1. factor the permuted dual-dual block SDD = -S22 with the batched
     block-tridiagonal Cholesky (`band_backend.block_tridiag_factor`);
  2. form the n0 x n0 primal Schur complement S11x = S11 + S12 SDD^{-1}
     S12' with banded multi-RHS solves and factor it dense;
  3. every root solve is two banded sweeps and one small dense solve.

The plan is host work (numpy, scipy), computed once per LP before the
solve, and equals the JAX package's element for element.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BandRootPlan:
    """Host-side symbolic analysis of the dual-SC sparsity (static)."""
    perm: np.ndarray        # [nD] dual-space permutation (gather order)
    iperm: np.ndarray       # [nD] inverse permutation
    half_bandwidth: int     # of the permuted SDD pattern (band part)
    panel: int              # block-tridiagonal panel size
    n_panels: int
    n_dense: int = 0        # trailing peeled wide/global rows


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def plan_banded_root(lp, panel: int | None = None, min_panel: int = 8,
                     max_dense_frac: float = 0.15) -> BandRootPlan:
    """Order linking rows by their block-support window.

    Rows are placed [y0 | z0 | linking rows by window center | unsupported
    rows | PEELED wide rows]; the half-bandwidth is the max position span
    of band rows sharing a block (rows sharing a block form a clique in
    the SC pattern).  Rows touching many more blocks than typical (global
    constraints) are peeled into a trailing dense block (at most
    `max_dense_frac` of the linking rows), handled by a small Schur
    complement at factorization time.  An RCM ordering of the SC
    adjacency B'B (B = the rows' block support) replaces the window order
    where it gives a smaller half-bandwidth (graph-coupled, non-chain
    link structure)."""
    F = _host(lp.F)    # [N, mEl, n]
    G = _host(lp.G)    # [N, mIl, n]
    N, mEl, _ = F.shape
    mIl = G.shape[1]
    m0E, m0I = int(lp.m0E), int(lp.m0I)
    nP = m0E + m0I
    nL = mEl + mIl

    # support[i] = linking-row ids (0..nL) touching block i
    supp_eq = (np.abs(F) > 0).any(axis=2)     # [N, mEl]
    supp_iq = (np.abs(G) > 0).any(axis=2)     # [N, mIl]
    supp = np.concatenate([supp_eq, supp_iq], axis=1)  # [N, nL]

    touched = supp.any(axis=0)                # [nL]
    lo_blk = np.full(nL, np.inf)
    hi_blk = np.full(nL, -np.inf)
    for i in range(N):
        rows = np.nonzero(supp[i])[0]
        lo_blk[rows] = np.minimum(lo_blk[rows], i)
        hi_blk[rows] = np.maximum(hi_blk[rows], i)

    # "wide" is by touched-block COUNT (what creates cliques in the SC
    # pattern), not window span: a 2-block row whose blocks are far apart
    # in the numbering is absorbed into the band by the RCM order below
    n_touched = supp.sum(axis=0).astype(float)   # [nL]
    max_dense = int(max_dense_frac * nL)
    med_w = max(float(np.median(n_touched[touched])), 1.0) if touched.any() \
        else 1.0
    wide = touched & (n_touched > max(4 * med_w, 4.0)) if max_dense else \
        np.zeros(nL, bool)
    if wide.sum() > max_dense:
        keep_wide = np.argsort(n_touched)[::-1][:max_dense]
        wide = np.zeros(nL, bool)
        wide[keep_wide] = True

    # order: band rows by window center, then untouched (diagonal) rows,
    # then the peeled wide rows as the trailing dense block
    center = (lo_blk + hi_blk) / 2.0
    group = np.where(wide, 2, np.where(touched, 0, 1))
    key = group * (2.0 * N) + np.where(group == 0, center, 0.0)
    order = np.argsort(key, kind="stable")
    k = int(wide.sum())

    def bandwidth_of(ordering):
        pos = np.empty(nL, np.int64)
        pos[ordering] = np.arange(nL)
        hh = 1
        for i in range(N):
            rows = np.nonzero(supp[i] & ~wide)[0]
            if rows.size > 1:
                p = pos[rows]
                hh = max(hh, int(p.max() - p.min()))
        return hh

    h = bandwidth_of(order)

    band_rows = np.nonzero(touched & ~wide)[0]
    if band_rows.size > 2:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        B = sp.csr_matrix(supp[:, band_rows])
        adj = (B.T @ B).tocsr()
        rcm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True),
                         dtype=np.int64)
        order_rcm = np.concatenate([
            band_rows[rcm],
            np.nonzero(~touched & ~wide)[0],
            np.nonzero(wide)[0]])
        h_rcm = bandwidth_of(order_rcm)
        if h_rcm < h:
            order, h = order_rcm, h_rcm
    nD = nP + nL
    n_band = nD - k
    if panel is None:
        panel = max(min_panel, -(-h // min_panel) * min_panel)
        panel = min(panel, max(n_band, min_panel))
    elif panel < h:
        raise ValueError(f"panel {panel} < half-bandwidth {h}")

    perm = np.concatenate([np.arange(nP), nP + order]).astype(np.int32)
    iperm = np.argsort(perm).astype(np.int32)
    n_panels = max(-(-n_band // panel), 1)
    return BandRootPlan(perm=perm, iperm=iperm, half_bandwidth=h,
                        panel=panel, n_panels=n_panels, n_dense=k)
