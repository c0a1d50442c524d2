r"""Banded (block-tridiagonal) leaf factorization: the structure-exploiting
direct solver for blocks whose condensed normal equations are sparse.

Counterpart of `pips_ipmpp_tpu/linalg/band_backend.py` (see its docstring
for the derivation; the reference's sparse leaf is PARDISO,
PardisoSchurSolver.C:84-252).  The same split:

  symbolic (host, once): the pattern of Neq_i = M_i E^{-1} M_i' is the
      row-connectivity graph of M_i = [B_i; D_i]; a reverse-Cuthill-McKee
      ordering per block (or one shared by all blocks) bounds its
      profile, the largest half-bandwidth h is rounded up to a panel size
      b, and rows of near-global support are peeled into a trailing dense
      block (`plan_banded`);
  numeric (device, per IPM iteration): with bandwidth <= b the permuted
      Neq is block tridiagonal in [nb, N, b, b] panels, factored by the
      batched block-Cholesky recurrence

          G_k G_k' = A_kk - C_{k-1} C_{k-1}',    C_k = A_{k+1,k} G_k^{-T}

      with the panel inverses G_k^{-1} stored, so that every solve is two
      sweeps of batched [N, b, b] products (`block_tridiag_factor`,
      `block_tridiag_solve`).

The JAX package's `lax.scan` over the panels is a Python loop over the
static `nb` panels here: each panel one batched call over all N blocks,
and a captured fused solve records the loop unrolled.  Each panel's
Cholesky goes through `arrow_backend._root_cholesky`: the potf2 kernel in
f64 on the card, `torch.linalg` on the CPU and in f32 (the JAX package's
own call there is `jnp.linalg.cholesky`, no Pallas kernel).  Nothing is
read back inside the loop: the health flag stays a device tensor.

`BandArrowBackend` plugs into `ArrowBackend` through the two leaf hooks
(`_leaf_factor`, `_apply_Ninv_multi`); condensation, borders, Schur
assembly, root, refinement and the IPM above are unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pips_ipmpp_tpu_torch.linalg.arrow_backend import (ArrowBackend,
                                                       _bchol_solve,
                                                       _root_cholesky)


@dataclass(frozen=True)
class BandPlan:
    """Host-side symbolic analysis result (static)."""
    perm: np.ndarray       # [N, a] (or shared [a]) original row index in
                           # permuted position
    iperm: np.ndarray      # its inverse: permuted position of each row
    half_bandwidth: int    # max over blocks, in the permuted order
    panel: int             # block-tridiagonal panel size b (>= half_bw)
    n_panels: int          # nb; nb * b >= a - n_dense
    n_dense: int = 0       # trailing peeled dense rows (Schur-handled)


def plan_banded(lp, panel: Optional[int] = None, min_panel: int = 8,
                shared: bool = False,
                max_dense_frac: float = 0.1) -> BandPlan:
    """Symbolic analysis: RCM-order each block's row-connectivity graph
    (host numpy and scipy, on one host copy of B and D).

    Rows whose connectivity degree dwarfs the median (cost and budget
    rows) would inflate the bandwidth to O(a); they are PEELED into a
    trailing dense block (at most `max_dense_frac` of the rows) handled by
    a small Schur complement at solve time.  `shared=True` computes ONE
    ordering from the union pattern of all blocks (perm and iperm are
    1-D [a])."""
    from scipy import sparse
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    B = lp.B.detach().cpu().numpy()
    D = lp.D.detach().cpu().numpy()
    N = B.shape[0]
    a = B.shape[1] + D.shape[1]
    max_dense = int(max_dense_frac * a)

    def graph_of(pattern):
        M = sparse.csr_matrix(pattern.astype(np.int8))
        return (M @ M.T).tocsr()

    def dense_rows_of(S):
        """Peel rows whose connectivity degree dwarfs the median."""
        if not max_dense:
            return np.zeros(0, np.int64)
        deg = np.diff(S.indptr)
        med = max(np.median(deg), 1.0)
        cand = np.nonzero(deg > max(32, 8 * med))[0]
        if cand.size > max_dense:
            cand = cand[np.argsort(deg[cand])[::-1][:max_dense]]
        return np.sort(cand)

    def rcm_of(S, keep):
        """RCM over the kept subgraph; returns (perm over keep, h)."""
        Ssub = S[keep][:, keep].tocsr()
        p = np.asarray(reverse_cuthill_mckee(Ssub, symmetric_mode=True),
                       np.int32)
        m = keep.size
        pos = np.empty(m, np.int64)
        pos[p] = np.arange(m)
        coo = Ssub.tocoo()
        h = int(np.max(np.abs(pos[coo.row] - pos[coo.col]))) if coo.nnz \
            else 1
        return keep[p].astype(np.int32), max(h, 1)

    def analyze(pattern):
        S = graph_of(pattern)
        dense = dense_rows_of(S)
        keep = np.setdiff1d(np.arange(a), dense)
        band_perm, h = rcm_of(S, keep)
        return band_perm, dense.astype(np.int32), h

    if shared:
        union = (np.abs(B) > 0).any(axis=0)
        union = np.concatenate([union, (np.abs(D) > 0).any(axis=0)], axis=0)
        bp, dn, h = analyze(union)
        k = dn.size
        perms = np.concatenate([bp, dn])
        iperms = np.argsort(perms).astype(np.int32)
    else:
        results = [analyze(np.concatenate([B[i], D[i]], axis=0) != 0.0)
                   for i in range(N)]
        k = max(r[1].size for r in results)
        h = max(r[2] for r in results)
        perms = np.empty((N, a), np.int32)
        for i, (bp, dn, _h) in enumerate(results):
            pad = k - dn.size
            # pad the dense set from the TAIL of the band ordering (any
            # rows are correct there; trailing band rows are cheapest)
            perms[i] = np.concatenate([bp[:bp.size - pad], dn,
                                       bp[bp.size - pad:]])
        iperms = np.argsort(perms, axis=1).astype(np.int32)
    ab = a - k
    if panel is None:
        panel = max(min_panel, -(-h // min_panel) * min_panel)
        panel = min(panel, max(ab, min_panel))
    elif panel < h:
        raise ValueError(f"panel {panel} < half-bandwidth {h}")
    n_panels = max(-(-ab // panel), 1) if ab else 1
    return BandPlan(perm=perms, iperm=iperms, half_bandwidth=h,
                    panel=panel, n_panels=n_panels, n_dense=k)


def block_tridiag_factor(Adiag, Asub):
    """Batched block-tridiagonal Cholesky with explicit panel inverses.

    Adiag [nb, N, b, b], Asub [nb, N, b, b] with Asub[k] = A_{k+1,k} (the
    last entry ignored).  Returns (Ginv, C, ok): Ginv[k] = G_k^{-1}
    (lower), C[k] = A_{k+1,k} G_k^{-T}, ok a 0-dim device bool."""
    nb, N, b, _ = Adiag.shape
    eye = torch.eye(b, dtype=Adiag.dtype, device=Adiag.device).expand(
        N, b, b)
    Ginv = torch.empty_like(Adiag)
    C = torch.empty_like(Adiag)
    ok = torch.ones((), dtype=torch.bool, device=Adiag.device)
    for k in range(nb):
        S = Adiag[k] - C[k - 1] @ C[k - 1].mT if k else Adiag[k]
        G, okk = _root_cholesky(S)
        Ginv[k] = torch.linalg.solve_triangular(G, eye, upper=False)
        C[k] = Asub[k] @ Ginv[k].mT                 # A_{k+1,k} G^{-T}
        ok = ok & okk.all()
    return Ginv, C, ok & torch.isfinite(Ginv).all()


def block_tridiag_solve(Ginv, C, r):
    """Solve (L L') x = r with L from `block_tridiag_factor`.

    r [nb, N, b, c]; returns x of the same shape: a forward and a backward
    sweep of batched [N, b, b] x [N, b, c] products."""
    nb = r.shape[0]
    y = torch.empty_like(r)
    for k in range(nb):
        rk = r[k] - C[k - 1] @ y[k - 1] if k else r[k]
        y[k] = Ginv[k] @ rk
    x = torch.empty_like(r)
    for k in reversed(range(nb)):
        # x_k = G_k^{-T} (y_k - C_k' x_{k+1})
        t = y[k] - C[k].mT @ x[k + 1] if k < nb - 1 else y[k]
        x[k] = Ginv[k].mT @ t
    return x


def _permute(arr, perm):
    """Gather rows (axis 1) of [N, a, ...] by a [N, a] or shared [a]
    permutation."""
    if perm.ndim == 1:
        return arr.index_select(1, perm)
    idx = perm.reshape(perm.shape + (1,) * (arr.ndim - 2)).expand(
        perm.shape + arr.shape[2:])
    return torch.gather(arr, 1, idx)


class BandArrowBackend(ArrowBackend):
    """ArrowBackend whose leaf factorization is banded (block tridiagonal).

    Construct with a `BandPlan` from `plan_banded`.  All other machinery
    (condensation, border solves, Schur assembly, root, refinement) is
    inherited; the dense leaf kernels (LDL, sweep) and explicit inverses
    are off, as in the JAX package, so an f32 root takes the two-level
    Cholesky path too."""

    def __init__(self, lp, plan: BandPlan, **kw):
        if lp.batch_shape:
            raise NotImplementedError(
                "BandArrowBackend over a stack of LPs is not ported yet "
                "(ROADMAP.md §1: the fused batch under the banded and "
                "bucketed modes)")
        kw.setdefault("explicit_inverse", False)
        super().__init__(lp, **kw)
        # the band path owns the leaf; disable the dense leaf kernels
        self.ldl_kernel = self.root_ldl = False
        self.sweep_kernel = False
        self.explicit_inverse = self.root_explicit_inverse = False
        self.plan = plan
        self._perm = torch.as_tensor(plan.perm, dtype=torch.int64,
                                     device=lp.device)
        self._iperm = torch.as_tensor(plan.iperm, dtype=torch.int64,
                                      device=lp.device)

    # ---- leaf hooks ----
    def _band_rhs_solve(self, Ginv, C, t):
        """Band-part solve for t [N, ab, c] (already permuted and split)."""
        b, nb = self.plan.panel, self.plan.n_panels
        N, ab, c = t.shape
        if nb * b > ab:
            t = torch.cat([t, t.new_zeros((N, nb * b - ab, c))], dim=1)
        r = t.reshape(N, nb, b, c).transpose(0, 1)
        x = block_tridiag_solve(Ginv, C, r)
        return x.transpose(0, 1).reshape(N, nb * b, c)[:, :ab]

    def _leaf_factor(self, M, MEi, Fd):
        fd = self.factor_dtype
        plan = self.plan
        b, nb, k = plan.panel, plan.n_panels, plan.n_dense
        N, a, n = M.shape
        ab = a - k
        ap = nb * b

        Mp = _permute(M, self._perm).to(fd)
        MEip = _permute(MEi, self._perm).to(fd)
        Fdp = _permute(Fd, self._perm).to(fd)
        Mb, Md = Mp[:, :ab], Mp[:, ab:]
        Eb, Ed = MEip[:, :ab], MEip[:, ab:]
        Fb, Fdd = Fdp[:, :ab], Fdp[:, ab:]
        if ap > ab:
            # pad with identity rows (decoupled, unit pivot)
            zrow = Mb.new_zeros((N, ap - ab, n))
            Mb = torch.cat([Mb, zrow], dim=1)
            Eb = torch.cat([Eb, zrow], dim=1)
            Fb = torch.cat([Fb, Fb.new_ones((N, ap - ab))], dim=1)

        Mr = Mb.reshape(N, nb, b, n)
        Er = Eb.reshape(N, nb, b, n)
        # only the tridiagonal band of Neq is formed (entries outside are
        # structurally zero by the bandwidth bound): [nb, N, b, b]
        Adiag = (torch.einsum("iKan,iKcn->Kiac", Er, Mr)
                 + torch.diag_embed(Fb.reshape(N, nb, b)).transpose(0, 1))
        Asub = torch.cat([
            torch.einsum("iKan,iKcn->Kiac", Er[:, 1:], Mr[:, :-1]),
            Adiag.new_zeros((1, N, b, b))], dim=0)
        Ginv, C, ok = block_tridiag_factor(Adiag, Asub)
        if k == 0:
            return (Ginv, C), None, ok

        # peeled dense rows: small trailing Schur complement
        #   Neq = [[Bb, U], [U', Dd]];  S = Dd - U' Bb^{-1} U
        U = torch.einsum("ian,icn->iac", Eb[:, :ab], Md)      # [N, ab, k]
        W = self._band_rhs_solve(Ginv, C, U)                  # Bb^{-1} U
        Dd = (torch.einsum("ian,icn->iac", Ed, Md)
              + torch.diag_embed(Fdd))
        S = Dd - torch.einsum("iam,iac->imc", U, W)           # [N, k, k]
        cholS, okS = _root_cholesky(S)
        eye_k = torch.eye(k, dtype=fd, device=S.device).expand(N, k, k)
        Sinv = _bchol_solve(cholS, eye_k)
        ok = ok & okS.all() & torch.isfinite(Sinv).all()
        return (Ginv, C, U, W, Sinv), None, ok

    def _apply_Ninv_multi(self, L, Ninv, t):
        k = self.plan.n_dense
        ab = t.shape[1] - k
        tp = _permute(t, self._perm)
        if k == 0:
            Ginv, C = L
            xp = self._band_rhs_solve(Ginv, C, tp)
        else:
            Ginv, C, U, W, Sinv = L
            t1, t2 = tp[:, :ab], tp[:, ab:]
            u1 = self._band_rhs_solve(Ginv, C, t1)
            rhs2 = t2 - torch.einsum("iam,iac->imc", U, u1)
            x2 = torch.einsum("imk,ikc->imc", Sinv, rhs2)
            x1 = u1 - torch.einsum("iak,ikc->iac", W, x2)
            xp = torch.cat([x1, x2], dim=1)
        return _permute(xp, self._iperm)
