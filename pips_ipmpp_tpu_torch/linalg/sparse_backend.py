"""Matrix-free sparse leaf backend: CG on the condensed block systems.

Counterpart of `pips_ipmpp_tpu/linalg/sparse_backend.py` (its ELL path).
The reference factorizes each sparse leaf KKT with PARDISO and extracts a
Schur complement (PardisoSchurSolver.C:84-252).  For genuinely sparse
blocks (energy LPs with 10^4-row blocks at ~10 nnz/row, which the dense
ArrowBackend cannot even hold) this backend keeps the same two-level
condensation but solves the SPD condensed system

    Neq = M E^{-1} M' + F_d,     M = [B; D]  (ELL, core/sparse.py)

matrix-free with Jacobi-preconditioned CG, batched over blocks and over all
Schur right-hand sides at once.  Every B/D product goes through
`linalg/spmv.py` (on CUDA the hand-written ELL kernel); leaf memory stays
O(nnz).  The IPM's iterative refinement on the augmented residual and its
regularization ladder absorb the inexact leaf solves.

Everything above the leaves (root Schur assembly and factorization, the
solves and refinement) is inherited from ArrowBackend; with f32 factors
the root goes through the LDL^T kernel.

Precision: the residual products (Ax, ATy, Cx, CTz) run in the working
dtype (f64); the leaf CG, its products and its preconditioner run in the
factor dtype, f32 on the card as on the TPU, f64 in the CPU tests.
"""
from __future__ import annotations

import torch

from pips_ipmpp_tpu_torch.core.sparse import Ell, SparseArrowheadLP
from pips_ipmpp_tpu_torch.core.spaces import RVec, XVec
from pips_ipmpp_tpu_torch.ipm.control import capturing, dev_while
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend, scalar
from pips_ipmpp_tpu_torch.linalg.spmv import (ell_mv, ell_mv_multi,
                                              sell_from_ell)


def batched_pcg(apply_A, B, dinv, max_iters: int, tol: float):
    """Jacobi-preconditioned CG on independent SPD systems batched over
    (block, rhs-column): B [N, a, c].  Returns (X, iterations).

    Stops when every column's residual norm is below tol * ||b|| (or at
    max_iters), tested before every iteration as the JAX package's
    while_loop does: a `control.dev_while`.  Eager, each test is one
    read-back, counted in `batched_pcg.readbacks`; calls are counted in
    `batched_pcg.calls`, those that stop at max_iters in
    `batched_pcg.capped`.  Captured, the loop is a WHILE node with no
    read-back; nothing is counted and the iteration count returned is
    None.  Zero columns take alpha = 0 and stay zero."""
    tiny = torch.finfo(B.dtype).tiny
    Z = dinv[:, :, None] * B
    rz = (B * Z).sum(1, keepdim=True)
    bnorm = torch.sqrt((B * B).sum(1, keepdim=True))
    thresh = (tol * torch.clamp(bnorm, min=tiny)) ** 2
    trips = [0]

    def unconverged(carry):
        R = carry[1]
        return ((R * R).sum(1, keepdim=True) > thresh).any()

    def step(carry):
        X, R, P, rz = carry
        Ap = apply_A(P)
        den = (P * Ap).sum(1, keepdim=True)
        alpha = torch.where(den > tiny, rz / torch.clamp(den, min=tiny), 0.0)
        X = X + alpha * P
        R = R - alpha * Ap
        Z = dinv[:, :, None] * R
        rz2 = (R * Z).sum(1, keepdim=True)
        beta = torch.where(rz > tiny, rz2 / torch.clamp(rz, min=tiny), 0.0)
        trips[0] += 1
        return X, R, Z + beta * P, rz2

    X, _, _, _ = dev_while(unconverged, step, (torch.zeros_like(B), B, Z, rz),
                           max_iters)
    if capturing(B):
        return X, None
    k = trips[0]
    batched_pcg.readbacks += k + (k < max_iters)
    batched_pcg.calls += 1
    batched_pcg.capped += k == max_iters
    return X, k


batched_pcg.readbacks = batched_pcg.calls = batched_pcg.capped = 0


def _stack_rows(top: Ell, bottom: Ell) -> Ell:
    """[top; bottom] with the slot count padded to the larger K."""
    K = max(top.K, bottom.K)

    def pad(t):
        z = t.new_zeros(t.shape[:2] + (K - t.shape[2],))
        return torch.cat([t, z], dim=2)

    return Ell(torch.cat([pad(top.val), pad(bottom.val)], dim=1),
               torch.cat([pad(top.col), pad(bottom.col)], dim=1))


def _stack_cols(left: Ell, right: Ell, m_left: int) -> Ell:
    """[left | right] acting on [u; v] with u of length m_left: the slots
    side by side, the right part's column ids shifted past u."""
    return Ell(torch.cat([left.val, right.val], dim=2),
               torch.cat([left.col, right.col + m_left], dim=2))


class SparseArrowBackend(ArrowBackend):
    """ArrowBackend over a SparseArrowheadLP: ELL products + CG leaf solves.

    The root (first stage + linking) stays dense: its dimension is the
    Schur size nS = n0 + mEl + mIl, as in the reference's dense root
    solvers (DenseSymmetricIndefinite, sLinsysRootAug.C)."""

    def __init__(self, lp: SparseArrowheadLP, factor_dtype=torch.float64,
                 cg_iters: int = 500, cg_tol: float = 0.0, **kwargs):
        if kwargs.pop("blockwise_sc", 0):
            raise ValueError("blockwise_sc: the sparse leaf already "
                             "streams; caches are O(n * nS) only")
        if kwargs.get("iterative_root", 0):
            raise NotImplementedError(
                "the sparse backend's iterative root is not ported yet "
                "(ROADMAP.md §1, item 16: the sparse backend under the "
                "solve modes)")
        self.cg_iters = cg_iters
        if cg_tol == 0.0:
            cg_tol = 1e-12 if factor_dtype == torch.float64 else 1e-7
        self.cg_tol = cg_tol
        super().__init__(lp, factor_dtype=factor_dtype, **kwargs)

    def solve_reduced_bicgstab(self, fac, rhs, max_iters=8, tol=1e-10):
        raise NotImplementedError(
            "outer BiCGStab over the sparse backend is not ported yet "
            "(ROADMAP.md §1, item 16: the sparse backend under the solve "
            "modes)")

    def _init_leaves(self):
        """ELL operators, each built once in the sliced layout
        (`spmv.sell_from_ell`, the padded ELL kept beside it): B, D and
        their transposes in the working dtype for the residual products;
        the merged M = [B; D], its transpose and its squared values (Jacobi
        diagonal) in the factor dtype for the CG."""
        lp, fd = self.lp, self.factor_dtype
        n, mE, mI = lp.n, lp.mE, lp.mI
        self._B = sell_from_ell(lp.B, n, "B")
        self._D = sell_from_ell(lp.D, n, "D")
        self._Bt = sell_from_ell(lp.Bt, mE, "Bt")
        self._Dt = sell_from_ell(lp.Dt, mI, "Dt")
        M = _stack_rows(lp.B, lp.D).astype(fd)
        self._M = sell_from_ell(M, n, "M")
        self._Mt = sell_from_ell(_stack_cols(lp.Bt, lp.Dt, mE).astype(fd),
                                 mE + mI, "Mt")
        self._Msq = sell_from_ell(Ell(M.val * M.val, M.col), n, "Msq")

    # ---- matvecs: the dense backend's structure, B/D terms as ELL -------
    def Ax(self, x: XVec) -> RVec:
        lp = self.lp
        first = lp.A0 @ x.first
        blocks = (torch.einsum("imk,k->im", lp.A, x.first)
                  + ell_mv(self._B, x.blocks))
        link = lp.F0 @ x.first + torch.einsum("iln,in->l", lp.F, x.blocks)
        return RVec(first, blocks, link)

    def ATy(self, y: RVec) -> XVec:
        lp = self.lp
        first = (lp.A0.T @ y.first + lp.F0.T @ y.link
                 + torch.einsum("imk,im->k", lp.A, y.blocks))
        blocks = (ell_mv(self._Bt, y.blocks)
                  + torch.einsum("iln,l->in", lp.F, y.link))
        return XVec(first, blocks)

    def Cx(self, x: XVec) -> RVec:
        lp = self.lp
        first = lp.C0 @ x.first
        blocks = (torch.einsum("imk,k->im", lp.C, x.first)
                  + ell_mv(self._D, x.blocks))
        link = lp.G0 @ x.first + torch.einsum("iln,in->l", lp.G, x.blocks)
        return RVec(first, blocks, link)

    def CTz(self, z: RVec) -> XVec:
        lp = self.lp
        first = (lp.C0.T @ z.first + lp.G0.T @ z.link
                 + torch.einsum("imk,im->k", lp.C, z.blocks))
        blocks = (ell_mv(self._Dt, z.blocks)
                  + torch.einsum("iln,l->in", lp.G, z.link))
        return XVec(first, blocks)

    # ---- condensed-system tools (factor dtype) ----------------------------
    def _Fd(self, Om, delta_d):
        lp = self.lp
        dd = scalar(delta_d, Om)
        return torch.cat([dd.expand(lp.N, lp.mE), Om + dd], dim=1)

    def _neq_apply(self, Einv, Fd, V):
        """Neq @ V = M E^{-1} M' V + F_d V, multi-RHS V [N, a, c]: two
        products, the scalings in their epilogues."""
        t = ell_mv_multi(self._Mt, V, alpha=Einv)
        return ell_mv_multi(self._M, t, beta=Fd, Z=V)

    def _leaf_cg(self, Einv, Fd, dinv, Bc):
        return batched_pcg(lambda V: self._neq_apply(Einv, Fd, V),
                           Bc, dinv, self.cg_iters, self.cg_tol)

    # ---- factorize: condensation + Schur contribution, no leaf factor ----
    def factorize(self, Dx: XVec, Ominv: RVec, delta_p, delta_d):
        lp = self.lp
        fd = self.factor_dtype
        n0, mEl, mIl = lp.n0, lp.mEl, lp.mIl
        mE, mI, n = lp.mE, lp.mI, lp.n

        Einv = 1.0 / (Dx.blocks + delta_p)                    # [N, n]
        Om = 1.0 / Ominv.blocks                               # [N, mI]
        Einv_f = Einv.to(fd)
        Fd_f = self._Fd(Om, delta_d).to(fd)                   # [N, a]
        # Jacobi preconditioner: diag(Neq) = sum_n M^2 Einv + Fd
        diag = ell_mv(self._Msq, Einv_f, z=Fd_f)
        dinv = 1.0 / diag

        # border right-hand sides (columns [x0 | yl | zl]), as in the
        # dense path but with ELL products
        dt = Einv.dtype
        dev = Einv.device
        EiRx = torch.cat([
            torch.zeros((lp.N, n, n0), dtype=dt, device=dev),
            lp.F.mT * Einv[:, :, None],
            lp.G.mT * Einv[:, :, None]], dim=2)               # [N, n, nS]
        zpad = torch.zeros((lp.N, 1, mEl + mIl), dtype=dt, device=dev)
        Rm = torch.cat([
            torch.cat([lp.A, zpad.expand(lp.N, mE, mEl + mIl)], dim=2),
            torch.cat([lp.C, zpad.expand(lp.N, mI, mEl + mIl)], dim=2)],
            dim=1)                                            # [N, a, nS]
        EiRx_f = EiRx.to(fd)
        # a - b is a + (-b) exactly, so the epilogues round as the
        # subtractions do
        rhsU = ell_mv_multi(self._M, EiRx_f, Z=-Rm.to(fd))
        Um, _iters = self._leaf_cg(Einv_f, Fd_f, dinv, rhsU)  # [N, a, nS]
        Ux = ell_mv_multi(self._Mt, Um, alpha=-Einv_f, Z=EiRx_f)
        Um, Ux = Um.to(dt), Ux.to(dt)

        contrib_x0 = (torch.einsum("imk,imS->kS", lp.A, Um[:, :mE])
                      + torch.einsum("imk,imS->kS", lp.C, Um[:, mE:]))
        contrib_yl = torch.einsum("ilm,imS->lS", lp.F, Ux)
        contrib_zl = torch.einsum("ilm,imS->lS", lp.G, Ux)
        contrib = torch.cat([contrib_x0, contrib_yl, contrib_zl], dim=0)

        leaf_ok = torch.isfinite(Um).all() & (diag > 0.0).all()
        # fac.Ninv carries the Jacobi diagonal inverse (the leaf CG's
        # state); fac.L is unused on this path
        return self._assemble_root(Dx, Ominv, delta_p, delta_d, None, dinv,
                                   Einv, Om, Ux, Um, contrib, leaf_ok)

    # ---- leaf solves ------------------------------------------------------
    def _leaf_solve(self, fac, rho_x, rho_m):
        """K_b^{-1}(rho_x, rho_m) via one CG on the condensed system."""
        fd = self.factor_dtype
        dt = rho_x.dtype
        Einv_f = fac.Einv.to(fd)
        Fd_f = self._Fd(fac.Om, fac.delta_d).to(fd)
        t = ell_mv(self._M, (fac.Einv * rho_x).to(fd), z=-rho_m.to(fd))
        gm, _iters = self._leaf_cg(Einv_f, Fd_f, fac.Ninv, t[:, :, None])
        gm = gm[:, :, 0]
        # the product is in the factor dtype, the rest in the working
        # dtype: an epilogue would round it in the factor dtype
        gx = fac.Einv * (rho_x - ell_mv(self._Mt, gm).to(dt))
        return gx, gm.to(dt)
