r"""Arrowhead backend: batched block KKT condensation + Schur complement.

Counterpart of `pips_ipmpp_tpu/linalg/arrow_backend.py` (see its docstring
for the derivation).  Per IPM iteration, for every block i (all N at once):

  block augmented KKT (quasidefinite; x-block diagonal for LPs):

      K_i = [ E_i    M_i' ]   E_i = Dx_i + dp (diag)   M_i = [B_i; D_i]
            [ M_i   -F_i  ]   F_i = diag(dd, Om_i + dd)

  condensation: Neq_i = M_i E_i^{-1} M_i' + F_i (SPD), factored in one
  batch — by the LDL^T kernel (linalg/ldl.py) with f32 factors, by
  Cholesky with f64 factors, or inverted by the sweep kernel
  (linalg/sweep.py) when asked; border solves U_i = K_i^{-1} R_i and the
  Schur contribution -R_i' K_i^{-1} R_i are batched matmuls.

The root system over s0full = [x0; y0; z0; yl; zl]

      S = K_0 - sum_i R_i' K_i^{-1} R_i

is quasidefinite with an SPD x0-block.  It is either factored whole by the
LDL^T kernel (explicit root inverse, inertia check, in-place shift
escalation) or by a two-level condensation (Cholesky of S11, then of the
dual Schur complement).

Solves run Lsolve -> Dsolve -> Ltsolve with adaptive iterative refinement
on the augmented residual in the working dtype.

Factorization and solves are capture-clean: no read-back, no tensor made
from host data.  The root shift escalation and the refinement are
`control.dev_while` loops, conditional nodes when the fused loop is
captured, and the regularization shifts may be Python numbers or device
tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP
from pips_ipmpp_tpu_torch.core.spaces import RVec, XVec, _vdot
from pips_ipmpp_tpu_torch.ipm.control import dev_while
from pips_ipmpp_tpu_torch.ipm.formulation import Bounds, ReducedRhs
from pips_ipmpp_tpu_torch.linalg.ldl import (inverse_from_factors,
                                             ldl_inverse_factors)
from pips_ipmpp_tpu_torch.linalg.sweep import sweep_inverse


@dataclass
class ArrowFactors:
    """One factorization of the arrowhead KKT system.  Fields a mode does
    not use are None."""
    L: object           # Cholesky of Neq [N, a, a] | (X, 1/d) factored
                        # inverse | None
    Ninv: Optional[torch.Tensor]     # [N, a, a] explicit Neq^{-1}
    Einv: torch.Tensor               # [N, n]
    Om: torch.Tensor                 # [N, mI]
    Ux: torch.Tensor                 # [N, n, nS]      K^{-1}R rows x
    Um: torch.Tensor                 # [N, mE+mI, nS]  K^{-1}R rows (y,z)
    chol1: Optional[torch.Tensor]    # [n0, n0] Cholesky of S11
    S11inv: Optional[torch.Tensor]   # [n0, n0] explicit inverse
    T: Optional[torch.Tensor]        # [n0, nD] S11^{-1} S12
    chol2: Optional[torch.Tensor]    # [nD, nD] Cholesky of the dual Schur
    Sdinv: Optional[torch.Tensor]    # [nD, nD] explicit inverse
    Einv0: torch.Tensor              # [n0]
    Om0: torch.Tensor                # [m0I]
    Oml: torch.Tensor                # [mIl]
    delta_p: torch.Tensor
    delta_d: torch.Tensor
    Sinv: Optional[torch.Tensor]     # [ns, ns] explicit root inverse (LDL)
    ok: torch.Tensor                 # scalar factorization-health flag
    extra_root: object = 0.0         # extra root-only shift applied by the
                                     # in-factorize escalation


def _tri_solve(L, b, transpose=False):
    """L x = b (or L' x = b) for lower-triangular L, batched or not."""
    if transpose:
        return torch.linalg.solve_triangular(L.mT, b, upper=True)
    return torch.linalg.solve_triangular(L, b, upper=False)


def _bchol_solve(L, b):
    """SPD solve via a cached Cholesky factor: L L' x = b (b may be one
    vector per matrix)."""
    if b.ndim < L.ndim:
        return _bchol_solve(L, b[..., None])[..., 0]
    return _tri_solve(L, _tri_solve(L, b), transpose=True)


def _cholesky(S):
    """Cholesky factor of (S + S')/2 and a health flag; a failed
    factorization does not raise (the IPM escalates its regularization
    instead).  The JAX package's `jnp.linalg.cholesky` symmetrizes its
    input the same way: a Schur complement built from inexact leaf solves
    (the sparse backend's capped CG) is not symmetric, and the lower
    triangle alone is another matrix."""
    L, info = torch.linalg.cholesky_ex((S + S.mT) / 2)
    return L, (info == 0).all() & torch.isfinite(L).all()


def _absmax(t):
    return t.abs().max() if t.numel() else t.new_zeros(())


def scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A shift as a 0-dim tensor of `like`'s dtype and device: a tensor is
    converted, a Python number filled in on the device (no copy from the
    host, which a graph capture refuses)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    return torch.full((), v, dtype=like.dtype, device=like.device)


class ArrowBackend:
    """Backend over an ArrowheadLP on one device.

    With f32 factors the leaves and the root go through the LDL^T kernel
    (`ldl_kernel`), keeping either explicit inverses or, with
    `factored_inverse`, the (X, 1/d) factors of the leaves; with f64
    factors they go through Cholesky.  `sweep_kernel=True` (with the LDL
    kernel's explicit inverses only) inverts leaves and root with the sweep
    kernel instead: opt-in, since the sweep is unstable on IPM-conditioned
    systems."""

    def __init__(self, lp: ArrowheadLP, factor_dtype=torch.float64,
                 explicit_inverse: Optional[bool] = None,
                 ldl_kernel: Optional[bool] = None,
                 factored_inverse: bool = False,
                 root_escalation: bool = True,
                 root_escalation_base: float = 1e-4,
                 root_escalation_growth: float = 100.0,
                 root_escalation_max: float = 10.0,
                 blockwise_sc: int = 0,
                 dist_root: bool = False,
                 iterative_root: int = 0,
                 band_root_plan=None,
                 sweep_kernel: Optional[bool] = None):
        for name, val in (("blockwise_sc", blockwise_sc),
                          ("dist_root", dist_root),
                          ("iterative_root", iterative_root),
                          ("band_root_plan", band_root_plan)):
            if val:
                raise NotImplementedError(f"ArrowBackend({name}=...) is not "
                                          f"ported yet")
        self.lp = lp
        self.factor_dtype = factor_dtype
        if explicit_inverse is None:
            explicit_inverse = factor_dtype == torch.float32
        self.explicit_inverse = explicit_inverse
        if ldl_kernel is None:
            ldl_kernel = factor_dtype == torch.float32 and explicit_inverse
        self.ldl_kernel = ldl_kernel
        self.factored_inverse = factored_inverse and ldl_kernel
        # the sweep (linalg/sweep.py) replaces the LDL kernel's explicit
        # inverses only; off unless asked
        self.sweep_kernel = bool(sweep_kernel) and ldl_kernel \
            and not factored_inverse
        self.root_escalation = root_escalation
        self.root_escalation_base = root_escalation_base
        self.root_escalation_growth = root_escalation_growth
        self.root_escalation_max = root_escalation_max
        self.bounds = Bounds(
            c=XVec(lp.c0, lp.cN),
            b=RVec(lp.b0, lp.bN, lp.bl),
            ixlow=XVec(lp.ixlow0, lp.ixlowN), xlow=XVec(lp.xlow0, lp.xlowN),
            ixupp=XVec(lp.ixupp0, lp.ixuppN), xupp=XVec(lp.xupp0, lp.xuppN),
            iclow=RVec(lp.iclow0, lp.iclowN, lp.iclowl),
            clow=RVec(lp.clow0, lp.clowN, lp.clowl),
            icupp=RVec(lp.icupp0, lp.icuppN, lp.icuppl),
            cupp=RVec(lp.cupp0, lp.cuppN, lp.cuppl),
        )
        local = (lp.ixlowN.sum() + lp.ixuppN.sum() + lp.iclowN.sum()
                 + lp.icuppN.sum())
        rep = (lp.ixlow0.sum() + lp.ixupp0.sum() + lp.iclow0.sum()
               + lp.icupp0.sum() + lp.iclowl.sum() + lp.icuppl.sum())
        self.num_bound_pairs = torch.clamp(local + rep, min=1.0)
        self._init_leaves()

    def _init_leaves(self):
        """Leaf operators: the dense merged M = [B; D] and its factor-dtype
        copy (the sparse backend keeps ELL operators instead)."""
        self.M = torch.cat([self.lp.B, self.lp.D], dim=1)      # [N, a, n]
        self.Mf = self.M.to(self.factor_dtype)

    # ---- matvecs (recursive tree mult of the reference, collapsed to
    #      batched einsum) ----
    def Ax(self, x: XVec) -> RVec:
        lp = self.lp
        first = lp.A0 @ x.first
        blocks = (torch.einsum("imk,k->im", lp.A, x.first)
                  + torch.einsum("imn,in->im", lp.B, x.blocks))
        link = lp.F0 @ x.first + torch.einsum("iln,in->l", lp.F, x.blocks)
        return RVec(first, blocks, link)

    def ATy(self, y: RVec) -> XVec:
        lp = self.lp
        first = (lp.A0.T @ y.first + lp.F0.T @ y.link
                 + torch.einsum("imk,im->k", lp.A, y.blocks))
        blocks = (torch.einsum("imn,im->in", lp.B, y.blocks)
                  + torch.einsum("iln,l->in", lp.F, y.link))
        return XVec(first, blocks)

    def Cx(self, x: XVec) -> RVec:
        lp = self.lp
        first = lp.C0 @ x.first
        blocks = (torch.einsum("imk,k->im", lp.C, x.first)
                  + torch.einsum("imn,in->im", lp.D, x.blocks))
        link = lp.G0 @ x.first + torch.einsum("iln,in->l", lp.G, x.blocks)
        return RVec(first, blocks, link)

    def CTz(self, z: RVec) -> XVec:
        lp = self.lp
        first = (lp.C0.T @ z.first + lp.G0.T @ z.link
                 + torch.einsum("imk,im->k", lp.C, z.blocks))
        blocks = (torch.einsum("imn,im->in", lp.D, z.blocks)
                  + torch.einsum("iln,l->in", lp.G, z.link))
        return XVec(first, blocks)

    def objective(self, x: XVec) -> torch.Tensor:
        return _vdot(self.lp.c0, x.first) + _vdot(self.lp.cN, x.blocks)

    def datanorm(self) -> torch.Tensor:
        return self.lp.datanorm()

    # ---- leaf factorization ----
    def _leaf_factor(self, M, MEi, Fd):
        """Factor the condensed leaf systems Neq_i = MEi M' + diag(Fd).

        Returns (L, Ninv, leaf_ok) as `_apply_Ninv_multi` consumes them."""
        fd = self.factor_dtype
        Neq = (torch.einsum("iak,ibk->iab", MEi.to(fd), self.Mf)
               + torch.diag_embed(Fd.to(fd)))
        if self.sweep_kernel:
            Ninv, df = sweep_inverse(Neq)
            leaf_ok = torch.isfinite(Ninv).all() & (df > 0.0).all()
            return None, Ninv, leaf_ok
        if self.ldl_kernel:
            Xf, df = ldl_inverse_factors(Neq)
            if self.factored_inverse:
                leaf_ok = torch.isfinite(Xf).all() & (df > 0.0).all()
                return (Xf, 1.0 / df), None, leaf_ok
            Ninv = inverse_from_factors(Xf, df)
            leaf_ok = torch.isfinite(Ninv).all() & (df > 0.0).all()
            return None, Ninv, leaf_ok
        L, leaf_ok = _cholesky(Neq)
        if not self.explicit_inverse:
            return L, None, leaf_ok
        a = M.shape[1]
        eye = torch.eye(a, dtype=fd, device=Neq.device).expand(
            self.lp.N, a, a)
        Ninv = _bchol_solve(L, eye)
        return L, Ninv, leaf_ok & torch.isfinite(Ninv).all()

    def _apply_Ninv_multi(self, L, Ninv, t):
        """Neq^{-1} t for multi-RHS t [N, a, c] via the stored leaf factor:
        factored (X, 1/d) pair, explicit Ninv, or Cholesky L."""
        if self.factored_inverse:
            Xf, dinv = L
            return Xf.mT @ (dinv[:, :, None] * (Xf @ t))
        if Ninv is not None:
            return Ninv @ t
        return _bchol_solve(L, t)

    def leaf_factorize(self, Dx_blocks, Ominv_blocks, delta_p, delta_d):
        """Batched condensation, border solves, and the blocks' Schur
        contribution.  Returns (L, Ninv, Einv, Om, Ux, Um, contrib,
        leaf_ok)."""
        lp = self.lp
        fd = self.factor_dtype
        n0, mEl, mIl = lp.n0, lp.mEl, lp.mIl
        mE, mI = lp.mE, lp.mI

        Einv = 1.0 / (Dx_blocks + delta_p)                     # [N, n]
        Om = 1.0 / Ominv_blocks                                # [N, mI]
        dt = Einv.dtype
        M = self.M
        dd = scalar(delta_d, Einv)
        Fd = torch.cat([dd.expand(lp.N, mE), Om + dd], dim=1)  # [N, mE+mI]
        MEi = M * Einv[:, None, :]
        L, Ninv, leaf_ok = self._leaf_factor(M, MEi, Fd)

        # ---- border solves U = K^{-1} R (structure-exploiting) ----
        # E^{-1} R_x = [0 | Einv*F' | Einv*G']
        EiRx = torch.cat([
            torch.zeros((lp.N, lp.n, n0), dtype=dt, device=Einv.device),
            lp.F.mT * Einv[:, :, None],
            lp.G.mT * Einv[:, :, None]], dim=2)                # [N, n, nS]
        Rm = torch.cat([
            torch.cat([lp.A, lp.C], dim=1),
            torch.zeros((lp.N, mE + mI, mEl + mIl), dtype=dt,
                        device=Einv.device)], dim=2)           # [N, a, nS]
        Mf = self.Mf
        EiRxf = EiRx.to(fd)
        rhsU = Mf @ EiRxf - Rm.to(fd)
        Um = self._apply_Ninv_multi(L, Ninv, rhsU)
        Ux = EiRxf - Einv.to(fd)[:, :, None] * (Mf.mT @ Um)

        # ---- Schur contribution  R'U: rows [A'U_my + C'U_mz ; F U_x ; G U_x]
        contrib_x0 = (torch.einsum("imk,imS->kS", lp.A.to(fd), Um[:, :mE])
                      + torch.einsum("imk,imS->kS", lp.C.to(fd), Um[:, mE:]))
        contrib_yl = torch.einsum("ilm,imS->lS", lp.F.to(fd), Ux)
        contrib_zl = torch.einsum("ilm,imS->lS", lp.G.to(fd), Ux)
        contrib = torch.cat([contrib_x0, contrib_yl, contrib_zl],
                            dim=0).to(dt)
        return L, Ninv, Einv, Om, Ux.to(dt), Um.to(dt), contrib, leaf_ok

    def factorize(self, Dx: XVec, Ominv: RVec, delta_p, delta_d
                  ) -> ArrowFactors:
        L, Ninv, Einv, Om, Ux, Um, contrib, leaf_ok = self.leaf_factorize(
            Dx.blocks, Ominv.blocks, delta_p, delta_d)
        return self._assemble_root(Dx, Ominv, delta_p, delta_d, L, Ninv,
                                   Einv, Om, Ux, Um, contrib, leaf_ok)

    def _assemble_root(self, Dx, Ominv, delta_p, delta_d, L, Ninv, Einv,
                       Om, Ux, Um, contrib, leaf_ok):
        lp = self.lp
        fd = self.factor_dtype
        n0, m0E, m0I = lp.n0, lp.m0E, lp.m0I
        mEl, mIl = lp.mEl, lp.mIl
        dt = Einv.dtype
        dev = Einv.device
        # ---- root matrix S over s0full = [x0; y0; z0; yl; zl] ----
        Einv0 = 1.0 / (Dx.first + delta_p)
        Om0 = 1.0 / Ominv.first
        Oml = 1.0 / Ominv.link
        nD = m0E + m0I + mEl + mIl
        yl0, zl0 = m0E + m0I, m0E + m0I + mEl      # dual offsets of yl, zl

        # contrib rows/cols are ordered [x0(n0), yl(mEl), zl(mIl)]
        cxx, cyl, czl = contrib[:n0], contrib[n0:n0 + mEl], contrib[n0 + mEl:]
        S11 = torch.diag(Dx.first + delta_p) - cxx[:, :n0]     # [n0, n0]
        # dual-space layout: [y0(m0E), z0(m0I), yl(mEl), zl(mIl)]
        S12 = torch.cat([lp.A0.T, lp.C0.T,
                         lp.F0.T - cxx[:, n0:n0 + mEl],
                         lp.G0.T - cxx[:, n0 + mEl:]], dim=1)  # [n0, nD]
        delta_p = scalar(delta_p, Einv)
        delta_d = scalar(delta_d, Einv)
        F0d = torch.cat([delta_d.expand(m0E), Om0 + delta_d,
                         delta_d.expand(mEl), Oml + delta_d])
        S22 = -torch.diag(F0d)
        S22[yl0:zl0, yl0:zl0] -= cyl[:, n0:n0 + mEl]
        S22[yl0:zl0, zl0:] -= cyl[:, n0 + mEl:]
        S22[zl0:, yl0:zl0] -= czl[:, n0:n0 + mEl]
        S22[zl0:, zl0:] -= czl[:, n0 + mEl:]

        common = dict(L=L, Ninv=Ninv, Einv=Einv, Om=Om, Ux=Ux, Um=Um,
                      Om0=Om0, Oml=Oml, delta_p=delta_p, delta_d=delta_d)

        if self.ldl_kernel:
            # ---- single quasidefinite root factor+inverse (LDL kernel):
            # SPD primal block, negative-definite dual block -> unpivoted
            # LDL is stable (Vanderbei); the explicit inverse turns every
            # root solve into one matvec ----
            Sfull = torch.cat([torch.cat([S11, S12], dim=1),
                               torch.cat([S12.T, S22], dim=1)], dim=0).to(fd)
            sgn = torch.cat([torch.ones(n0, dtype=fd, device=dev),
                             -torch.ones(nD, dtype=fd, device=dev)])

            def _root_factor(extra):
                S = (Sfull + torch.diag(sgn * extra))[None]
                if self.sweep_kernel:
                    Sinv1, ds = sweep_inverse(S)
                    Sinv_ = Sinv1[0]
                else:
                    Xs, ds = ldl_inverse_factors(S)
                    Sinv_ = inverse_from_factors(Xs, ds)[0]
                ok_ = (torch.isfinite(Sinv_).all() & (ds[:, :n0] > 0.0).all()
                       & (ds[:, n0:] < 0.0).all())
                return Sinv_, ok_

            extra = torch.zeros((), dtype=fd, device=dev)
            Sinv, root_ok = _root_factor(extra)
            # the sweep's pivots are no reliable health signal: its
            # failures stay on the outer regularization ladder
            if self.root_escalation and not self.sweep_kernel:
                # Wrong-inertia failures in f32 sit in this small root
                # system: escalate only the root shift in place instead of
                # failing the whole factorization (an outer retry would
                # redo every leaf factorization)
                def escalate(carry):
                    extra_, _, _ = carry
                    extra_ = torch.where(extra_ == 0.0,
                                         self.root_escalation_base,
                                         extra_ * self.root_escalation_growth)
                    # the configured max is the LAST rung tried
                    extra_ = torch.clamp(extra_, max=self.root_escalation_max)
                    return (extra_, *_root_factor(extra_))

                extra, Sinv, root_ok = dev_while(
                    lambda c: ~c[2] & (c[0] < self.root_escalation_max),
                    escalate, (extra, Sinv, root_ok), self._root_rungs())
                # the solved system carries delta_p + extra on the
                # first-stage primal diagonal and delta_d + extra on the
                # root dual rows (_aug_residual reads both)
                Einv0 = 1.0 / (Dx.first + delta_p + extra.to(dt))
            return ArrowFactors(chol1=None, S11inv=None, T=None, chol2=None,
                                Sdinv=None, Einv0=Einv0, Sinv=Sinv,
                                ok=leaf_ok & root_ok, extra_root=extra.to(dt),
                                **common)

        # ---- root two-level condensation ----
        chol1, ok1 = _cholesky(S11.to(fd))
        T = _bchol_solve(chol1, S12.to(fd))
        Sdual = -(S22.to(fd) - S12.to(fd).T @ T)
        chol2, ok2 = _cholesky(Sdual)
        root_ok = ok1 & ok2
        S11inv = Sdinv = None
        if self.explicit_inverse:
            S11inv = _bchol_solve(chol1, torch.eye(n0, dtype=fd, device=dev))
            Sdinv = _bchol_solve(chol2, torch.eye(nD, dtype=fd, device=dev))
            root_ok = (root_ok & torch.isfinite(S11inv).all()
                       & torch.isfinite(Sdinv).all())
        return ArrowFactors(chol1=chol1, S11inv=S11inv, T=T.to(dt),
                            chol2=chol2, Sdinv=Sdinv, Einv0=Einv0, Sinv=None,
                            ok=leaf_ok & root_ok, **common)

    def _root_rungs(self) -> int:
        """Rungs of the root escalation from 0 up to its max (the loop's
        bound; its own test stops it there)."""
        n, extra = 0, 0.0
        while extra < self.root_escalation_max:
            extra = min(self.root_escalation_base if extra == 0.0
                        else extra * self.root_escalation_growth,
                        self.root_escalation_max)
            n += 1
        return n

    def factorization_ok(self, fac: ArrowFactors) -> torch.Tensor:
        return fac.ok

    # ------------------------------------------------------------------
    def _leaf_solve(self, fac: ArrowFactors, rho_x, rho_m):
        """Batched K_i^{-1} applied to (rho_x [N,n], rho_m [N,mE+mI])."""
        fd = self.factor_dtype
        M = self.M
        t = torch.einsum("iam,im->ia", M, fac.Einv * rho_x) - rho_m
        gm = self._apply_Ninv_multi(fac.L, fac.Ninv,
                                    t[..., None].to(fd))[..., 0]
        gm = gm.to(rho_x.dtype)
        gx = fac.Einv * (rho_x - torch.einsum("iam,ia->im", M, gm))
        return gx, gm

    def _root_solve(self, fac: ArrowFactors, p, q):
        """Solve S [a; d] = [p; q] via the cached root factorization."""
        fd = self.factor_dtype
        dt = p.dtype
        if fac.Sinv is not None:
            u = (fac.Sinv @ torch.cat([p, q]).to(fd)).to(dt)
            return u[:p.shape[0]], u[p.shape[0]:]
        q2 = (q - fac.T.T @ p).to(fd)
        if self.explicit_inverse:
            d = -(fac.Sdinv @ q2).to(dt)
            a = (fac.S11inv @ p.to(fd)).to(dt) - fac.T @ d
        else:
            d = -_bchol_solve(fac.chol2, q2).to(dt)   # Sdual = -(S22 - ..)
            a = _bchol_solve(fac.chol1, p.to(fd)).to(dt) - fac.T @ d
        return a, d

    def solve_reduced(self, fac: ArrowFactors, rhs: ReducedRhs,
                      refinement_steps: int = 1):
        lp = self.lp
        m0E, m0I, mEl = lp.m0E, lp.m0I, lp.mEl
        mE = lp.mE

        rho_x = -rhs.rhat_x.blocks
        rho_m = torch.cat([-rhs.rA.blocks, -rhs.rhat_z.blocks], dim=1)
        p0 = -rhs.rhat_x.first
        q0 = torch.cat([-rhs.rA.first, -rhs.rhat_z.first,
                        -rhs.rA.link, -rhs.rhat_z.link])

        state = self._solve_core(fac, p0, q0, rho_x, rho_m)

        if refinement_steps > 0:
            # adaptive iterative refinement on the augmented residual in
            # the working dtype (absorbs f32 factorization error; the role
            # of solveCompressedIterRefin, LinearSystem.C:877)
            rhs_norm = torch.clamp(
                torch.maximum(_absmax(rho_x),
                              torch.maximum(_absmax(p0), _absmax(q0))),
                min=1e-30)

            def resid_norm(st):
                r = self._aug_residual(fac, p0, q0, rho_x, rho_m, *st)
                nrm = torch.stack([_absmax(e) for e in
                                   (r[2], r[3], r[0], r[1])]).max()
                return r, nrm

            def refine(carry):
                state_, res_, nrm_, _ = carry
                corr = self._solve_core(fac, *res_)
                new = tuple(s + c for s, c in zip(state_, corr))
                res2, nrm2 = resid_norm(new)
                # keep the better iterate if refinement diverged
                worse = nrm2 > nrm_
                return (tuple(torch.where(worse, s, n)
                              for s, n in zip(state_, new)), res2,
                        torch.where(worse, nrm_, nrm2), nrm_)

            res, nrm = resid_norm(state)
            state, _, _, _ = dev_while(
                lambda c: (c[2] > 1e-11 * rhs_norm) & (c[2] < 0.25 * c[3]),
                refine, (state, res, nrm, torch.full_like(nrm, float("inf"))),
                refinement_steps)

        dx_first, dx_blocks, d0, gm = state
        # unpack: d0 = [yhat0, zhat0, yhat_l, zhat_l]; gm = [yhat_i, zhat_i]
        yl0, zl0 = m0E + m0I, m0E + m0I + mEl
        dy = RVec(-d0[:m0E], -gm[:, :mE], -d0[yl0:zl0])
        dz = RVec(-d0[m0E:yl0], -gm[:, mE:], -d0[zl0:])
        return XVec(dx_first, dx_blocks), dy, dz

    def _solve_core(self, fac: ArrowFactors, p0, q0, rho_x, rho_m):
        """One pass of Lsolve -> Dsolve -> Ltsolve (sLinsysRootAug.C:323-365)."""
        lp = self.lp
        mE = lp.mE
        yl0, zl0 = lp.m0E + lp.m0I, lp.m0E + lp.m0I + lp.mEl

        # Lsolve: leaf solves + accumulate border products
        gx, gm = self._leaf_solve(fac, rho_x, rho_m)
        acc_x0 = (torch.einsum("imk,im->k", lp.A, gm[:, :mE])
                  + torch.einsum("imk,im->k", lp.C, gm[:, mE:]))
        acc_yl = torch.einsum("ilm,im->l", lp.F, gx)
        acc_zl = torch.einsum("ilm,im->l", lp.G, gx)

        p = p0 - acc_x0
        q = torch.cat([q0[:yl0], q0[yl0:zl0] - acc_yl, q0[zl0:] - acc_zl])

        # Dsolve: root dense solve
        a, d = self._root_solve(fac, p, q)

        # Ltsolve: back-substitute into blocks
        s0 = torch.cat([a, d[yl0:zl0], d[zl0:]])
        dx_blocks = gx - torch.einsum("imS,S->im", fac.Ux, s0)
        gm_out = gm - torch.einsum("iaS,S->ia", fac.Um, s0)
        return a, dx_blocks, d, gm_out

    def _aug_residual(self, fac, p0, q0, rho_x, rho_m,
                      dx_first, dx_blocks, d0, gm):
        """Residual of the full augmented arrowhead system (refinement).

        Unknown layout: (dx_first, dx_blocks) primal; duals with *hat* sign
        (yhat = -dy): d0 = [y0,z0,yl,zl] root, gm = [y_i, z_i] per block."""
        lp = self.lp
        m0E, m0I, mEl = lp.m0E, lp.m0I, lp.mEl
        mE = lp.mE
        dd = fac.delta_d
        # root rows carry the extra in-factorize escalation shift (the
        # leaves stay at dd); E0 = 1/Einv0 already embeds dp + extra
        dd_root = dd + fac.extra_root
        yl0, zl0 = m0E + m0I, m0E + m0I + mEl

        y0h, z0h = d0[:m0E], d0[m0E:yl0]
        ylh, zlh = d0[yl0:zl0], d0[zl0:]
        yih, zih = gm[:, :mE], gm[:, mE:]

        ATyh = self.ATy(RVec(y0h, yih, ylh))
        CTzh = self.CTz(RVec(z0h, zih, zlh))
        x = XVec(dx_first, dx_blocks)
        Ax = self.Ax(x)
        Cx = self.Cx(x)

        E0 = 1.0 / fac.Einv0
        Eb = 1.0 / fac.Einv
        top_first = E0 * dx_first + ATyh.first + CTzh.first
        top_blocks = Eb * dx_blocks + ATyh.blocks + CTzh.blocks
        eq_first = Ax.first - dd_root * y0h
        eq_blocks = Ax.blocks - dd * yih
        eq_link = Ax.link - dd_root * ylh
        iq_first = Cx.first - (fac.Om0 + dd_root) * z0h
        iq_blocks = Cx.blocks - (fac.Om + dd) * zih
        iq_link = Cx.link - (fac.Oml + dd_root) * zlh

        ex0 = p0 - top_first
        ex = rho_x - top_blocks
        em = rho_m - torch.cat([eq_blocks, iq_blocks], dim=1)
        eq0 = q0 - torch.cat([eq_first, iq_first, eq_link, iq_link])
        return ex0, eq0, ex, em
