"""Bucketed arrowhead backend: heterogeneous block sizes, one shared root.

Counterpart of `pips_ipmpp_tpu/linalg/bucket_backend.py`.  One
`ArrowBackend` per size bucket (`core/bucketed.py`): every bucket runs the
batched leaf condensation and border solves at its OWN padded shape (the
LDL kernel at each bucket's leaf shape with f32 factors), the Schur
contributions are summed and the root is assembled and factored exactly
once, by the first bucket's backend.  On one device there is no mesh: the
JAX package's psum over the blocks' sums is the identity here.

Space vectors carry `blocks` as tuples of per-bucket tensors; only this
backend knows about buckets.
"""
from __future__ import annotations

import dataclasses

import torch

from pips_ipmpp_tpu_torch.core.bucketed import BucketedArrowheadLP
from pips_ipmpp_tpu_torch.core.lp import _maxabs
from pips_ipmpp_tpu_torch.core.spaces import RVec, XVec, _vdot, select, tmap
from pips_ipmpp_tpu_torch.ipm.control import dev_while
from pips_ipmpp_tpu_torch.ipm.formulation import Bounds, ReducedRhs
from pips_ipmpp_tpu_torch.linalg.arrow_backend import (
    ArrowBackend, ArrowFactors, _mv, preconditioned_bicgstab)


class BucketedArrowBackend:
    """Backend over a BucketedArrowheadLP.  Takes ArrowBackend's dense leaf
    modes (f32 LDL kernel with explicit or factored inverses, f64
    Cholesky) and its root modes but the special ones: `dist_root`,
    `iterative_root`, `band_root_plan` and `blockwise_sc` raise the JAX
    package's ValueError.  `root_factor_dtype` reaches the backend that
    owns the root (the first bucket's)."""

    def __init__(self, lp: BucketedArrowheadLP, factor_dtype=torch.float64,
                 **kw):
        for bad in ("dist_root", "iterative_root", "band_root_plan",
                    "blockwise_sc"):
            if kw.pop(bad, None):
                raise ValueError(f"{bad} is not supported with bucketed "
                                 "blocks")
        self.lp = lp
        self.batch_shape = ()
        self.factor_dtype = factor_dtype
        self.subs = tuple(ArrowBackend(b, factor_dtype=factor_dtype, **kw)
                          for b in lp.buckets)
        b0 = self.subs[0].bounds
        self.bounds = Bounds(
            c=XVec(b0.c.first, tuple(s.bounds.c.blocks for s in self.subs)),
            b=RVec(b0.b.first, tuple(s.bounds.b.blocks for s in self.subs),
                   b0.b.link),
            ixlow=self._xv("ixlow"), xlow=self._xv("xlow"),
            ixupp=self._xv("ixupp"), xupp=self._xv("xupp"),
            iclow=self._rv("iclow"), clow=self._rv("clow"),
            icupp=self._rv("icupp"), cupp=self._rv("cupp"),
        )
        local = sum(b.ixlowN.sum() + b.ixuppN.sum() + b.iclowN.sum()
                    + b.icuppN.sum() for b in lp.buckets)
        f = lp.buckets[0]
        rep = (f.ixlow0.sum() + f.ixupp0.sum() + f.iclow0.sum()
               + f.icupp0.sum() + f.iclowl.sum() + f.icuppl.sum())
        self.num_bound_pairs = torch.clamp(local + rep, min=1.0)

    def _xv(self, name):
        b0 = self.subs[0].bounds
        return XVec(getattr(b0, name).first,
                    tuple(getattr(s.bounds, name).blocks for s in self.subs))

    def _rv(self, name):
        b0 = self.subs[0].bounds
        return RVec(getattr(b0, name).first,
                    tuple(getattr(s.bounds, name).blocks for s in self.subs),
                    getattr(b0, name).link)

    # ---- matvecs ----
    def Ax(self, x: XVec) -> RVec:
        f = self.lp.buckets[0]
        blocks = tuple(
            torch.einsum("imk,k->im", b.A, x.first)
            + torch.einsum("imn,in->im", b.B, xb)
            for b, xb in zip(self.lp.buckets, x.blocks))
        link = _mv(f.F0, x.first) + sum(
            torch.einsum("iln,in->l", b.F, xb)
            for b, xb in zip(self.lp.buckets, x.blocks))
        return RVec(_mv(f.A0, x.first), blocks, link)

    def ATy(self, y: RVec) -> XVec:
        f = self.lp.buckets[0]
        first = (_mv(f.A0.mT, y.first) + _mv(f.F0.mT, y.link)
                 + sum(torch.einsum("imk,im->k", b.A, yb)
                       for b, yb in zip(self.lp.buckets, y.blocks)))
        blocks = tuple(
            torch.einsum("imn,im->in", b.B, yb)
            + torch.einsum("iln,l->in", b.F, y.link)
            for b, yb in zip(self.lp.buckets, y.blocks))
        return XVec(first, blocks)

    def Cx(self, x: XVec) -> RVec:
        f = self.lp.buckets[0]
        blocks = tuple(
            torch.einsum("imk,k->im", b.C, x.first)
            + torch.einsum("imn,in->im", b.D, xb)
            for b, xb in zip(self.lp.buckets, x.blocks))
        link = _mv(f.G0, x.first) + sum(
            torch.einsum("iln,in->l", b.G, xb)
            for b, xb in zip(self.lp.buckets, x.blocks))
        return RVec(_mv(f.C0, x.first), blocks, link)

    def CTz(self, z: RVec) -> XVec:
        f = self.lp.buckets[0]
        first = (_mv(f.C0.mT, z.first) + _mv(f.G0.mT, z.link)
                 + sum(torch.einsum("imk,im->k", b.C, zb)
                       for b, zb in zip(self.lp.buckets, z.blocks)))
        blocks = tuple(
            torch.einsum("imn,im->in", b.D, zb)
            + torch.einsum("iln,l->in", b.G, z.link)
            for b, zb in zip(self.lp.buckets, z.blocks))
        return XVec(first, blocks)

    def objective(self, x: XVec) -> torch.Tensor:
        f = self.lp.buckets[0]
        return _vdot(f.c0, x.first) + sum(
            _vdot(b.cN, xb) for b, xb in zip(self.lp.buckets, x.blocks))

    def datanorm(self) -> torch.Tensor:
        return torch.stack([b.datanorm() for b in self.lp.buckets]).amax()

    # ------------------------------------------------------------------
    def factorize(self, Dx: XVec, Ominv: RVec, delta_p, delta_d
                  ) -> ArrowFactors:
        pieces = [s.leaf_factorize(Dx.blocks[b], Ominv.blocks[b],
                                   delta_p, delta_d)
                  for b, s in enumerate(self.subs)]
        contrib = sum(p[6] for p in pieces)
        leaf_ok = pieces[0][7]
        for p in pieces[1:]:
            leaf_ok = leaf_ok & p[7]
        L0, N0, E0, O0, Ux0, Um0, _, _ = pieces[0]
        fac = self.subs[0]._assemble_root(
            Dx, Ominv, delta_p, delta_d, L0, N0, E0, O0, Ux0, Um0,
            contrib, leaf_ok)
        return dataclasses.replace(
            fac,
            L=tuple(p[0] for p in pieces),
            Ninv=tuple(p[1] for p in pieces),
            Einv=tuple(p[2] for p in pieces),
            Om=tuple(p[3] for p in pieces),
            Ux=tuple(p[4] for p in pieces),
            Um=tuple(p[5] for p in pieces))

    def factorization_ok(self, fac: ArrowFactors) -> torch.Tensor:
        return fac.ok

    def _sub_fac(self, fac: ArrowFactors, b: int) -> ArrowFactors:
        return dataclasses.replace(
            fac, L=fac.L[b], Ninv=fac.Ninv[b], Einv=fac.Einv[b],
            Om=fac.Om[b], Ux=fac.Ux[b], Um=fac.Um[b])

    # ------------------------------------------------------------------
    def _solve_core(self, fac: ArrowFactors, p0, q0, rho_x, rho_m):
        """Lsolve -> Dsolve -> Ltsolve over all buckets with one shared
        root solve (sLinsysRootAug.C:323-365)."""
        f = self.lp.buckets[0]
        yl0, zl0 = f.m0E + f.m0I, f.m0E + f.m0I + f.mEl

        gxs, gms = [], []
        acc_x0 = p0.new_zeros((f.n0,))
        acc_yl = p0.new_zeros((f.mEl,))
        acc_zl = p0.new_zeros((f.mIl,))
        for b, s in enumerate(self.subs):
            blp = s.lp
            gx, gm = s._leaf_solve(self._sub_fac(fac, b), rho_x[b], rho_m[b])
            acc_x0 = acc_x0 + (
                torch.einsum("imk,im->k", blp.A, gm[:, :blp.mE])
                + torch.einsum("imk,im->k", blp.C, gm[:, blp.mE:]))
            acc_yl = acc_yl + torch.einsum("ilm,im->l", blp.F, gx)
            acc_zl = acc_zl + torch.einsum("ilm,im->l", blp.G, gx)
            gxs.append(gx)
            gms.append(gm)

        p = p0 - acc_x0
        q = torch.cat([q0[:yl0], q0[yl0:zl0] - acc_yl, q0[zl0:] - acc_zl])

        a, d = self.subs[0]._root_solve(fac, p, q)

        s0 = torch.cat([a, d[yl0:zl0], d[zl0:]])
        dx_blocks = tuple(
            gxs[b] - torch.einsum("imS,S->im", fac.Ux[b], s0)
            for b in range(len(self.subs)))
        gm_out = tuple(
            gms[b] - torch.einsum("iaS,S->ia", fac.Um[b], s0)
            for b in range(len(self.subs)))
        return a, dx_blocks, d, gm_out

    def _aug_residual(self, fac, p0, q0, rho_x, rho_m,
                      dx_first, dx_blocks, d0, gm):
        """Residual of the full augmented system (tuple-block layout);
        mirrors ArrowBackend._aug_residual."""
        f = self.lp.buckets[0]
        m0E, yl0, zl0 = f.m0E, f.m0E + f.m0I, f.m0E + f.m0I + f.mEl
        dd = fac.delta_d
        dd_root = dd + fac.extra_root

        y0h, z0h = d0[:m0E], d0[m0E:yl0]
        ylh, zlh = d0[yl0:zl0], d0[zl0:]
        yih = tuple(gm[b][:, :s.lp.mE] for b, s in enumerate(self.subs))
        zih = tuple(gm[b][:, s.lp.mE:] for b, s in enumerate(self.subs))

        ATyh = self.ATy(RVec(y0h, yih, ylh))
        CTzh = self.CTz(RVec(z0h, zih, zlh))
        x = XVec(dx_first, dx_blocks)
        Ax = self.Ax(x)
        Cx = self.Cx(x)

        E0 = 1.0 / fac.Einv0
        ex0 = p0 - (E0 * dx_first + ATyh.first + CTzh.first)
        ex = tuple(
            rho_x[b] - ((1.0 / fac.Einv[b]) * dx_blocks[b]
                        + ATyh.blocks[b] + CTzh.blocks[b])
            for b in range(len(self.subs)))
        em = tuple(
            rho_m[b] - torch.cat(
                [Ax.blocks[b] - dd * yih[b],
                 Cx.blocks[b] - (fac.Om[b] + dd) * zih[b]], dim=1)
            for b in range(len(self.subs)))
        eq_first = Ax.first - dd_root * y0h
        iq_first = Cx.first - (fac.Om0 + dd_root) * z0h
        eq_link = Ax.link - dd_root * ylh
        iq_link = Cx.link - (fac.Oml + dd_root) * zlh
        eq0 = q0 - torch.cat([eq_first, iq_first, eq_link, iq_link])
        return ex0, eq0, ex, em

    # ------------------------------------------------------------------
    def _rhs(self, rhs: ReducedRhs):
        """(p0, q0, rho_x, rho_m) of a reduced right-hand side."""
        p0 = -rhs.rhat_x.first
        q0 = torch.cat([-rhs.rA.first, -rhs.rhat_z.first,
                        -rhs.rA.link, -rhs.rhat_z.link])
        rho_x = tuple(-v for v in rhs.rhat_x.blocks)
        rho_m = tuple(
            torch.cat([-rhs.rA.blocks[b], -rhs.rhat_z.blocks[b]], dim=1)
            for b in range(len(self.subs)))
        return p0, q0, rho_x, rho_m

    def _unpack(self, state):
        """(dx, dy, dz) from a solve's (dx_first, dx_blocks, d0, gm)."""
        f = self.lp.buckets[0]
        m0E, yl0, zl0 = f.m0E, f.m0E + f.m0I, f.m0E + f.m0I + f.mEl
        dx_first, dx_blocks, d0, gm = state
        dy = RVec(-d0[:m0E],
                  tuple(-gm[b][:, :s.lp.mE] for b, s in enumerate(self.subs)),
                  -d0[yl0:zl0])
        dz = RVec(-d0[m0E:yl0],
                  tuple(-gm[b][:, s.lp.mE:] for b, s in enumerate(self.subs)),
                  -d0[zl0:])
        return XVec(dx_first, dx_blocks), dy, dz

    def solve_reduced(self, fac: ArrowFactors, rhs: ReducedRhs,
                      refinement_steps: int = 1):
        p0, q0, rho_x, rho_m = self._rhs(rhs)
        state = self._solve_core(fac, p0, q0, rho_x, rho_m)

        if refinement_steps > 0:
            # max (not sum) across buckets, as ArrowBackend.solve_reduced,
            # so that the 1e-11 * rhs_norm exit keeps its meaning
            rhs_norm = torch.clamp(torch.stack(
                [_maxabs(p0), _maxabs(q0)] + [_maxabs(r) for r in rho_x]
            ).amax(), min=1e-30)

            def resid_norm(st):
                res = self._aug_residual(fac, p0, q0, rho_x, rho_m, *st)
                ex0, eq0, ex, em = res
                return res, torch.stack(
                    [_maxabs(e) for e in (ex0, eq0, *ex, *em)]).amax()

            def refine(carry):
                state_, res_, nrm_, _ = carry
                corr = self._solve_core(fac, *res_)
                new = tmap(torch.add, state_, corr)
                res2, nrm2 = resid_norm(new)
                # keep the better iterate if refinement diverged
                worse = nrm2 > nrm_
                return (select(worse, state_, new), res2,
                        torch.where(worse, nrm_, nrm2), nrm_)

            res, nrm = resid_norm(state)
            state, _, _, _ = dev_while(
                lambda c: (c[2] > 1e-11 * rhs_norm) & (c[2] < 0.25 * c[3]),
                refine, (state, res, nrm, torch.full_like(nrm, float("inf"))),
                refinement_steps)
        return self._unpack(state)

    # ------------------------------------------------------------------
    def _state_dot(self, a, b):
        ax0, axb, ad0, agm = a
        bx0, bxb, bd0, bgm = b
        rep = _vdot(ax0, bx0) + _vdot(ad0, bd0)
        shard = sum(_vdot(x, y) for x, y in zip(axb, bxb))
        shard = shard + sum(_vdot(x, y) for x, y in zip(agm, bgm))
        return rep + shard

    def _apply_K(self, fac, state):
        """K state: minus `_aug_residual` with a zero right-hand side."""
        dxf, dxb, dd0, dgm = state
        ex0, eq0, ex, em = self._aug_residual(
            fac, torch.zeros_like(dxf), torch.zeros_like(dd0),
            tmap(torch.zeros_like, dxb), tmap(torch.zeros_like, dgm),
            dxf, dxb, dd0, dgm)
        return (-ex0, tuple(-e for e in ex), -eq0, tuple(-e for e in em))

    def solve_reduced_bicgstab(self, fac: ArrowFactors, rhs: ReducedRhs,
                               max_iters: int = 8, tol=1e-10):
        """BiCGStab on K u = rho preconditioned by one structured solve
        (`ArrowBackend.solve_reduced_bicgstab` over the buckets)."""
        p0, q0, rho_x, rho_m = self._rhs(rhs)

        def precond(v):
            x0, xb, d0, gm = v
            return self._solve_core(fac, x0, d0, xb, gm)

        u, stats = preconditioned_bicgstab(
            (p0, rho_x, q0, rho_m), precond,
            lambda v: self._apply_K(fac, v), self._state_dot, max_iters, tol)
        return (*self._unpack(u), stats)


def scatter_to_buckets(lp: BucketedArrowheadLP, values: list):
    """Host helper: reorder a per-original-block list into per-bucket
    stacked arrays (intake order -> bucket layout)."""
    import numpy as np
    out = [[None] * b.N for b in lp.buckets]
    for i, (bi, pos) in enumerate(lp.placement):
        out[bi][pos] = values[i]
    return [np.stack(v) for v in out]


def gather_from_buckets(lp: BucketedArrowheadLP, blocks) -> list:
    """Host helper: per-bucket arrays -> list in original block order."""
    return [blocks[bi][pos] for (bi, pos) in lp.placement]
