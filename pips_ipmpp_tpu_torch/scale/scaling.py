r"""Problem scaling: equilibrium (inf-norm) scaling of an arrowhead LP.

Counterpart of the equilibrium part of `pips_ipmpp_tpu/scale/scaling.py`
(reference Core/Preprocessing/Scaler.cpp, EquilibriumScaler), for the
batched-dense ArrowheadLP and the ELL SparseArrowheadLP.  Scaling runs
once at setup, off the IPM hot path, on the batched arrowhead tensors.

Transform (col scale s > 0, eq-row scale rE > 0, ineq-row scale rC > 0):

    A' = diag(rE) A diag(s)    b' = rE.b      x' = x / s
    C' = diag(rC) C diag(s)    clow' = rC.clow, cupp' = rC.cupp
    c' = s.c                   xlow' = xlow/s, xupp' = xupp/s

All final factors are rounded to powers of two, so scaling and unscaling
are exact in floating point.
"""
from __future__ import annotations

import dataclasses

import torch

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP
from pips_ipmpp_tpu_torch.core.options import ScalerType
from pips_ipmpp_tpu_torch.core.sparse import Ell, SparseArrowheadLP
from pips_ipmpp_tpu_torch.core.spaces import RVec, XVec, tmap

_INF = float("inf")


def _pow2_round(v):
    """Round positive factors to the nearest power of two (exact scaling)."""
    return torch.ldexp(torch.ones_like(v),
                       torch.round(torch.log2(v)).to(torch.int32))


def _safe(v):
    """Replace 0/inf/nan factors by 1 (empty rows/cols are left unscaled)."""
    return torch.where(torch.isfinite(v) & (v > 0), v, 1.0)


_MIN_REL_FLOOR = 1e-8   # entries below this fraction of the row/col max are
# ignored by the min statistic


def _rstat(S, op, floor=None):
    """Row reduce of a scaled abs matrix; op in (max, min-over-nonzeros).
    `floor` (row-shaped) excludes entries below a fraction of the FULL
    row's max when the row spans several matrix parts."""
    if S.shape[-1] == 0:
        return torch.full(S.shape[:-1], 0.0 if op == "max" else _INF,
                          dtype=S.dtype, device=S.device)
    if op == "max":
        return S.amax(dim=-1)
    thr = (floor[..., None] if floor is not None
           else _MIN_REL_FLOOR * S.amax(dim=-1, keepdim=True))
    return torch.where(S > thr, S, _INF).amin(dim=-1)


def _cstat(S, op, floor=None):
    if S.shape[-2] == 0:
        return torch.full(S.shape[:-2] + S.shape[-1:],
                          0.0 if op == "max" else _INF,
                          dtype=S.dtype, device=S.device)
    if op == "max":
        return S.amax(dim=-2)
    thr = (floor[..., None, :] if floor is not None
           else _MIN_REL_FLOOR * S.amax(dim=-2, keepdim=True))
    return torch.where(S > thr, S, _INF).amin(dim=-2)


def _red(op):
    return torch.maximum if op == "max" else torch.minimum


def _agg0(st, op):
    """Reduce a batched statistic over its block axis."""
    return st.amax(0) if op == "max" else st.amin(0)


class _ArrowView:
    """Stats/apply adapter for ArrowheadLP (batched structure-aware)."""

    def __init__(self, lp: ArrowheadLP):
        self.lp = lp

    def ones(self):
        lp = self.lp
        one = torch.ones_like
        s = XVec(one(lp.c0), one(lp.cN))
        rE = RVec(one(lp.b0), one(lp.bN), one(lp.bl))
        rC = RVec(one(lp.clow0), one(lp.clowN), one(lp.clowl))
        return s, rE, rC

    def row_stats(self, s, rE, rC, op):
        red = _red(op)

        def rows(M0, Mb, Bb, Ml0, Mlb, r0, rb, rl):
            # block-0 rows, per-block rows (border+diag), linking rows.
            # Min stats use a floor from the FULL row's max across parts.
            S0 = M0.abs() * r0[:, None] * s.first[None, :]
            first = _rstat(S0, op)
            Sb1 = Mb.abs() * rb[:, :, None] * s.first[None, None, :]
            Sb2 = Bb.abs() * rb[:, :, None] * s.blocks[:, None, :]
            Sl0 = Ml0.abs() * rl[:, None] * s.first[None, :]
            Slb = Mlb.abs() * rl[None, :, None] * s.blocks[:, None, :]
            if op == "max":
                blocks = red(_rstat(Sb1, "max"), _rstat(Sb2, "max"))
                stat_l0 = _rstat(Sl0, "max")
                stat_lb = _rstat(Slb, "max")
            else:
                fb = _MIN_REL_FLOOR * torch.maximum(_rstat(Sb1, "max"),
                                                    _rstat(Sb2, "max"))
                blocks = red(_rstat(Sb1, "min", fb), _rstat(Sb2, "min", fb))
                l0max = _rstat(Sl0, "max")
                lbmax = _rstat(Slb, "max")
                gl = (torch.maximum(l0max, lbmax.amax(0))
                      if lbmax.shape[0] else l0max)
                fl = _MIN_REL_FLOOR * gl
                stat_l0 = _rstat(Sl0, "min", fl)
                stat_lb = _rstat(Slb, "min", fl[None, :])
            if stat_lb.shape[0]:
                agg = _agg0(stat_lb, op)
            else:
                agg = torch.full_like(stat_l0, 0.0 if op == "max" else _INF)
            return RVec(first, blocks, red(stat_l0, agg))

        lp = self.lp
        sE = rows(lp.A0, lp.A, lp.B, lp.F0, lp.F, rE.first, rE.blocks,
                  rE.link)
        sC = rows(lp.C0, lp.C, lp.D, lp.G0, lp.G, rC.first, rC.blocks,
                  rC.link)
        return sE, sC

    def col_stats(self, s, rE, rC, op):
        lp = self.lp
        # First-stage columns span 6 matrices (the batched border parts
        # aggregate their block axis); block columns span 4.  Min stats use
        # a floor from the FULL column max.
        first_parts = [
            (lp.A0.abs() * rE.first[:, None] * s.first[None, :], False),
            (lp.C0.abs() * rC.first[:, None] * s.first[None, :], False),
            (lp.F0.abs() * rE.link[:, None] * s.first[None, :], False),
            (lp.G0.abs() * rC.link[:, None] * s.first[None, :], False),
            (lp.A.abs() * rE.blocks[:, :, None] * s.first[None, None, :],
             True),
            (lp.C.abs() * rC.blocks[:, :, None] * s.first[None, None, :],
             True),
        ]
        block_parts = [
            lp.B.abs() * rE.blocks[:, :, None] * s.blocks[:, None, :],
            lp.D.abs() * rC.blocks[:, :, None] * s.blocks[:, None, :],
            lp.F.abs() * rE.link[None, :, None] * s.blocks[:, None, :],
            lp.G.abs() * rC.link[None, :, None] * s.blocks[:, None, :],
        ]

        def first_stat(statop, floor=None):
            red = _red(statop)
            out = None
            for S, batched in first_parts:
                fl = None if floor is None else (
                    floor[None, :] if batched else floor)
                st = _cstat(S, statop, fl)
                if batched and st.shape[0]:
                    st = _agg0(st, statop)
                elif batched:
                    st = torch.full(st.shape[1:],
                                    0.0 if statop == "max" else _INF,
                                    dtype=st.dtype, device=st.device)
                out = st if out is None else red(out, st)
            return out

        def block_stat(statop, floor=None):
            red = _red(statop)
            out = None
            for S in block_parts:
                st = _cstat(S, statop, floor)
                out = st if out is None else red(out, st)
            return out

        if op == "max":
            return XVec(first_stat("max"), block_stat("max"))
        ffl = _MIN_REL_FLOOR * first_stat("max")
        bfl = _MIN_REL_FLOOR * block_stat("max")
        return XVec(first_stat("min", ffl), block_stat("min", bfl))

    def apply(self, s, rE, rC) -> ArrowheadLP:
        lp = self.lp
        kw = dict(
            c0=lp.c0 * s.first, cN=lp.cN * s.blocks,
            A0=lp.A0 * rE.first[:, None] * s.first[None, :],
            b0=lp.b0 * rE.first,
            C0=lp.C0 * rC.first[:, None] * s.first[None, :],
            A=lp.A * rE.blocks[:, :, None] * s.first[None, None, :],
            B=lp.B * rE.blocks[:, :, None] * s.blocks[:, None, :],
            bN=lp.bN * rE.blocks,
            C=lp.C * rC.blocks[:, :, None] * s.first[None, None, :],
            D=lp.D * rC.blocks[:, :, None] * s.blocks[:, None, :],
            F0=lp.F0 * rE.link[:, None] * s.first[None, :],
            F=lp.F * rE.link[None, :, None] * s.blocks[:, None, :],
            bl=lp.bl * rE.link,
            G0=lp.G0 * rC.link[:, None] * s.first[None, :],
            G=lp.G * rC.link[None, :, None] * s.blocks[:, None, :],
            clow0=lp.clow0 * rC.first, cupp0=lp.cupp0 * rC.first,
            clowN=lp.clowN * rC.blocks, cuppN=lp.cuppN * rC.blocks,
            clowl=lp.clowl * rC.link, cuppl=lp.cuppl * rC.link,
            xlow0=lp.xlow0 / s.first, xupp0=lp.xupp0 / s.first,
            xlowN=lp.xlowN / s.blocks, xuppN=lp.xuppN / s.blocks,
        )
        for f in dataclasses.fields(lp):
            kw.setdefault(f.name, getattr(lp, f.name))
        return ArrowheadLP(**kw)


def _gather_cols(v, ell: Ell):
    """v[i, col[i, r, k]] per ELL entry: v [N, n] -> [N, m, K]."""
    N, m, K = ell.val.shape
    return v.gather(1, ell.col.reshape(N, m * K).long()).reshape(N, m, K)


class _SparseEllView(_ArrowView):
    """Stats/apply adapter for SparseArrowheadLP: the structure of
    _ArrowView with the diagonal blocks B/D in ELL form.  Their row and
    column statistics and their scaling act on the ELL values directly:
    row factors index by the entry's row, column factors gather by the
    entry's column id, and the stored transposes Bt/Dt give the column
    statistics (their rows are B/D's columns)."""

    @staticmethod
    def _bd_scaled_abs(ell, r_rows, s_blocks):
        """|val| * r[row] * s[col] per ELL entry; padded entries stay 0."""
        return ell.val.abs() * r_rows[:, :, None] * _gather_cols(s_blocks,
                                                                  ell)

    def row_stats(self, s, rE, rC, op):
        red = _red(op)

        def rows(M0, border, ell, Ml0, Mlb, r0, rb, rl):
            S0 = M0.abs() * r0[:, None] * s.first[None, :]
            first = _rstat(S0, op)
            Sb1 = border.abs() * rb[:, :, None] * s.first[None, None, :]
            SbE = self._bd_scaled_abs(ell, rb, s.blocks)     # [N, m, K]
            Sl0 = Ml0.abs() * rl[:, None] * s.first[None, :]
            Slb = Mlb.abs() * rl[None, :, None] * s.blocks[:, None, :]
            if op == "max":
                blocks = red(_rstat(Sb1, "max"), SbE.amax(-1))
                stat_l0 = _rstat(Sl0, "max")
                stat_lb = _rstat(Slb, "max")
            else:
                rowmax = torch.maximum(_rstat(Sb1, "max"), SbE.amax(-1))
                fb = _MIN_REL_FLOOR * rowmax
                ell_min = torch.where(SbE > fb[:, :, None], SbE,
                                      _INF).amin(-1)
                blocks = red(_rstat(Sb1, "min", fb), ell_min)
                l0max = _rstat(Sl0, "max")
                lbmax = _rstat(Slb, "max")
                gl = (torch.maximum(l0max, lbmax.amax(0))
                      if lbmax.shape[0] else l0max)
                fl = _MIN_REL_FLOOR * gl
                stat_l0 = _rstat(Sl0, "min", fl)
                stat_lb = _rstat(Slb, "min", fl[None, :])
            if stat_lb.shape[0]:
                agg = _agg0(stat_lb, op)
            else:
                agg = torch.full_like(stat_l0, 0.0 if op == "max" else _INF)
            return RVec(first, blocks, red(stat_l0, agg))

        lp = self.lp
        sE = rows(lp.A0, lp.A, lp.B, lp.F0, lp.F, rE.first, rE.blocks,
                  rE.link)
        sC = rows(lp.C0, lp.C, lp.D, lp.G0, lp.G, rC.first, rC.blocks,
                  rC.link)
        return sE, sC

    def col_stats(self, s, rE, rC, op):
        lp = self.lp
        # first-stage columns: dense parts only (B/D never touch them)
        first_parts = [
            (lp.A0.abs() * rE.first[:, None] * s.first[None, :], False),
            (lp.C0.abs() * rC.first[:, None] * s.first[None, :], False),
            (lp.F0.abs() * rE.link[:, None] * s.first[None, :], False),
            (lp.G0.abs() * rC.link[:, None] * s.first[None, :], False),
            (lp.A.abs() * rE.blocks[:, :, None] * s.first[None, None, :],
             True),
            (lp.C.abs() * rC.blocks[:, :, None] * s.first[None, None, :],
             True),
        ]

        def first_stat(statop, floor=None):
            red = _red(statop)
            out = None
            for S, batched in first_parts:
                fl = None if floor is None else (
                    floor[None, :] if batched else floor)
                st = _cstat(S, statop, fl)
                if batched and st.shape[0]:
                    st = _agg0(st, statop)
                elif batched:
                    st = torch.full(st.shape[1:],
                                    0.0 if statop == "max" else _INF,
                                    dtype=st.dtype, device=st.device)
                out = st if out is None else red(out, st)
            return out

        # block columns: the transposed ELL (Bt/Dt rows are columns), whose
        # row factor is the column's s and gathered factor the row's r
        def block_stat(statop, floor=None):
            SbE = self._bd_scaled_abs(lp.Bt, s.blocks, rE.blocks)
            SdE = self._bd_scaled_abs(lp.Dt, s.blocks, rC.blocks)
            SF = lp.F.abs() * rE.link[None, :, None] * s.blocks[:, None, :]
            SG = lp.G.abs() * rC.link[None, :, None] * s.blocks[:, None, :]
            if statop == "max":
                return torch.maximum(
                    torch.maximum(SbE.amax(-1), SdE.amax(-1)),
                    torch.maximum(_cstat(SF, "max"), _cstat(SG, "max")))
            fl = floor[:, :, None]
            mn = torch.minimum(
                torch.where(SbE > fl, SbE, _INF).amin(-1),
                torch.where(SdE > fl, SdE, _INF).amin(-1))
            return torch.minimum(
                mn, torch.minimum(_cstat(SF, "min", floor),
                                  _cstat(SG, "min", floor)))

        if op == "max":
            return XVec(first_stat("max"), block_stat("max"))
        ffl = _MIN_REL_FLOOR * first_stat("max")
        bfl = _MIN_REL_FLOOR * block_stat("max")
        return XVec(first_stat("min", ffl), block_stat("min", bfl))

    def apply(self, s, rE, rC) -> SparseArrowheadLP:
        lp = self.lp

        def scaled(ell, r_rows, s_cols):
            return Ell(ell.val * r_rows[:, :, None] * _gather_cols(s_cols,
                                                                    ell),
                       ell.col)

        kw = dict(
            c0=lp.c0 * s.first, cN=lp.cN * s.blocks,
            A0=lp.A0 * rE.first[:, None] * s.first[None, :],
            b0=lp.b0 * rE.first,
            C0=lp.C0 * rC.first[:, None] * s.first[None, :],
            A=lp.A * rE.blocks[:, :, None] * s.first[None, None, :],
            B=scaled(lp.B, rE.blocks, s.blocks),
            Bt=scaled(lp.Bt, s.blocks, rE.blocks),
            bN=lp.bN * rE.blocks,
            C=lp.C * rC.blocks[:, :, None] * s.first[None, None, :],
            D=scaled(lp.D, rC.blocks, s.blocks),
            Dt=scaled(lp.Dt, s.blocks, rC.blocks),
            F0=lp.F0 * rE.link[:, None] * s.first[None, :],
            F=lp.F * rE.link[None, :, None] * s.blocks[:, None, :],
            bl=lp.bl * rE.link,
            G0=lp.G0 * rC.link[:, None] * s.first[None, :],
            G=lp.G * rC.link[None, :, None] * s.blocks[:, None, :],
            clow0=lp.clow0 * rC.first, cupp0=lp.cupp0 * rC.first,
            clowN=lp.clowN * rC.blocks, cuppN=lp.cuppN * rC.blocks,
            clowl=lp.clowl * rC.link, cuppl=lp.cuppl * rC.link,
            xlow0=lp.xlow0 / s.first, xupp0=lp.xupp0 / s.first,
            xlowN=lp.xlowN / s.blocks, xuppN=lp.xuppN / s.blocks,
        )
        for f in dataclasses.fields(lp):
            kw.setdefault(f.name, getattr(lp, f.name))
        return SparseArrowheadLP(**kw)


def _view(lp):
    if isinstance(lp, ArrowheadLP):
        return _ArrowView(lp)
    if isinstance(lp, SparseArrowheadLP):
        return _SparseEllView(lp)
    raise TypeError(f"scaling supports ArrowheadLP and SparseArrowheadLP, "
                    f"got {type(lp).__name__}")


# ======================================================================
# Scalers
# ======================================================================

class _ScalerBase:
    """Holds factors after scale(); provides unscaling of all quantities."""

    def __init__(self):
        self.s = self.rE = self.rC = None

    def scale(self, lp):
        view = _view(lp)
        s, rE, rC = self._compute(view)
        self.s = tmap(lambda v: _safe(_pow2_round(_safe(v))), s)
        self.rE = tmap(lambda v: _safe(_pow2_round(_safe(v))), rE)
        self.rC = tmap(lambda v: _safe(_pow2_round(_safe(v))), rC)
        return view.apply(self.s, self.rE, self.rC)

    # solution unscaling (reference Scaler.hpp:38-53 unscale_variables) ---
    def unscale_x(self, x):
        return tmap(lambda sv, xv: sv * xv, self.s, x)

    def unscale_y(self, y):
        return tmap(lambda rv, yv: rv * yv, self.rE, y)

    def unscale_z(self, z):
        return tmap(lambda rv, zv: rv * zv, self.rC, z)

    def unscale_slack(self, sl):
        return tmap(lambda rv, v: v / rv, self.rC, sl)

    def unscale_bound_dual(self, g):
        return tmap(lambda sv, v: v / sv, self.s, g)


class EquilibriumScaler(_ScalerBase):
    """inf-norm scaling: rows by 1/rowmax, then cols by 1/colmax
    (reference EquilibriumScaler)."""

    def _compute(self, view):
        s, rE, rC = view.ones()

        def inv(f, m):
            return torch.where(m > 0, f / torch.clamp_min(m, 1e-300), f)

        mE, mC = view.row_stats(s, rE, rC, "max")
        rE = tmap(inv, rE, mE)
        rC = tmap(inv, rC, mC)
        cm = view.col_stats(s, rE, rC, "max")
        s = tmap(inv, s, cm)
        return s, rE, rC


def make_scaler(kind: ScalerType) -> _ScalerBase:
    if kind == ScalerType.EQUILIBRIUM:
        return EquilibriumScaler()
    if kind in (ScalerType.GEOMETRIC_MEAN,
                ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM,
                ScalerType.CURTIS_REID):
        raise NotImplementedError(
            f"{kind.name} scaling is not ported yet; use EQUILIBRIUM")
    raise ValueError(f"no scaler for {kind}")
