r"""Problem scaling: geometric-mean, equilibrium (inf-norm), Curtis-Reid.

Counterpart of `pips_ipmpp_tpu/scale/scaling.py` (reference
Core/Preprocessing/Scaler.cpp, GeometricMeanScaler.C:21-171,
EquilibriumScaler, CurtisReidScaler.cpp:318) for the flat DenseLP, the
batched-dense ArrowheadLP, the ELL SparseArrowheadLP and the
BucketedArrowheadLP.  Scaling runs
once at setup, off the IPM hot path, on the LP's tensors.

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

from pips_ipmpp_tpu_torch.core.bucketed import BucketedArrowheadLP
from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP, DenseLP
from pips_ipmpp_tpu_torch.core.options import ScalerType
from pips_ipmpp_tpu_torch.core.sparse import Ell, SparseArrowheadLP
from pips_ipmpp_tpu_torch.core.spaces import RVec, XVec, leaves, tmap

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


class _DenseView:
    """Stats/apply adapter for DenseLP."""

    def __init__(self, lp: DenseLP):
        self.lp = lp

    def ones(self):
        lp = self.lp
        one = torch.ones_like
        return one(lp.c), one(lp.b), one(lp.clow)

    def row_stats(self, s, rE, rC, op):
        lp = self.lp
        SA = lp.A.abs() * rE[:, None] * s[None, :]
        SC = lp.C.abs() * rC[:, None] * s[None, :]
        return _rstat(SA, op), _rstat(SC, op)

    def col_stats(self, s, rE, rC, op):
        lp = self.lp
        SA = lp.A.abs() * rE[:, None] * s[None, :]
        SC = lp.C.abs() * rC[:, None] * s[None, :]
        if op == "max":
            return torch.maximum(_cstat(SA, "max"), _cstat(SC, "max"))
        # min over the FULL column (A and C parts share variables):
        # floor from the combined column max
        fl = _MIN_REL_FLOOR * torch.maximum(_cstat(SA, "max"),
                                            _cstat(SC, "max"))
        return torch.minimum(_cstat(SA, "min", fl), _cstat(SC, "min", fl))

    def apply(self, s, rE, rC) -> DenseLP:
        lp = self.lp
        return DenseLP(
            c=lp.c * s,
            A=lp.A * rE[:, None] * s[None, :], b=lp.b * rE,
            C=lp.C * rC[:, None] * s[None, :],
            iclow=lp.iclow, clow=lp.clow * rC,
            icupp=lp.icupp, cupp=lp.cupp * rC,
            ixlow=lp.ixlow, xlow=lp.xlow / s,
            ixupp=lp.ixupp, xupp=lp.xupp / s,
        )


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


class _BucketedView:
    """Stats/apply adapter for BucketedArrowheadLP: per-bucket _ArrowViews
    with first-stage and link statistics aggregated across buckets.  The
    scale factors carry `blocks` as a TUPLE of per-bucket tensors (the
    bucketed XVec/RVec layout), so the unscaling maps work unchanged.
    Min-statistic floors are per bucket (each bucket's own row/col max),
    as in the JAX package: they affect the factors' quality, never the
    exactness of the pow2 scaling."""

    def __init__(self, lp: BucketedArrowheadLP):
        self.lp = lp
        self.views = [_ArrowView(b) for b in lp.buckets]

    @staticmethod
    def _split(s, rE, rC, b):
        return (XVec(s.first, s.blocks[b]),
                RVec(rE.first, rE.blocks[b], rE.link),
                RVec(rC.first, rC.blocks[b], rC.link))

    def ones(self):
        per = [v.ones() for v in self.views]
        s0, rE0, rC0 = per[0]
        return (XVec(s0.first, tuple(p[0].blocks for p in per)),
                RVec(rE0.first, tuple(p[1].blocks for p in per), rE0.link),
                RVec(rC0.first, tuple(p[2].blocks for p in per), rC0.link))

    def row_stats(self, s, rE, rC, op):
        red = _red(op)
        per = [v.row_stats(*self._split(s, rE, rC, b), op)
               for b, v in enumerate(self.views)]

        def combine(idx):
            stats = [p[idx] for p in per]
            link = stats[0].link
            for st in stats[1:]:
                link = red(link, st.link)   # every bucket's F/G strips
            # the first stage's rows (A0/C0) are shared: identical
            return RVec(stats[0].first, tuple(st.blocks for st in stats),
                        link)

        return combine(0), combine(1)

    def col_stats(self, s, rE, rC, op):
        red = _red(op)
        per = [v.col_stats(*self._split(s, rE, rC, b), op)
               for b, v in enumerate(self.views)]
        first = per[0].first
        for st in per[1:]:                  # each bucket's A/C borders
            first = red(first, st.first)
        return XVec(first, tuple(st.blocks for st in per))

    def apply(self, s, rE, rC) -> BucketedArrowheadLP:
        return BucketedArrowheadLP(
            tuple(v.apply(*self._split(s, rE, rC, b))
                  for b, v in enumerate(self.views)), self.lp.placement)


def _view(lp):
    if isinstance(lp, DenseLP):
        return _DenseView(lp)
    if isinstance(lp, ArrowheadLP):
        return _ArrowView(lp)
    if isinstance(lp, SparseArrowheadLP):
        return _SparseEllView(lp)
    if isinstance(lp, BucketedArrowheadLP):
        return _BucketedView(lp)
    raise TypeError(f"scaling supports DenseLP, ArrowheadLP, "
                    f"SparseArrowheadLP and BucketedArrowheadLP, "
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


def _inv(f, m):
    return torch.where(m > 0, f / torch.clamp_min(m, 1e-300), f)


class EquilibriumScaler(_ScalerBase):
    """inf-norm scaling: rows by 1/rowmax, then cols by 1/colmax
    (reference EquilibriumScaler)."""

    def _compute(self, view):
        s, rE, rC = view.ones()
        mE, mC = view.row_stats(s, rE, rC, "max")
        rE = tmap(_inv, rE, mE)
        rC = tmap(_inv, rC, mC)
        cm = view.col_stats(s, rE, rC, "max")
        s = tmap(_inv, s, cm)
        return s, rE, rC


class GeometricMeanScaler(_ScalerBase):
    """sqrt(max*min) scaling iterated (reference GeometricMeanScaler.C:21-171),
    optionally followed by an equilibrium pass."""

    def __init__(self, max_iters: int = 10, with_equilibrium: bool = False):
        super().__init__()
        self.max_iters = max_iters
        self.with_equilibrium = with_equilibrium

    def _compute(self, view):
        s, rE, rC = view.ones()

        def geo(mx, mn):
            # empty rows/cols stay unscaled
            return torch.where(
                mx > 0,
                1.0 / torch.sqrt(torch.clamp_min(
                    mx * torch.where(torch.isfinite(mn), mn, mx), 1e-300)),
                1.0)

        def step(f, mx, mn):
            return f * _safe(geo(mx, mn))

        for _ in range(self.max_iters):
            mxE, mxC = view.row_stats(s, rE, rC, "max")
            mnE, mnC = view.row_stats(s, rE, rC, "min")
            rE = tmap(step, rE, mxE, mnE)
            rC = tmap(step, rC, mxC, mnC)
            cmx = view.col_stats(s, rE, rC, "max")
            cmn = view.col_stats(s, rE, rC, "min")
            s = tmap(step, s, cmx, cmn)
        if self.with_equilibrium:
            mxE, mxC = view.row_stats(s, rE, rC, "max")
            rE = tmap(_inv, rE, mxE)
            rC = tmap(_inv, rC, mxC)
            cm = view.col_stats(s, rE, rC, "max")
            s = tmap(_inv, s, cm)
        return s, rE, rC


class CurtisReidScaler(_ScalerBase):
    """Curtis-Reid least-squares scaling: minimize
    sum_{a_ij != 0} (log2|a_ij| + rho_i + gamma_j)^2 via CG on the normal
    equations over log2 factors (reference CurtisReidScaler.cpp:318).
    Sparse (ELL) LPs raise, as in the JAX package."""

    def __init__(self, cg_iters: int = 30):
        super().__init__()
        self.cg_iters = cg_iters

    def _compute(self, view):
        CLAMP = 30.0   # factors within 2^+-30

        def f(v):
            return torch.ldexp(torch.ones_like(v), torch.clamp(
                torch.round(v), -CLAMP, CLAMP).to(torch.int32))

        gamma, rhoE, rhoC = self.log2_factors(view)
        return tmap(f, gamma), tmap(f, rhoE), tmap(f, rhoC)

    def log2_factors(self, view):
        """The log2 column and row factors (gamma, rhoE, rhoC) before
        rounding.  K is singular along the shift of every row by +c and
        every column by -c, and in floating point the right-hand side is
        not quite orthogonal to it, so the CG drifts along that shift by
        an amount that turns on rounding (ROADMAP.md, F6): rho_i + gamma_j
        is the solution, the split between them is not."""
        if isinstance(view, _SparseEllView):
            raise NotImplementedError(
                "Curtis-Reid scaling is not implemented for ELL sparse "
                "problems; use EQUILIBRIUM or GEOMETRIC_MEAN")
        lp = view.lp

        def logabs(M):
            m = M.abs()
            return (torch.where(m > 0, torch.log2(torch.clamp_min(m, 1e-300)),
                                0.0),
                    (m > 0).to(M.dtype))

        if isinstance(view, _BucketedView):
            # per-bucket log/pattern tables; the first-stage (A0/C0/F0/G0)
            # and linking aggregates counted ONCE from bucket 0's shared
            # copies, border and diagonal contributions summed over buckets
            tabs = []
            for bk in lp.buckets:
                LBb, PBb = {}, {}
                for name in ("A0", "C0", "A", "B", "C", "D", "F0", "F",
                             "G0", "G"):
                    LBb[name], PBb[name] = logabs(getattr(bk, name))
                tabs.append((LBb, PBb))

            def build(which, t_sel):
                p0, pb, pd, pl0, plb = (("A0", "A", "B", "F0", "F")
                                        if which == "E"
                                        else ("C0", "C", "D", "G0", "G"))
                tab0 = tabs[0][t_sel]
                first = tab0[p0].sum(-1)
                link = tab0[pl0].sum(-1)
                blocks = []
                for tab in tabs:
                    tb = tab[t_sel]
                    blocks.append(tb[pb].sum(-1) + tb[pd].sum(-1))
                    link = link + tb[plb].sum((0, 2))
                return RVec(first, tuple(blocks), link)

            sigmaE, cntE = build("E", 0), build("E", 1)
            sigmaC, cntC = build("C", 0), build("C", 1)

            def cols_build(t_sel):
                tab0 = tabs[0][t_sel]
                first = (tab0["A0"].sum(0) + tab0["C0"].sum(0)
                         + tab0["F0"].sum(0) + tab0["G0"].sum(0))
                blocks = []
                for tab in tabs:
                    tb = tab[t_sel]
                    first = first + (tb["A"].sum((0, 1))
                                     + tb["C"].sum((0, 1)))
                    blocks.append(tb["B"].sum(1) + tb["D"].sum(1)
                                  + tb["F"].sum(1) + tb["G"].sum(1))
                return XVec(first, tuple(blocks))

            sigmacol, cntcol = cols_build(0), cols_build(1)

            def Pg(g: XVec):
                PB0 = tabs[0][1]
                firstE = PB0["A0"] @ g.first
                firstC = PB0["C0"] @ g.first
                linkE = PB0["F0"] @ g.first
                linkC = PB0["G0"] @ g.first
                blkE, blkC = [], []
                for b, (_, Pb) in enumerate(tabs):
                    gb = g.blocks[b]
                    blkE.append(torch.einsum("imk,k->im", Pb["A"], g.first)
                                + torch.einsum("imn,in->im", Pb["B"], gb))
                    blkC.append(torch.einsum("imk,k->im", Pb["C"], g.first)
                                + torch.einsum("imn,in->im", Pb["D"], gb))
                    linkE = linkE + torch.einsum("iln,in->l", Pb["F"], gb)
                    linkC = linkC + torch.einsum("iln,in->l", Pb["G"], gb)
                return (RVec(firstE, tuple(blkE), linkE),
                        RVec(firstC, tuple(blkC), linkC))

            def PTr(rE_: RVec, rC_: RVec):
                PB0 = tabs[0][1]
                first = (PB0["A0"].T @ rE_.first + PB0["C0"].T @ rC_.first
                         + PB0["F0"].T @ rE_.link + PB0["G0"].T @ rC_.link)
                blocks = []
                for b, (_, Pb) in enumerate(tabs):
                    first = first + (
                        torch.einsum("imk,im->k", Pb["A"], rE_.blocks[b])
                        + torch.einsum("imk,im->k", Pb["C"], rC_.blocks[b]))
                    blocks.append(
                        torch.einsum("imn,im->in", Pb["B"], rE_.blocks[b])
                        + torch.einsum("imn,im->in", Pb["D"], rC_.blocks[b])
                        + torch.einsum("iln,l->in", Pb["F"], rE_.link)
                        + torch.einsum("iln,l->in", Pb["G"], rC_.link))
                return XVec(first, tuple(blocks))
        elif isinstance(view, _DenseView):
            LA, PA = logabs(lp.A)
            LC, PC = logabs(lp.C)
            sigmaE, sigmaC = LA.sum(-1), LC.sum(-1)
            sigmacol = LA.sum(-2) + LC.sum(-2)
            cntE, cntC = PA.sum(-1), PC.sum(-1)
            cntcol = PA.sum(-2) + PC.sum(-2)

            def Pg(g):           # pattern @ gamma -> rows
                return PA @ g, PC @ g

            def PTr(rE_, rC_):   # pattern' @ rho -> cols
                return PA.T @ rE_ + PC.T @ rC_
        else:
            LB, PB = {}, {}
            for name in ("A0", "C0", "A", "B", "C", "D", "F0", "F",
                         "G0", "G"):
                LB[name], PB[name] = logabs(getattr(lp, name))

            def rows_of(p0, pb, pd, pl0, plb):
                return RVec(p0.sum(-1), pb.sum(-1) + pd.sum(-1),
                            pl0.sum(-1) + plb.sum((0, 2)))

            sigmaE = rows_of(LB["A0"], LB["A"], LB["B"], LB["F0"], LB["F"])
            sigmaC = rows_of(LB["C0"], LB["C"], LB["D"], LB["G0"], LB["G"])
            cntE = rows_of(PB["A0"], PB["A"], PB["B"], PB["F0"], PB["F"])
            cntC = rows_of(PB["C0"], PB["C"], PB["D"], PB["G0"], PB["G"])

            def cols_of(t):
                first = (t["A0"].sum(0) + t["C0"].sum(0)
                         + t["F0"].sum(0) + t["G0"].sum(0)
                         + t["A"].sum((0, 1)) + t["C"].sum((0, 1)))
                blocks = (t["B"].sum(1) + t["D"].sum(1)
                          + t["F"].sum(1) + t["G"].sum(1))
                return XVec(first, blocks)

            sigmacol = cols_of(LB)
            cntcol = cols_of(PB)

            def Pg(g: XVec):
                first = PB["A0"] @ g.first
                blocks = (torch.einsum("imk,k->im", PB["A"], g.first)
                          + torch.einsum("imn,in->im", PB["B"], g.blocks))
                link = PB["F0"] @ g.first + torch.einsum(
                    "iln,in->l", PB["F"], g.blocks)
                firstC = PB["C0"] @ g.first
                blocksC = (torch.einsum("imk,k->im", PB["C"], g.first)
                           + torch.einsum("imn,in->im", PB["D"], g.blocks))
                linkC = PB["G0"] @ g.first + torch.einsum(
                    "iln,in->l", PB["G"], g.blocks)
                return RVec(first, blocks, link), RVec(firstC, blocksC, linkC)

            def PTr(rE_: RVec, rC_: RVec):
                first = (PB["A0"].T @ rE_.first + PB["C0"].T @ rC_.first
                         + PB["F0"].T @ rE_.link + PB["G0"].T @ rC_.link
                         + torch.einsum("imk,im->k", PB["A"], rE_.blocks)
                         + torch.einsum("imk,im->k", PB["C"], rC_.blocks))
                blocks = (torch.einsum("imn,im->in", PB["B"], rE_.blocks)
                          + torch.einsum("imn,im->in", PB["D"], rC_.blocks)
                          + torch.einsum("iln,l->in", PB["F"], rE_.link)
                          + torch.einsum("iln,l->in", PB["G"], rC_.link))
                return XVec(first, blocks)

        # CG on K u = rhs, u = (rhoE, rhoC, gamma),
        # K = [[diag(cnt_rows), P], [P', diag(cnt_cols)]]
        rhs = (tmap(torch.neg, sigmaE), tmap(torch.neg, sigmaC),
               tmap(torch.neg, sigmacol))

        def Kmul(u):
            uE, uC, g = u
            PgE, PgC = Pg(g)
            outE = tmap(lambda c, r, p: c * r + p, cntE, uE, PgE)
            outC = tmap(lambda c, r, p: c * r + p, cntC, uC, PgC)
            outg = tmap(lambda c, gg, p: c * gg + p, cntcol, g, PTr(uE, uC))
            return outE, outC, outg

        def dot(a, b):
            return sum(torch.dot(x.reshape(-1), y.reshape(-1))
                       for x, y in zip(leaves(a), leaves(b)))

        # K is positive SEMI-definite (the constant row-shift/col-shift
        # direction is a null space), so CG iterates can drift along null
        # directions once rounding mixes them in: keep the iterate with
        # the BEST residual, and clamp the final log2 factors
        u = tmap(torch.zeros_like, rhs)
        r = rhs
        p = r
        rs = dot(r, r)
        best_u, best_rs = u, rs
        for _ in range(self.cg_iters):
            Kp = Kmul(p)
            denom = dot(p, Kp)
            alpha = torch.where(denom > 0,
                                rs / torch.clamp_min(denom, 1e-300), 0.0)
            u = tmap(lambda uu, pp: uu + alpha * pp, u, p)
            r = tmap(lambda rr, kp: rr - alpha * kp, r, Kp)
            rs_new = dot(r, r)
            improved = rs_new < best_rs
            best_u = tmap(lambda b, c: torch.where(improved, c, b),
                          best_u, u)
            best_rs = torch.where(improved, rs_new, best_rs)
            beta = rs_new / torch.clamp_min(rs, 1e-300)
            p = tmap(lambda rr, pp: rr + beta * pp, r, p)
            rs = rs_new

        rhoE, rhoC, gamma = best_u
        return gamma, rhoE, rhoC


def make_scaler(kind: ScalerType) -> _ScalerBase:
    if kind == ScalerType.EQUILIBRIUM:
        return EquilibriumScaler()
    if kind == ScalerType.GEOMETRIC_MEAN:
        return GeometricMeanScaler()
    if kind == ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM:
        return GeometricMeanScaler(with_equilibrium=True)
    if kind == ScalerType.CURTIS_REID:
        return CurtisReidScaler()
    raise ValueError(f"no scaler for {kind}")
