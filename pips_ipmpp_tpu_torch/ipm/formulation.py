r"""Primal-dual IPM formulation: iterate, residuals, KKT reduction, recovery.

Counterpart of `pips_ipmpp_tpu/ipm/formulation.py` (see its docstring for
the derivation).  Backend-generic: every quantity is a tree of XVec/RVec
space vectors; elementwise work is `tmap`, reductions go through
core.spaces, and matrix-vector products go through a backend object.

Over a stack of LPs (`core/lp.py::stack_lps`) every vector carries the
leading batch axis, the reductions (mu, norms, step bounds, the blocking
pair) give one value per LP, and every per-LP scalar meets a vector
through `spaces.bcast`.

Augmented system in (dx, yhat, zhat) with yhat=-dy, zhat=-dz:

    [ Dx+dp    A'      C'        ] [dx  ]   [ -rhat_x ]
    [ A       -dd I    0         ] [yhat] = [ -rA     ]
    [ C        0      -(Om+dd I) ] [zhat]   [ -rhat_z ]

    Dx    = ixlow*gamma/v + ixupp*phi/w
    Ominv = iclow*lambda/t + icupp*pi/u,  Om = 1/Ominv
    rhat_x  = rL + ixlow*(rG + gamma*rv)/v - ixupp*(rP + phi*rw)/w
    rbar_z  = rz + iclow*(rLam + lambda*rt)/t - icupp*(rPi + pi*ru)/u
    rhat_z  = rC + Om * rbar_z
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pips_ipmpp_tpu_torch.core import spaces
from pips_ipmpp_tpu_torch.core.spaces import bcast, tmap

_INF = float("inf")


@dataclass
class Iterate:
    """The 12 iterate vectors (reference Variables.h:52-67)."""
    x: object          # x-space
    s: object          # ineq-row space
    y: object          # eq-row space
    z: object          # ineq-row space
    v: object          # x-space  (x - xlow)
    w: object          # x-space  (xupp - x)
    t: object          # ineq     (s - clow)
    u: object          # ineq     (cupp - s)
    gamma: object      # x-space  dual of v
    phi: object        # x-space  dual of w
    lam: object        # ineq     dual of t
    pi: object         # ineq     dual of u


@dataclass
class Bounds:
    """Problem bound data in generic spaces (masks are 0/1 floats)."""
    c: object
    b: object
    ixlow: object
    xlow: object
    ixupp: object
    xupp: object
    iclow: object
    clow: object
    icupp: object
    cupp: object


@dataclass
class Residuals:
    """KKT residuals (reference Residuals.h:76-87)."""
    rL: object
    rA: object
    rC: object
    rz: object
    rv: object
    rw: object
    rt: object
    ru: object


@dataclass
class CompRhs:
    """Complementarity right-hand sides for one Newton solve."""
    rG: object         # pairs (v, gamma)
    rP: object         # pairs (w, phi)
    rLam: object       # pairs (t, lam)
    rPi: object        # pairs (u, pi)


_PRIMAL = ("x", "s", "v", "w", "t", "u")
_DUAL = ("y", "z", "gamma", "phi", "lam", "pi")


# ======================================================================
# Residuals & merit quantities
# ======================================================================

def compute_residuals(be, it: Iterate) -> Residuals:
    """Evaluate KKT residuals (reference Residuals::evaluate)."""
    bd = be.bounds
    Ax = be.Ax(it.x)
    Cx = be.Cx(it.x)
    ATy = be.ATy(it.y)
    CTz = be.CTz(it.z)
    rL = tmap(lambda c, a, cz, g, p: c - a - cz - g + p,
              bd.c, ATy, CTz, it.gamma, it.phi)
    rA = tmap(lambda ax, b: ax - b, Ax, bd.b)
    rC = tmap(lambda cx, s: cx - s, Cx, it.s)
    rz = tmap(lambda z, l, p: z - l + p, it.z, it.lam, it.pi)
    rv = tmap(lambda m, x, lo, v: m * (x - lo - v), bd.ixlow, it.x, bd.xlow,
              it.v)
    rw = tmap(lambda m, x, up, w: m * (up - x - w), bd.ixupp, it.x, bd.xupp,
              it.w)
    rt = tmap(lambda m, s, lo, t: m * (s - lo - t), bd.iclow, it.s, bd.clow,
              it.t)
    ru = tmap(lambda m, s, up, u: m * (up - s - u), bd.icupp, it.s, bd.cupp,
              it.u)
    return Residuals(rL, rA, rC, rz, rv, rw, rt, ru)


def residual_norm(res: Residuals) -> torch.Tensor:
    """inf-norm over all residuals."""
    return spaces.norm_inf(res)


def duality_gap(be, it: Iterate) -> torch.Tensor:
    """Complementarity gap v'gamma + w'phi + t'lambda + u'pi."""
    return (spaces.dot(it.v, it.gamma) + spaces.dot(it.w, it.phi)
            + spaces.dot(it.t, it.lam) + spaces.dot(it.u, it.pi))


def mu(be, it: Iterate) -> torch.Tensor:
    """Average complementarity (reference Variables::mu)."""
    return duality_gap(be, it) / be.num_bound_pairs


def mu_after_step(be, it: Iterate, d: Iterate, alpha_p, alpha_d):
    """mu at (it + alpha_p*primal, alpha_d*dual) without forming the trial
    point (reference Variables::mustep_pd)."""
    def pair(val, dval, dual, ddual):
        return spaces.dot(
            tmap(lambda a, b: a + bcast(alpha_p, a) * b, val, dval),
            tmap(lambda a, b: a + bcast(alpha_d, a) * b, dual, ddual))

    gap = (pair(it.v, d.v, it.gamma, d.gamma) + pair(it.w, d.w, it.phi, d.phi)
           + pair(it.t, d.t, it.lam, d.lam) + pair(it.u, d.u, it.pi, d.pi))
    return gap / be.num_bound_pairs


# ======================================================================
# Diagonals & RHS assembly for the augmented system
# ======================================================================

def kkt_diagonals(be, it: Iterate):
    """Dx (x-space) and Ominv (ineq-row space); reference
    LinearSystem::computeDiagonals."""
    bd = be.bounds
    Dx = tmap(lambda ml, g, v, mu_, p, w: ml * g / v + mu_ * p / w,
              bd.ixlow, it.gamma, it.v, bd.ixupp, it.phi, it.w)
    Ominv = tmap(lambda ml, l, t, mu_, p, u: ml * l / t + mu_ * p / u,
                 bd.iclow, it.lam, it.t, bd.icupp, it.pi, it.u)
    return Dx, Ominv


def comp_rhs_affine(be, it: Iterate) -> CompRhs:
    """Affine (predictor) complementarity rhs: drive pair products to 0."""
    bd = be.bounds
    return CompRhs(
        rG=tmap(lambda m, a, b: m * a * b, bd.ixlow, it.v, it.gamma),
        rP=tmap(lambda m, a, b: m * a * b, bd.ixupp, it.w, it.phi),
        rLam=tmap(lambda m, a, b: m * a * b, bd.iclow, it.t, it.lam),
        rPi=tmap(lambda m, a, b: m * a * b, bd.icupp, it.u, it.pi),
    )


def comp_rhs_corrector(be, it: Iterate, d_aff: Iterate, sigma_mu) -> CompRhs:
    """Mehrotra corrector rhs: v*g + dv_aff*dg_aff - sigma*mu."""
    def mk(mask, val, dual, dval, ddual):
        return tmap(lambda m, a, b, da, db:
                    m * (a * b + da * db - bcast(sigma_mu, a)), mask, val,
                    dual, dval, ddual)
    bd = be.bounds
    return CompRhs(
        rG=mk(bd.ixlow, it.v, it.gamma, d_aff.v, d_aff.gamma),
        rP=mk(bd.ixupp, it.w, it.phi, d_aff.w, d_aff.phi),
        rLam=mk(bd.iclow, it.t, it.lam, d_aff.t, d_aff.lam),
        rPi=mk(bd.icupp, it.u, it.pi, d_aff.u, d_aff.pi),
    )


def comp_rhs_gondzio(be, it: Iterate, d: Iterate, alpha_p, alpha_d,
                     sigma_mu, beta_min, beta_max) -> CompRhs:
    """Gondzio centrality-corrector rhs (reference
    InteriorPointMethod::compute_gondzio_corrector + project_r3).

    Trial products p = (val + a_p*dval)*(dual + a_d*ddual) are projected onto
    the target box [beta_min*sigma_mu, beta_max*sigma_mu]; the corrector rhs
    is the (clamped) violation."""
    lo = beta_min * sigma_mu
    hi = beta_max * sigma_mu

    def mk(mask, val, dual, dval, ddual):
        def f(m, a, b, da, db):
            p = (a + bcast(alpha_p, a) * da) * (b + bcast(alpha_d, b) * db)
            lo_, hi_ = bcast(lo, p), bcast(hi, p)
            viol = p - torch.clamp(p, min=lo_, max=hi_)
            # clamp excessive positive violation (reference caps at hi)
            return m * torch.minimum(viol, hi_)
        return tmap(f, mask, val, dual, dval, ddual)

    bd = be.bounds
    return CompRhs(
        rG=mk(bd.ixlow, it.v, it.gamma, d.v, d.gamma),
        rP=mk(bd.ixupp, it.w, it.phi, d.w, d.phi),
        rLam=mk(bd.iclow, it.t, it.lam, d.t, d.lam),
        rPi=mk(bd.icupp, it.u, it.pi, d.u, d.pi),
    )


@dataclass
class ReducedRhs:
    """RHS of the augmented system + cached rbar_z for ds recovery."""
    rhat_x: object
    rA: object
    rhat_z: object
    rbar_z: object


def assemble_reduced_rhs(be, it: Iterate, res: Residuals, comp: CompRhs,
                         Ominv) -> ReducedRhs:
    """Block-eliminate bound/slack rows into the compressed (x,y,z) RHS
    (reference LinearSystem::solve elimination)."""
    bd = be.bounds
    rhat_x = tmap(lambda rl, ml, rg, g, rv, v, mu_, rp, p, rw, w:
                  rl + ml * (rg + g * rv) / v - mu_ * (rp + p * rw) / w,
                  res.rL, bd.ixlow, comp.rG, it.gamma, res.rv, it.v,
                  bd.ixupp, comp.rP, it.phi, res.rw, it.w)
    rbar_z = tmap(lambda rz, ml, rlam, l, rt, t, mu_, rpi, p, ru, u:
                  rz + ml * (rlam + l * rt) / t - mu_ * (rpi + p * ru) / u,
                  res.rz, bd.iclow, comp.rLam, it.lam, res.rt, it.t,
                  bd.icupp, comp.rPi, it.pi, res.ru, it.u)
    rhat_z = tmap(lambda rc, oi, rb: rc + rb / oi, res.rC, Ominv, rbar_z)
    return ReducedRhs(rhat_x=rhat_x, rA=res.rA, rhat_z=rhat_z, rbar_z=rbar_z)


def recover_step(be, it: Iterate, res: Residuals, comp: CompRhs, Ominv,
                 rhs: ReducedRhs, dx, dy, dz) -> Iterate:
    """Recover all 12 step components from (dx, dy, dz)."""
    bd = be.bounds
    ds = tmap(lambda oi, dz_, rb: -(dz_ + rb) / oi, Ominv, dz, rhs.rbar_z)
    dv = tmap(lambda m, a, b: m * (a + b), bd.ixlow, dx, res.rv)
    dw = tmap(lambda m, a, b: m * (b - a), bd.ixupp, dx, res.rw)
    dt = tmap(lambda m, a, b: m * (a + b), bd.iclow, ds, res.rt)
    du = tmap(lambda m, a, b: m * (b - a), bd.icupp, ds, res.ru)
    dgamma = tmap(lambda m, rg, g, dv_, v: -m * (rg + g * dv_) / v,
                  bd.ixlow, comp.rG, it.gamma, dv, it.v)
    dphi = tmap(lambda m, rp, p, dw_, w: -m * (rp + p * dw_) / w,
                bd.ixupp, comp.rP, it.phi, dw, it.w)
    dlam = tmap(lambda m, rl, l, dt_, t: -m * (rl + l * dt_) / t,
                bd.iclow, comp.rLam, it.lam, dt, it.t)
    dpi = tmap(lambda m, rp, p, du_, u: -m * (rp + p * du_) / u,
               bd.icupp, comp.rPi, it.pi, du, it.u)
    return Iterate(x=dx, s=ds, y=dy, z=dz, v=dv, w=dw, t=dt, u=du,
                   gamma=dgamma, phi=dphi, lam=dlam, pi=dpi)


# ======================================================================
# Step bounds (fraction to boundary)
# ======================================================================

def _ratio(m, a, da):
    """-a/da where the pair is masked and decreasing, +inf elsewhere."""
    return torch.where((m > 0) & (da < 0),
                       -a / torch.where(da < 0, da, -1.0), _INF)


def _pair_stepbound(mask, val, dval):
    """Max alpha in (0,1] keeping val + alpha*dval >= 0 where mask=1."""
    return tmap(_ratio, mask, val, dval)


def step_bounds_pd(be, it: Iterate, d: Iterate):
    """Separate primal/dual max step lengths (reference
    Variables::stepbound_pd)."""
    bd = be.bounds
    primal = [
        _pair_stepbound(bd.ixlow, it.v, d.v),
        _pair_stepbound(bd.ixupp, it.w, d.w),
        _pair_stepbound(bd.iclow, it.t, d.t),
        _pair_stepbound(bd.icupp, it.u, d.u),
    ]
    dual = [
        _pair_stepbound(bd.ixlow, it.gamma, d.gamma),
        _pair_stepbound(bd.ixupp, it.phi, d.phi),
        _pair_stepbound(bd.iclow, it.lam, d.lam),
        _pair_stepbound(bd.icupp, it.pi, d.pi),
    ]
    a_p = torch.clamp(spaces.min_reduce(primal), max=1.0)
    a_d = torch.clamp(spaces.min_reduce(dual), max=1.0)
    return a_p, a_d


def find_blocking(be, it: Iterate, d: Iterate, primal: bool):
    """EXACT blocking-pair extraction (reference find_blocking_pd, the
    distributed minloc pair reduction).

    Returns (a_max, val_b, dval_b, partner_b, dpartner_b, blocking) where
    a_max = min(1, min ratio), (val_b, dval_b) are the blocking entry and
    its step, (partner_b, dpartner_b) the OTHER side of that pair, and
    `blocking` is False when no pair blocks below 1.

    Per-leaf masked argmin + take, then a leaf-chained select; ties go
    to the first index (torch.argmin and jnp.argmin agree on that) and to
    the earlier leaf.  Over a stack of LPs each LP has its own pair."""
    bd = be.bounds
    pairs = [
        (bd.ixlow, it.v, d.v, it.gamma, d.gamma),
        (bd.ixupp, it.w, d.w, it.phi, d.phi),
        (bd.iclow, it.t, d.t, it.lam, d.lam),
        (bd.icupp, it.u, d.u, it.pi, d.pi),
    ]
    if not primal:
        pairs = [(m, dual, ddual, val, dval)
                 for (m, val, dval, dual, ddual) in pairs]

    v0 = spaces.leaves(it.v)[0]
    nb = spaces.batch_ndim(it.v)
    batch = tuple(v0.shape[:nb])
    zero = torch.zeros(batch, dtype=v0.dtype, device=v0.device)
    best = (zero + _INF, zero, zero, zero, zero)

    for group in pairs:
        for (ml, al, dal, pl, dpl) in zip(*(spaces.leaves(t) for t in group)):
            if ml[(0,) * nb].numel() == 0:
                continue
            # gather, not indexing: indexing with a tensor would read the
            # index back
            r = _ratio(ml, al, dal).reshape(batch + (-1,))
            i = torch.argmin(r, dim=-1, keepdim=True)
            cand = tuple(t.reshape(batch + (-1,)).gather(-1, i)[..., 0]
                         for t in (r, al, dal, pl, dpl))
            take = cand[0] < best[0]
            best = tuple(torch.where(take, c, b) for c, b in zip(cand, best))

    ratio = best[0]
    a_max = torch.clamp(ratio, max=1.0)
    blocking = torch.isfinite(ratio) & (ratio < 1.0)
    return a_max, best[1], best[2], best[3], best[4], blocking


def step_bound_single(be, it: Iterate, d: Iterate):
    """One common step length (PRIMAL step mode)."""
    a_p, a_d = step_bounds_pd(be, it, d)
    a = torch.minimum(a_p, a_d)
    return a, a


def _combine(a: Iterate, b: Iterate, w_p, w_d) -> Iterate:
    """a + w_p * b on the primal components, a + w_d * b on the dual ones."""
    kw = {k: tmap(lambda x, y: x + bcast(w_p, x) * y, getattr(a, k),
                  getattr(b, k))
          for k in _PRIMAL}
    kw.update({k: tmap(lambda x, y: x + bcast(w_d, x) * y, getattr(a, k),
                       getattr(b, k))
               for k in _DUAL})
    return Iterate(**kw)


def add_weighted(d: Iterate, corr: Iterate, w_p, w_d) -> Iterate:
    """step.add(corrector, weight_primal, weight_dual): primal components
    scaled by w_p, dual components by w_d (reference Variables::add with
    separate weights, used by the Gondzio loop)."""
    return _combine(d, corr, w_p, w_d)


def take_step(it: Iterate, d: Iterate, alpha_p, alpha_d) -> Iterate:
    return _combine(it, d, alpha_p, alpha_d)


# ======================================================================
# Initial point
# ======================================================================

def initial_iterate(be, shift) -> Iterate:
    """Interior starting point: slacks/duals pushed to `shift` where masked,
    1/0 elsewhere (reference Variables::push_to_interior + Solver.cpp:16-31).

    x starts at the projection of 0 into [xlow+shift, xupp-shift] midpoints;
    s starts at the analogous center of the inequality-row bounds."""
    bd = be.bounds

    def center(mlo, lo, mup, up):
        def f(ml, l, mu_, u):
            both = (ml > 0) & (mu_ > 0)
            sh = bcast(shift, l)
            return torch.where(
                both, 0.5 * (l + u),
                torch.where(ml > 0, l + sh,
                            torch.where(mu_ > 0, u - sh, 0.0)))
        return tmap(f, mlo, lo, mup, up)

    x = center(bd.ixlow, bd.xlow, bd.ixupp, bd.xupp)
    s = center(bd.iclow, bd.clow, bd.icupp, bd.cupp)

    def gap(mask, sign_lo, val, bound):
        # max(shift, distance to bound) where masked, else 1
        def f(m, a, b):
            return torch.where(m > 0, torch.maximum(bcast(shift, a),
                                                    sign_lo * (a - b)), 1.0)
        return tmap(f, mask, val, bound)

    v = gap(bd.ixlow, +1.0, x, bd.xlow)
    w = gap(bd.ixupp, -1.0, x, bd.xupp)
    t = gap(bd.iclow, +1.0, s, bd.clow)
    u = gap(bd.icupp, -1.0, s, bd.cupp)

    def dual_init(mask):
        return tmap(lambda m: torch.where(m > 0, bcast(shift, m), 0.0), mask)

    return Iterate(
        x=x, s=s,
        y=spaces.zeros_like(bd.b),
        z=spaces.zeros_like(s),
        v=v, w=w, t=t, u=u,
        gamma=dual_init(bd.ixlow), phi=dual_init(bd.ixupp),
        lam=dual_init(bd.iclow), pi=dual_init(bd.icupp),
    )


def violation(be, it: Iterate) -> torch.Tensor:
    """Max violation of nonnegativity over masked pairs (for bound shifting,
    reference Variables::violation)."""
    bd = be.bounds
    neg = []
    for mask, val in ((bd.ixlow, it.v), (bd.ixupp, it.w),
                      (bd.iclow, it.t), (bd.icupp, it.u),
                      (bd.ixlow, it.gamma), (bd.ixupp, it.phi),
                      (bd.iclow, it.lam), (bd.icupp, it.pi)):
        neg.append(tmap(lambda m, a: torch.where(m > 0, a, _INF), mask, val))
    return torch.clamp(-spaces.min_reduce(neg), min=0.0)


def shift_bound_variables(be, it: Iterate, amount) -> Iterate:
    """Shift all masked slack/dual pairs into the interior by `amount`
    (reference Variables::shift_bound_variables)."""
    bd = be.bounds

    def sh(mask, val):
        return tmap(lambda m, a: a + m * bcast(amount, m), mask, val)

    return Iterate(
        x=it.x, s=it.s, y=it.y, z=it.z,
        v=sh(bd.ixlow, it.v), w=sh(bd.ixupp, it.w),
        t=sh(bd.iclow, it.t), u=sh(bd.icupp, it.u),
        gamma=sh(bd.ixlow, it.gamma), phi=sh(bd.ixupp, it.phi),
        lam=sh(bd.iclow, it.lam), pi=sh(bd.icupp, it.pi),
    )
