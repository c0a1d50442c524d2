"""Mehrotra predictor-corrector with Gondzio multiple centrality correctors.

Counterpart of `pips_ipmpp_tpu/ipm/mehrotra.py`: one call = one IPM
iteration (factorize + predictor solve + corrector solve + Gondzio loop +
step), after the reference's InteriorPointMethod
(Core/InteriorPointMethod/InteriorPointMethod.cpp).  The JAX package's
`lax.while_loop`/`lax.cond` are `control.dev_while`/`dev_cond`: eager in
the host loop, where each test reads its flag back, and conditional graph
nodes when the fused loop is captured.  Every quantity a decision reads,
the Gondzio loop's counters and flags included, is a device tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from pips_ipmpp_tpu_torch.core.options import Options, StepMode
from pips_ipmpp_tpu_torch.core.spaces import leaves, tmap
from pips_ipmpp_tpu_torch.ipm import formulation as F
from pips_ipmpp_tpu_torch.ipm.control import dev_cond, dev_while


@dataclass
class StepStats:
    mu: Any
    sigma: Any
    alpha_primal: Any
    alpha_dual: Any
    n_gondzio: Any
    factor_ok: Any


def _solve_dir(be, it, res, comp, Ominv, fac, opts: Options):
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    dx, dy, dz = be.solve_reduced(fac, rhs, opts.refinement_steps)
    return F.recover_step(be, it, res, comp, Ominv, rhs, dx, dy, dz)


def _alphas(be, it, d, opts: Options):
    if opts.step_mode == StepMode.PRIMAL:
        return F.step_bound_single(be, it, d)
    return F.step_bounds_pd(be, it, d)


def _weights(n: int, like: torch.Tensor) -> torch.Tensor:
    """n line-search weights 1/n, 2/n, ..., 1 (each (i + 1) / n rounded
    once, as a Python division rounds it), made on the device."""
    return torch.arange(1, n + 1, dtype=like.dtype, device=like.device) / n


def _argmax_take(scores, *vals):
    """vals[argmax(scores)] for each of vals, with no read-back (indexing
    with a 0-dim tensor would read the index back)."""
    i = torch.argmax(scores)
    return [torch.take(v, i) for v in vals]


def ipm_step(be, it: F.Iterate, delta_p, delta_d, opts: Options,
             iteration=None, res=None):
    """One full IPM iteration. Returns (new_iterate, StepStats).

    `iteration` (int or None) gates the late-iteration small-pair
    correctors (first_iter_small_correctors).  `res` optionally passes
    residuals already computed for THIS iterate."""
    if opts.outer_bicgstab:
        raise NotImplementedError("outer_bicgstab is not ported yet")
    if res is None:
        res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, delta_p, delta_d)
    ok = be.factorization_ok(fac)

    mu = F.mu(be, it)

    # ---- predictor (affine scaling) ----
    comp_aff = F.comp_rhs_affine(be, it)
    d_aff = _solve_dir(be, it, res, comp_aff, Ominv, fac, opts)
    ap_aff, ad_aff = _alphas(be, it, d_aff, opts)
    mu_aff = F.mu_after_step(be, it, d_aff, ap_aff, ad_aff)

    # ---- centering parameter sigma = (mu_aff/mu)^3 (reference :154-168) ----
    sigma = (mu_aff / mu) ** 3
    sigma_mu = sigma * mu

    # ---- corrector (combined direction) ----
    comp_corr = F.comp_rhs_corrector(be, it, d_aff, sigma_mu)
    d = _solve_dir(be, it, res, comp_corr, Ominv, fac, opts)

    # ---- weighted predictor-corrector line search (reference :459-526) --
    if opts.n_linesearch_points > 1:
        d, a_p, a_d = _weighted_pc_search(be, it, d_aff, d, opts)
    else:
        a_p, a_d = _alphas(be, it, d, opts)

    # ---- Gondzio multiple centrality correctors (reference :236-358) ----
    n_gondzio = torch.zeros((), dtype=torch.int32, device=mu.device)
    if opts.max_gondzio_correctors > 0:
        zero_res = tmap(torch.zeros_like, res)
        it_idx = iteration if iteration is not None else -1
        small_allowed = (opts.small_pair_correctors
                         and opts.max_additional_correctors > 0)
        max_small = max(opts.max_additional_correctors, 1)
        nw = max(opts.n_linesearch_points, 1)
        ws = _weights(nw, mu)
        tol = 1.0 + opts.acceptance_tolerance

        def cond(carry):
            _, ap_c, ad_c, k, n_small, _, go = carry
            return (go & (torch.minimum(ap_c, ad_c) < 1.0)
                    & (k < opts.max_gondzio_correctors)
                    & (n_small < max_small))

        def body(carry):
            d_c, ap_c, ad_c, k, n_small, small_corr, _ = carry
            # enlarged trial steps alpha_t = min(1, f1*alpha + f0)
            ap_t = torch.clamp(opts.step_factor1 * ap_c + opts.step_factor0,
                               max=1.0)
            ad_t = torch.clamp(opts.step_factor1 * ad_c + opts.step_factor0,
                               max=1.0)
            # small-pair correctors lift the upper projection bound to +inf
            # so only tiny complementarity products are pushed
            beta_hi = torch.full_like(mu, opts.beta_max).masked_fill(
                small_corr, float("inf"))
            comp_g = F.comp_rhs_gondzio(be, it, d_c, ap_t, ad_t, sigma_mu,
                                        opts.beta_min, beta_hi)
            corr = _solve_dir(be, it, zero_res, comp_g, Ominv, fac, opts)

            # per-side weighted corrector addition: scan weights, pick the
            # best primal and dual weights INDEPENDENTLY
            trials = [_alphas(be, it, F.add_weighted(d_c, corr, w, w), opts)
                      for w in ws]
            aps = torch.stack([t[0] for t in trials])
            ads = torch.stack([t[1] for t in trials])
            ap_n, wp = _argmax_take(aps, aps, ws)
            ad_n, wd = _argmax_take(ads, ads, ws)

            acc_p = ap_n >= tol * ap_c
            acc_d = ad_n >= tol * ad_c
            # apply the corrector with per-side weights (zero on the side
            # that did not improve — reference :298-331)
            d_new = F.add_weighted(d_c, corr, torch.where(acc_p, wp, 0.0),
                                   torch.where(acc_d, wd, 0.0))
            accepted = acc_p | acc_d
            # on rejection: switch to small-pair correctors once, when the
            # step is still poor and the IPM is late enough
            can_small = (~small_corr
                         & (torch.minimum(ap_c, ad_c)
                            < opts.max_alpha_small_correctors)
                         & (it_idx >= opts.first_iter_small_correctors)
                         & small_allowed)
            switch_small = ~accepted & can_small
            return (d_new, torch.where(acc_p, ap_n, ap_c),
                    torch.where(acc_d, ad_n, ad_c), k + accepted.to(k.dtype),
                    n_small + (accepted & small_corr).to(k.dtype),
                    small_corr | switch_small, accepted | switch_small)

        false = torch.zeros((), dtype=torch.bool, device=mu.device)
        d, a_p, a_d, n_gondzio, _, _, _ = dev_while(
            cond, body, (d, a_p, a_d, n_gondzio, torch.zeros_like(n_gondzio),
                         false, ~false),
            # each trip accepts a corrector or, once, switches to small
            # pairs
            opts.max_gondzio_correctors + 1)

    # ---- final step lengths ----
    a_p_f, a_d_f = _final_steplengths(be, it, d, a_p, a_d, mu, opts)

    # ---- probing (reference compute_probing_factor, :528-627): when the
    # step looks troubled, evaluate residuals and mu at the candidate point
    # and damp the step so neither grows more than 10x ----
    if opts.probing:
        def probed(ap, ad):
            trial = F.take_step(it, d, ap, ad)
            rn_t = F.residual_norm(F.compute_residuals(be, trial))
            rn_0 = F.residual_norm(res)
            mu_t = F.mu(be, trial)
            f = torch.ones_like(mu)
            f = torch.minimum(f, torch.where(
                rn_t > 10.0 * rn_0,
                9.0 * rn_0 / torch.clamp_min(rn_t - rn_0, 1e-300) * 0.9995,
                f))
            f = torch.minimum(f, torch.where(
                mu_t > 10.0 * mu,
                9.0 * mu / torch.clamp_min(mu_t - mu, 1e-300) * 0.9995, f))
            return ap * f, ad * f

        a_p_f, a_d_f = dev_cond(
            torch.minimum(a_p_f, a_d_f) < opts.probing_trigger, probed, None,
            (a_p_f, a_d_f))

    # ---- numerical-troubles path (reference :528-627): when the combined
    # step collapses, retry with a PURE CENTERING direction (sigma = 1,
    # complementarity target mu) and a damped step ----
    if opts.centering_retry:
        def centered(_d, _ap, _ad):
            comp_c = F.comp_rhs_corrector(
                be, it, tmap(torch.zeros_like, d_aff), mu)
            d_c = _solve_dir(be, it, res, comp_c, Ominv, fac, opts)
            ap_c, ad_c = _alphas(be, it, d_c, opts)
            return d_c, 0.7 * ap_c, 0.7 * ad_c

        d, a_p_f, a_d_f = dev_cond(
            (a_p_f + a_d_f) < opts.small_step_threshold, centered, None,
            (d, a_p_f, a_d_f))

    new_it = F.take_step(it, d, a_p_f, a_d_f)
    stats = StepStats(mu=mu, sigma=sigma, alpha_primal=a_p_f,
                      alpha_dual=a_d_f, n_gondzio=n_gondzio, factor_ok=ok)
    return new_it, stats


def _final_steplengths(be, it, d, a_p_max, a_d_max, mu, opts: Options):
    """Mehrotra's step-length heuristic with the EXACT blocking pair
    (reference mehrotra_step_length, InteriorPointMethod.cpp:746-816).

    mufull = mu(alpha_max) / gamma_a.  For the primal side with blocking
    pair (v_b, dv_b) and partner (g_b, dg_b):

        alpha_p = (-v_b + mufull / (g_b + alpha_d_max * dg_b)) / dv_b

    clamped to [gamma_f * alpha_max, alpha_max], then damped by
    steplength_factor; alpha = 1 when nothing blocks."""
    gf = opts.gamma_f
    sf = opts.steplength_factor
    mu_full = F.mu_after_step(be, it, d, a_p_max, a_d_max) / opts.gamma_a

    _, vp, dvp, gp, dgp, blk_p = F.find_blocking(be, it, d, primal=True)
    _, vd, dvd, gd, dgd, blk_d = F.find_blocking(be, it, d, primal=False)

    def side(a_max, other_max, val, dval, par, dpar, blocking):
        par_estim = par + other_max * dpar
        degenerate = torch.abs(par_estim) < 1e-300
        alpha = (-val + mu_full / torch.where(degenerate, 1.0, par_estim)) \
            / torch.where(dval < 0, dval, -1.0)
        alpha = torch.where(degenerate, 0.0, alpha)
        alpha = torch.where(blocking, alpha, 1.0)
        # safeguard (reference :800-812)
        alpha = torch.minimum(alpha, a_max)
        alpha = torch.maximum(alpha, gf * a_max)
        return alpha * sf

    a_p = side(a_p_max, a_d_max, vp, dvp, gp, dgp, blk_p)
    a_d = side(a_d_max, a_p_max, vd, dvd, gd, dgd, blk_d)
    if opts.step_mode == StepMode.PRIMAL:
        a = torch.minimum(a_p, a_d)
        return a, a
    return a_p, a_d


def _weighted_pc_search(be, it, d_aff, d_corr, opts: Options):
    """Weighted predictor-corrector line search (reference
    InteriorPointMethod.cpp:459-526): evaluate n_linesearch_points
    interpolates d(w) = d_aff + w (d_corr - d_aff), w in (0, 1], and keep
    the weight maximizing the combined step length."""
    n = max(opts.n_linesearch_points, 1)
    d_delta = tmap(lambda a, b: b - a, d_aff, d_corr)
    ws = _weights(n, leaves(d_aff)[0])
    trials = [_alphas(be, it, tmap(lambda a, dd: a + w * dd, d_aff, d_delta),
                      opts) for w in ws]
    aps = torch.stack([t[0] for t in trials])
    ads = torch.stack([t[1] for t in trials])
    w_best, a_p, a_d = _argmax_take(aps + ads, ws, aps, ads)
    d = tmap(lambda a, dd: a + w_best * dd, d_aff, d_delta)
    return d, a_p, a_d

