"""The whole IPM solve on the device: the counterpart of
`pips_ipmpp_tpu/ipm/device_loop.py`.

The outer loop (residual evaluation, termination tests, regularization
retries, the predictor-corrector step) is one `control.dev_while` over a
carry of device tensors, line for line the JAX package's
`lax.while_loop`.  Run eagerly (on the CPU, as the tests run it) it reads
its predicate back once per turn; captured into a CUDA graph
(`IPMSolver.solve_fused`) it is a conditional WHILE node, every branch
inside it a conditional node too, and the host reads nothing until the
solve ends.  Per-iteration statistics are written into preallocated
tensors.

Over a backend of a stack of LPs (`be.batch_shape == (B,)`, the fused
batch solve) the same code solves every LP at once, as `jax.vmap` of the
JAX package's loop does: every scalar of the carry (`k`, `turns`,
`status`, `attempt`, the regularization state, ...) holds one value per
LP, the history is [B, max_iterations], and `control`'s batched
semantics keep an LP's carry where its own loop has ended.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from pips_ipmpp_tpu_torch.core.options import Options
from pips_ipmpp_tpu_torch.core.spaces import bcast, select, tmap
from pips_ipmpp_tpu_torch.core.status import TerminationStatus
from pips_ipmpp_tpu_torch.ipm import formulation as F
from pips_ipmpp_tpu_torch.ipm.control import dev_cond, dev_while
from pips_ipmpp_tpu_torch.ipm.mehrotra import StepStats, ipm_step
from pips_ipmpp_tpu_torch.ipm.regularization import make_regularization

# status codes inside the device loop
RUNNING = 0
SUCCESS = 1
INFEASIBLE = 2
STALLED = 3
FACTOR_FAIL = 4


@dataclass
class FusedHistory:
    mu: Any
    residual: Any
    objective: Any
    alpha_primal: Any
    alpha_dual: Any


def initial_point(be, opts: Options):
    """The initial iterate and the data norm (a device scalar), with no
    read-back: the JAX package's `_init_fn`, shared as there by the host
    loop and the device loop.  The heavily regularized retry is a
    `dev_cond`; run eagerly it reads its predicate back once."""
    datanorm = be.datanorm()
    it = F.initial_iterate(be, torch.sqrt(datanorm))
    # one affine solve from the pushed point, full step, then re-shift
    # (reference Solver.cpp:16-31)
    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, opts.primal_regularization,
                       opts.dual_regularization)
    # the init point is a heuristic: if the factorization fails at base
    # regularization, redo it heavily regularized rather than poisoning
    # the iterate with NaN
    big = 1e-6 * (1.0 + datanorm)
    fac = dev_cond(~be.factorization_ok(fac),
                   lambda _: (be.factorize(Dx, Ominv, big, big),), None,
                   (fac,))[0]
    comp = F.comp_rhs_affine(be, it)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    dx, dy, dz = be.solve_reduced(fac, rhs, opts.refinement_steps)
    d = F.recover_step(be, it, res, comp, Ominv, rhs, dx, dy, dz)
    it = F.take_step(it, d, 1.0, 1.0)
    viol = F.violation(be, it)
    it = F.shift_bound_variables(be, it, 1e3 + 2.0 * viol)
    return it, datanorm


def solve_on_device(be, opts: Options):
    """Run the full solve over the backend `be`.  Returns (iterate, info
    dict of device tensors)."""
    mu_tol, res_tol = opts.tolerances()
    max_it = opts.max_iterations
    it0, datanorm = initial_point(be, opts)
    dt, dev = datanorm.dtype, datanorm.device
    batch = tuple(datanorm.shape)       # () for one LP, (B,) for a stack
    res_scale = res_tol * torch.clamp(datanorm, min=1.0)
    rows = torch.arange(max_it, device=dev)

    def nan_row():
        return torch.full(batch + (max_it,), float("nan"), dtype=dt,
                          device=dev)

    hist0 = FusedHistory(nan_row(), nan_row(), nan_row(), nan_row(),
                         nan_row())
    strat = make_regularization(opts)
    rstate0 = strat.init_state(dt, dev, batch)

    def int0(v=0):
        return torch.full(batch, v, dtype=torch.int32, device=dev)

    def eval_all(it):
        res = F.compute_residuals(be, it)
        return res, (F.mu(be, it), F.residual_norm(res), be.objective(it.x))

    # linear residual updates (options.residual_update_every): carry the
    # residuals and scale primal rows by (1-alpha_p), dual rows by
    # (1-alpha_d) after each step.  Exact re-evaluation happens every k
    # steps and whenever mu nears tolerance, so the termination test
    # always sees freshly evaluated residuals.
    upd_every = max(int(opts.residual_update_every), 0)

    def cond(carry):
        status, k = carry[5], carry[1]
        return (status == RUNNING) & (k < max_it)

    def body(carry):
        (it, k, turns, rstate, attempt, status, best_mu, stall, hist,
         res_c, since) = carry
        if upd_every == 0:
            res_it, (mu_v, res_v, obj_v) = eval_all(it)
            since2 = since
        else:
            mu_v = F.mu(be, it)
            due = (since >= upd_every) | (mu_v <= 4.0 * mu_tol) | (k == 0)
            res_it = dev_cond(due, lambda _: (F.compute_residuals(be, it),),
                              None, (res_c,))[0]
            since2 = torch.where(due, 0, since)
            res_v = F.residual_norm(res_it)
            obj_v = be.objective(it.x)
        # a retry turn re-evaluates the UNCHANGED iterate after a failed
        # factorization: it must not advance the stall detector
        is_retry = attempt > 0
        converged = (mu_v <= mu_tol) & (res_v <= res_scale)
        # relative divergence test after a settling period (reference
        # PIPSIPMppSolver.cpp:164-169), matching the host loop
        diverged = ~torch.isfinite(mu_v) | (
            (k >= 10) & (mu_v > opts.divergence_mu) & (mu_v > 1e4 * best_mu))
        improving = mu_v < best_mu * 0.999
        stall = torch.where(is_retry, stall,
                            torch.where(improving, 0, stall + 1))
        best_mu = torch.where(is_retry, best_mu,
                              torch.minimum(best_mu, mu_v))
        new_status = torch.where(
            converged, SUCCESS,
            torch.where(diverged, INFEASIBLE,
                        torch.where(stall >= 30, STALLED, RUNNING))
        ).to(torch.int32)

        def do_step(it, rstate, attempt, _stats, _reg_fail):
            # a fresh IPM iteration advances the strategy schedule; a
            # retry after a failed factorization does not (reference
            # notify_new_step vs get_regularization_parameters)
            first = attempt == 0
            rs = select(first, strat.new_step(rstate), rstate)
            dp, dd = strat.deltas(rs)
            new_it, stats = ipm_step(be, it, dp, dd, opts, iteration=k,
                                     res=res_it)
            ok = stats.factor_ok
            # on factorization failure: keep the iterate, escalate via the
            # strategy (retried next loop turn)
            kept = select(ok, new_it, it)
            fs = strat.on_failure(rs, mu_v, attempt)
            rs2 = select(ok, rs, fs)
            attempt2 = torch.where(ok, 0, attempt + 1).to(torch.int32)
            too_big = ~ok & (strat.give_up(rs2)
                             | (attempt2 > opts.max_regularization_retries))
            return kept, rs2, attempt2, stats, too_big

        # the no-step values (a terminal turn keeps everything); captured,
        # the step writes its values over them in place, the iterate and
        # the strategy state into the loop's carry
        zero = torch.zeros_like(mu_v)
        idle = StepStats(mu=mu_v.clone(), sigma=zero,
                         alpha_primal=zero.clone(),
                         alpha_dual=zero.clone(), n_gondzio=int0(),
                         factor_ok=torch.ones(batch, dtype=torch.bool,
                                              device=dev))
        it2, rstate2, attempt2, stats, reg_fail = dev_cond(
            new_status == RUNNING, do_step, None,
            (it, rstate, attempt.clone(), idle,
             torch.zeros(batch, dtype=torch.bool, device=dev)))
        new_status = torch.where(reg_fail, FACTOR_FAIL,
                                 new_status).to(torch.int32)

        # `k` counts completed IPM STEPS (matching the host loop): retry
        # turns and the terminal evaluation turn neither consume the
        # iteration budget nor write a history row
        stepped = (new_status == RUNNING) & stats.factor_ok
        at = (rows == bcast(k, hist.mu)) & bcast(stepped, hist.mu)

        def row(v, h):
            return torch.where(at, bcast(v, h), h)

        hist = FusedHistory(
            mu=row(mu_v, hist.mu), residual=row(res_v, hist.residual),
            objective=row(obj_v, hist.objective),
            alpha_primal=row(stats.alpha_primal, hist.alpha_primal),
            alpha_dual=row(stats.alpha_dual, hist.alpha_dual))
        if upd_every == 0:
            res_c2, since3 = res_c, since2
        else:
            fp = 1.0 - stats.alpha_primal
            fd = 1.0 - stats.alpha_dual
            scaled = F.Residuals(
                rL=tmap(lambda a: a * bcast(fd, a), res_it.rL),
                rA=tmap(lambda a: a * bcast(fp, a), res_it.rA),
                rC=tmap(lambda a: a * bcast(fp, a), res_it.rC),
                rz=tmap(lambda a: a * bcast(fd, a), res_it.rz),
                rv=tmap(lambda a: a * bcast(fp, a), res_it.rv),
                rw=tmap(lambda a: a * bcast(fp, a), res_it.rw),
                rt=tmap(lambda a: a * bcast(fp, a), res_it.rt),
                ru=tmap(lambda a: a * bcast(fp, a), res_it.ru))
            res_c2 = select(stepped, scaled, res_it)
            since3 = torch.where(stepped, since2 + 1, since2)
        return (it2, k + stepped.to(k.dtype), turns + 1, rstate2, attempt2,
                new_status, best_mu, stall, hist, res_c2, since3)

    res0 = F.compute_residuals(be, it0)
    init = (it0, int0(), int0(), rstate0, int0(), int0(RUNNING),
            torch.full(batch, float("inf"), dtype=dt, device=dev), int0(),
            hist0, res0, int0())
    # each stepped turn advances k; between two steps at most
    # max_regularization_retries + 1 retry turns; one terminal turn
    max_turns = max_it * (opts.max_regularization_retries + 2) + 1
    (it, k, turns, rstate, _, status, _, _, hist, _, _) = dev_while(
        cond, body, init, max_turns)
    dp, dd = strat.deltas(rstate)
    _, (mu_f, res_f, obj_f) = eval_all(it)
    # `turns` = loop body executions: iterations + factorization retries
    # + the terminal evaluation turn (per LP: the trips of its own loop)
    info = dict(status=status, iterations=k, turns=turns, mu=mu_f,
                residual_norm=res_f, objective=obj_f, history=hist,
                delta_p=dp, delta_d=dd)
    return it, info


_STATUS_MAP = {
    SUCCESS: TerminationStatus.SUCCESSFUL_TERMINATION,
    INFEASIBLE: TerminationStatus.INFEASIBLE,
    STALLED: TerminationStatus.UNKNOWN,
    FACTOR_FAIL: TerminationStatus.UNKNOWN,
    RUNNING: TerminationStatus.MAX_ITS_EXCEEDED,
}


def decode_status(code: int) -> TerminationStatus:
    return _STATUS_MAP[int(code)]
