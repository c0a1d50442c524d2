"""Outer IPM loop: initial point, termination, regularization escalation.

Counterpart of the host loop of `pips_ipmpp_tpu/ipm/solver.py` (reference
PIPSIPMppSolver::solve, Core/InteriorPointMethod/PIPSIPMppSolver.cpp:29-194):
evaluate residuals -> gap/residual norm -> status (mu <= 1e-6 and
resid <= 1e-4*||data|| -> success; divergence -> INFEASIBLE; slow
convergence -> UNKNOWN; max 300 iterations) -> one predictor-corrector
iteration.  The loop reads back one stacked tensor of scalars per
evaluation and one per step.

On a failed factorization the regularization strategy escalates and the
iteration is retried — the inertia-free analog of the reference's
factorize_with_correct_inertia loop (LinearSystem.C:296-325).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from pips_ipmpp_tpu_torch.core.options import Options
from pips_ipmpp_tpu_torch.core.status import TerminationStatus
from pips_ipmpp_tpu_torch.ipm import formulation as F
from pips_ipmpp_tpu_torch.ipm.mehrotra import ipm_step
from pips_ipmpp_tpu_torch.ipm.regularization import make_regularization


def pin_float32_precision():
    """True f32 matmuls: no TF32 anywhere.  Both of the JAX package's
    `matmul_precision` values map here: its "high" is three bf16 passes,
    more accurate than torch's "high" (TF32), and reduced precision
    stalled this IPM near mu 1e-3 (pips_ipmpp_tpu/ipm/solver.py:132-137)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclass
class IterationInfo:
    iteration: int
    mu: float
    residual_norm: float
    duality_gap: float
    objective: float
    alpha_primal: float
    alpha_dual: float
    sigma: float
    n_gondzio: int


@dataclass
class SolveResult:
    status: TerminationStatus
    iterate: F.Iterate
    iterations: int
    objective: float
    mu: float
    residual_norm: float
    history: list = field(default_factory=list)


def _evaluate(be, it) -> list[float]:
    """(mu, residual norm, gap, objective) in one device->host transfer."""
    res = F.compute_residuals(be, it)
    return torch.stack([F.mu(be, it), F.residual_norm(res),
                        F.duality_gap(be, it), be.objective(it.x)]).tolist()


def _initial_point(be, opts: Options):
    datanorm = be.datanorm()
    shift = torch.sqrt(datanorm)
    it = F.initial_iterate(be, shift)
    # one affine solve from the pushed point, full step, then re-shift
    # (reference Solver.cpp:16-31)
    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, opts.primal_regularization,
                       opts.dual_regularization)
    # the init point is a heuristic: if the factorization fails at base
    # regularization, redo it heavily regularized rather than poisoning
    # the iterate with NaN
    if not bool(be.factorization_ok(fac)):
        big = 1e-6 * (1.0 + float(datanorm))
        fac = be.factorize(Dx, Ominv, big, big)
    comp = F.comp_rhs_affine(be, it)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    dx, dy, dz = be.solve_reduced(fac, rhs, opts.refinement_steps)
    d = F.recover_step(be, it, res, comp, Ominv, rhs, dx, dy, dz)
    it = F.take_step(it, d, 1.0, 1.0)
    viol = F.violation(be, it)
    it = F.shift_bound_variables(be, it, 1e3 + 2.0 * viol)
    return it, float(datanorm)


# Iterates, residuals and refinement run in f64 whatever the LP's dtype;
# only the factors take the backend's factor dtype (f32 through the LDL
# kernel on CUDA).  This is the JAX package's mixed precision with 64-bit
# mode on, where an f32 LP's iterates turn f64 after the first step.
WORKING_DTYPE = torch.float64


class IPMSolver:
    """Drives the IPM to termination over a backend.

    `be_ctor(lp) -> backend`; `device` is where the LP, the iterate and the
    factors live: the CUDA card unless the caller passes `device="cpu"`.
    Nothing picks the CPU on its own: without a CUDA device the default
    raises when the first tensor moves to it."""

    def __init__(self, be_ctor: Callable, opts: Optional[Options] = None,
                 *, device="cuda"):
        self.be_ctor = be_ctor
        self.opts = opts or Options()
        self.device = torch.device(device)
        pin_float32_precision()

    def solve(self, lp, callback=None) -> SolveResult:
        opts = self.opts
        pin_float32_precision()
        mu_tol, res_tol = opts.tolerances()
        lp = lp.to(self.device).astype(WORKING_DTYPE)
        be = self.be_ctor(lp)

        strat = make_regularization(opts)
        rstate = strat.init_state(lp.dtype)
        it, datanorm = _initial_point(be, opts)

        history: list[IterationInfo] = []
        status = TerminationStatus.MAX_ITS_EXCEEDED
        best_mu = float("inf")
        stall = 0
        n_steps = 0

        for k in range(opts.max_iterations):
            mu_v, res_v, gap_v, obj_v = _evaluate(be, it)

            if opts.print_level >= 10:
                print(f"iter {k:3d}  obj {obj_v: .8e}  mu {mu_v:.3e}  "
                      f"resid {res_v:.3e}")

            # -- termination tests (reference compute_status :143-194) --
            if mu_v <= mu_tol and res_v <= res_tol * max(datanorm, 1.0):
                status = TerminationStatus.SUCCESSFUL_TERMINATION
                break
            # divergence is RELATIVE to the best mu seen, only after the
            # iteration has had a chance to settle (reference :164-169)
            if not math.isfinite(mu_v) or (
                    k >= 10 and mu_v > opts.divergence_mu
                    and mu_v > 1e4 * best_mu):
                status = TerminationStatus.INFEASIBLE
                break
            # slow-progress detection (reference :176-185)
            if mu_v < best_mu * 0.999:
                best_mu, stall = mu_v, 0
            else:
                stall += 1
                if stall >= 30:
                    status = TerminationStatus.UNKNOWN
                    break

            rstate = strat.new_step(rstate)
            dp, dd = strat.deltas(rstate)
            new_it, stats, stats_h = self._step(be, it, dp, dd, k)
            retries = 0
            while not stats_h[0] and retries < opts.max_regularization_retries:
                rstate = strat.on_failure(rstate, mu_v, retries)
                if strat.give_up(rstate):
                    break
                dp, dd = strat.deltas(rstate)
                new_it, stats, stats_h = self._step(be, it, dp, dd, k)
                retries += 1
            if not stats_h[0]:
                status = TerminationStatus.UNKNOWN
                break

            it = new_it
            n_steps += 1
            if opts.record_history:
                _, a_p, a_d, sigma = stats_h
                history.append(IterationInfo(
                    iteration=k, mu=mu_v, residual_norm=res_v,
                    duality_gap=gap_v, objective=obj_v, alpha_primal=a_p,
                    alpha_dual=a_d, sigma=sigma, n_gondzio=stats.n_gondzio))
            if callback is not None:
                callback(k, it, history[-1] if history else None)

        # final evaluation of the FINAL iterate: on the max-iterations
        # path the loop-top mu/residual belong to the pre-step iterate
        mu_v, res_v, _, obj_v = _evaluate(be, it)
        return SolveResult(status=status, iterate=it, iterations=n_steps,
                           objective=obj_v, mu=mu_v, residual_norm=res_v,
                           history=history)

    def _step(self, be, it, dp, dd, k):
        new_it, stats = ipm_step(be, it, dp, dd, self.opts, iteration=k)
        ok, a_p, a_d, sigma = torch.stack([
            stats.factor_ok.to(stats.mu.dtype), stats.alpha_primal,
            stats.alpha_dual, stats.sigma]).tolist()
        return new_it, stats, (bool(ok), a_p, a_d, sigma)
