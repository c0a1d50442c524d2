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

`IPMSolver.solve_fused` runs the whole solve on the device instead
(`ipm/device_loop.py`): on CUDA as one captured CUDA graph per backend
shape, replayed for every later LP of that shape; on the CPU eagerly.
`IPMSolver.solve_fused_batch_async` runs B same-shape LPs as one such
solve over a leading batch axis (one graph per backend shape and B).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.bucketed import BucketedArrowheadLP
from pips_ipmpp_tpu_torch.core.lp import stack_lps
from pips_ipmpp_tpu_torch.core.options import Options
from pips_ipmpp_tpu_torch.core.sparse import SparseArrowheadLP
from pips_ipmpp_tpu_torch.core.status import TerminationStatus
from pips_ipmpp_tpu_torch.core.spaces import tmap
from pips_ipmpp_tpu_torch.ipm import control
from pips_ipmpp_tpu_torch.ipm import formulation as F
from pips_ipmpp_tpu_torch.ipm.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from pips_ipmpp_tpu_torch.ipm.device_loop import (decode_status,
                                                  initial_point,
                                                  solve_on_device)
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
    # fused solves: graph (captured or eager), turns (loop body runs:
    # steps + retries + the terminal turn), delta_p, delta_d
    info: dict = field(default_factory=dict)


def _evaluate(be, it) -> list[float]:
    """(mu, residual norm, gap, objective) in one device->host transfer."""
    res = F.compute_residuals(be, it)
    return torch.stack([F.mu(be, it), F.residual_norm(res),
                        F.duality_gap(be, it), be.objective(it.x)]).tolist()


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
    raises when the first tensor moves to it.

    `troubles_hook() -> be_ctor | None` is consulted by the host loop once
    the regularization ladder is exhausted: it may relax the backend (e.g.
    `sc_precond.SCsparsifier.decrease_diag_dom_bound`, a less aggressive
    preconditioner, the reference's InteriorPointMethod.cpp:629-637) and
    return the constructor the solve goes on with."""

    def __init__(self, be_ctor: Callable, opts: Optional[Options] = None,
                 *, device="cuda", troubles_hook: Optional[Callable] = None):
        self.be_ctor = be_ctor
        self.opts = opts or Options()
        self.troubles_hook = troubles_hook
        self.device = torch.device(device)
        self._graphs: dict = {}     # backend signature -> FusedGraph
        pin_float32_precision()

    def solve(self, lp, callback=None, checkpoint_path: str | None = None,
              checkpoint_every: int = 10,
              resume: bool = False) -> SolveResult:
        """The host loop.  With `checkpoint_path`, the iterate is saved
        there every `checkpoint_every` iterations (`ipm/checkpoint.py`, one
        device->host copy per save); with `resume` and an existing file,
        the solve starts from the saved iterate, its iteration count and
        its regularization shifts."""
        opts = self.opts
        pin_float32_precision()
        mu_tol, res_tol = opts.tolerances()
        lp = lp.to(self.device).astype(WORKING_DTYPE)
        be = self.be_ctor(lp)

        strat = make_regularization(opts)
        rstate = strat.init_state(lp.dtype, self.device)
        k0 = 0
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            it, k0, dp_c, dd_c, _ = load_checkpoint(
                checkpoint_path, dtype=WORKING_DTYPE, device=self.device)
            rstate = (torch.full_like(rstate[0], dp_c),
                      torch.full_like(rstate[1], dd_c), rstate[2])
            datanorm = float(be.datanorm())
        else:
            it, datanorm = initial_point(be, opts)
            datanorm = float(datanorm)

        history: list[IterationInfo] = []
        status = TerminationStatus.MAX_ITS_EXCEEDED
        best_mu = float("inf")
        stall = 0
        n_steps = k0   # completed IPM steps (the reported iteration count)

        for k in range(k0, opts.max_iterations):
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
                    k - k0 >= 10 and mu_v > opts.divergence_mu
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
                if bool(strat.give_up(rstate)):
                    break
                dp, dd = strat.deltas(rstate)
                new_it, stats, stats_h = self._step(be, it, dp, dd, k)
                retries += 1
            if not stats_h[0] and self.troubles_hook is not None:
                new_ctor = self.troubles_hook()
                if new_ctor is not None:
                    self.be_ctor = new_ctor
                    be = new_ctor(lp)
                    new_it, stats, stats_h = self._step(be, it, dp, dd, k)
            if not stats_h[0]:
                status = TerminationStatus.UNKNOWN
                break

            it = new_it
            n_steps += 1
            if (checkpoint_path and checkpoint_every > 0
                    and (k + 1) % checkpoint_every == 0):
                save_checkpoint(checkpoint_path, it, k + 1, dp, dd)
            if opts.record_history:
                _, a_p, a_d, sigma, n_gondzio = stats_h
                history.append(IterationInfo(
                    iteration=k, mu=mu_v, residual_norm=res_v,
                    duality_gap=gap_v, objective=obj_v, alpha_primal=a_p,
                    alpha_dual=a_d, sigma=sigma, n_gondzio=int(n_gondzio)))
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
        dt = stats.mu.dtype
        ok, a_p, a_d, sigma, n_gondzio = torch.stack([
            stats.factor_ok.to(dt), stats.alpha_primal, stats.alpha_dual,
            stats.sigma, stats.n_gondzio.to(dt)]).tolist()
        return new_it, stats, (bool(ok), a_p, a_d, sigma, n_gondzio)

    # ------------------------------------------------------------------
    def solve_fused_async(self, lp):
        """Dispatch one solve of the whole IPM on the device, without a
        synchronization: returns (iterate, info) as device tensors
        (`device_loop.solve_on_device`), info["graph"] telling whether the
        solve ran as a captured graph.

        On CUDA the first call for a backend shape builds and loads every
        kernel, runs one eager warm-up turn on its backend (lazy
        initialization inside a conditional body would break the
        capture), then captures the whole solve, initial point included,
        into a CUDA graph over that backend's tensors.  Later calls of the
        same shape copy the new backend's tensors into those and replay
        the graph: a stream of calls queues replays, and the host waits
        only where it reads a result.  A capture that fails raises; the
        solve never runs the eager loop on the card instead.  On the CPU
        the same loop runs eagerly."""
        pin_float32_precision()
        return self._run_fused(lp.to(self.device).astype(WORKING_DTYPE))

    def solve_fused_batch_async(self, lps):
        """B independent LPs of the same shape as ONE fused solve, the JAX
        package's `jax.vmap` of its device loop: the LPs are stacked on a
        leading batch axis (`core/lp.py::stack_lps`) and the loop runs
        until the last of them ends, each LP's carry kept from its own
        end on (`ipm/control.py`), so each LP takes the status, the
        iteration count and the objective of its own `solve_fused`.  At
        small per-iteration shapes every leaf and root factorization of
        the B LPs is one kernel call and every matvec a batch-B product.
        Returns the raw (iterate, info) of `solve_fused_async`, every
        tensor with a leading axis B (index b for LP b), without a
        synchronization.  On CUDA one graph is captured per backend shape
        and B, as in `solve_fused_async`; on the CPU the loop runs
        eagerly.  Sparse LPs raise: their batch is not ported
        (ROADMAP.md §1: the sparse batch); so do the outer BiCGStab and
        the backend's blockwise and iterative-root modes (ROADMAP.md §1:
        the fused batch under the solve modes), the hierarchical
        backend (ROADMAP.md §1: the fused batch under the hierarchy), and
        bucketed LPs and the banded backends (ROADMAP.md §1: the fused
        batch under the banded and bucketed modes)."""
        lps = list(lps)
        if any(isinstance(lp, BucketedArrowheadLP) for lp in lps):
            raise NotImplementedError(
                "a batch of bucketed LPs is not ported yet (ROADMAP.md §1: "
                "the fused batch under the banded and bucketed modes)")
        if any(isinstance(lp, SparseArrowheadLP) for lp in lps):
            raise NotImplementedError(
                "a batch of sparse LPs is not ported yet (ROADMAP.md §1: "
                "the sparse batch)")
        if self.opts.outer_bicgstab:
            raise NotImplementedError(
                "outer_bicgstab over a batch is not ported yet (ROADMAP.md "
                "§1: the fused batch under the solve modes)")
        pin_float32_precision()
        return self._run_fused(stack_lps(
            [lp.to(self.device).astype(WORKING_DTYPE) for lp in lps]))

    def _run_fused(self, lp):
        """The fused solve of a backend over `lp` (one LP or a stack)."""
        be = self.be_ctor(lp)
        if self.device.type != "cuda":
            it, info = solve_on_device(be, self.opts)
            return it, dict(info, graph=False)
        sig = backend_signature(be)
        fused = self._graphs.get(sig)
        if fused is None:
            fused = self._graphs[sig] = FusedGraph(be, self.opts)
        return fused.run(be)

    def solve_fused(self, lp) -> SolveResult:
        """`solve_fused_async`, then one fetch of the result."""
        it, info = self.solve_fused_async(lp)
        names = ("status", "iterations", "turns", "mu", "residual_norm",
                 "objective", "delta_p", "delta_d")
        vals = dict(zip(names, torch.stack(
            [info[k].to(torch.float64) for k in names]).tolist()))
        n = int(vals["iterations"])
        history = []
        if self.opts.record_history:
            h = info["history"]
            rows = torch.stack([h.mu, h.residual, h.objective,
                                h.alpha_primal, h.alpha_dual])[:, :n]
            for i, (mu, rn, obj, a_p, a_d) in enumerate(rows.T.tolist()):
                history.append(IterationInfo(
                    iteration=i, mu=mu, residual_norm=rn,
                    duality_gap=float("nan"), objective=obj,
                    alpha_primal=a_p, alpha_dual=a_d, sigma=float("nan"),
                    n_gondzio=-1))
        return SolveResult(
            status=decode_status(int(vals["status"])), iterate=it,
            iterations=n, objective=vals["objective"], mu=vals["mu"],
            residual_norm=vals["residual_norm"], history=history,
            info=dict(graph=info["graph"], turns=int(vals["turns"]),
                      delta_p=vals["delta_p"], delta_d=vals["delta_d"]))


def _backend_state(obj, path, out, seen):
    """Append (path, leaf) for every tensor and plain value `obj` holds,
    walking attributes, dataclasses, sequences and dicts (a numpy array
    is a plain value: its shape, dtype and bytes)."""
    if isinstance(obj, torch.Tensor) or obj is None or isinstance(
            obj, (bool, int, float, str, torch.dtype, torch.device)):
        out.append((path, obj))
        return
    if isinstance(obj, np.ndarray):
        out.append((path, (obj.shape, obj.dtype.str, obj.tobytes())))
        return
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, (list, tuple)):
        for i, x in enumerate(obj):
            _backend_state(x, f"{path}[{i}]", out, seen)
    elif isinstance(obj, dict):
        for k in obj:
            _backend_state(obj[k], f"{path}[{k!r}]", out, seen)
    elif hasattr(obj, "__dict__"):
        for k, v in vars(obj).items():
            _backend_state(v, f"{path}.{k}", out, seen)
    else:
        raise TypeError(f"{path}: cannot walk a {type(obj).__name__}")


def backend_state(be) -> list:
    """[(path, tensor or plain value)] of everything a backend holds."""
    out: list = []
    _backend_state(be, "be", out, set())
    return out


def backend_signature(be) -> tuple:
    """What a captured solve depends on beyond the values of the tensors:
    each tensor's shape, dtype and device and every plain value."""
    return tuple((p, (tuple(v.shape), v.dtype, v.device))
                 if isinstance(v, torch.Tensor) else (p, v)
                 for p, v in backend_state(be))


class FusedGraph:
    """One solve of a backend shape captured as a CUDA graph over the
    tensors of `be`, the backend it was captured on."""

    def __init__(self, be, opts: Options):
        self.be = be
        self.state = [v for _, v in backend_state(be)
                      if isinstance(v, torch.Tensor)]
        dev = self.state[0].device
        control.prepare(dev)
        # warm-up turn: loads the kernels and creates the libraries'
        # handles and workspaces before the capture
        solve_on_device(be, opts.replace(max_iterations=1))
        torch.cuda.synchronize(dev)
        with control.capture(dev) as self.graph:
            self.out = solve_on_device(be, opts)

    def run(self, be):
        """Replay on the data of `be` (same signature); returns copies of
        the outputs."""
        if be is not self.be:
            new = [v for _, v in backend_state(be)
                   if isinstance(v, torch.Tensor)]
            for dst, src in zip(self.state, new):
                dst.copy_(src)
        self.graph.replay()
        it, info = tmap(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        else t, self.out)
        return it, dict(info, graph=True)
