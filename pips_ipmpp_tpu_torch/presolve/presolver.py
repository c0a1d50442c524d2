"""The presolve loop (counterpart of `pips_ipmpp_tpu/presolve/presolver.py`):
registered passes run in rounds with ModelCleanup
between (reference StochPresolver::run_presolve_loop, StochPresolver.C:
144-163; max rounds PRESOLVE_MAX_ROUNDS=2, PIPSIPMppOptions.C:339)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP
from pips_ipmpp_tpu_torch.presolve import passes
from pips_ipmpp_tpu_torch.presolve.data import PresolveData
from pips_ipmpp_tpu_torch.presolve.postsolve import (Postsolver, Solution,
                                                     postsolve_residuals)


@dataclass
class PresolveResult:
    lp: Optional[ArrowheadLP]
    infeasible: bool
    objective_offset: float
    events: list
    stats: dict = field(default_factory=dict)


class Presolver:
    """Runs the pass pipeline; pair with Postsolver for solution recovery."""

    def __init__(self, max_rounds: int = 2, enable_bound_strengthening:
                 bool = True):
        self.max_rounds = max_rounds
        self.enable_bound_strengthening = enable_bound_strengthening

    def presolve(self, lp: ArrowheadLP) -> PresolveResult:
        pd = PresolveData.from_lp(lp)
        stats = {}

        def run(name, fn, *a):
            if pd.infeasible:
                return
            k = fn(pd, *a)
            stats[name] = stats.get(name, 0) + k

        run("model_cleanup", passes.model_cleanup)
        for _ in range(self.max_rounds):
            if pd.infeasible:
                break
            before = len(pd.events)
            run("singleton_rows", passes.singleton_rows)
            run("column_fixation", passes.column_fixation)
            run("parallel_rows", passes.parallel_rows)
            run("nearly_parallel_rows", passes.nearly_parallel_rows)
            run("singleton_columns", passes.singleton_columns)
            if self.enable_bound_strengthening:
                run("bound_strengthening", passes.bound_strengthening)
            run("model_cleanup", passes.model_cleanup)
            if len(pd.events) == before:
                break

        if pd.infeasible:
            return PresolveResult(lp=None, infeasible=True,
                                  objective_offset=pd.objective_offset,
                                  events=pd.events, stats=stats)
        return PresolveResult(lp=pd.to_lp(lp.dtype, lp.device),
                              infeasible=False,
                              objective_offset=pd.objective_offset,
                              events=pd.events, stats=stats)


__all__ = ["Presolver", "PresolveResult", "Postsolver", "Solution",
           "postsolve_residuals"]
