"""Timing/observability: per-phase wall-clock monitor + iteration statistics.

Counterpart of `pips_ipmpp_tpu/utils/monitor.py`: the analogs of the
reference's StochNodeResourcesMonitor (per-node fact/Lsolve/Dsolve/Ltsolve
timers, Core/Problems/StochResourcesMonitor.hpp:35-60), the TIMING
build-flag phase prints (PIPSIPMppInterface.cpp:29-124) and Statistics
(rank-0 per-iteration log lines, Core/InteriorPointMethod/Statistics.cpp).
CUDA work is asynchronous, so a phase on the card synchronizes the device
before each clock read: its time is the device's, not the launches'.
Kernel-level spans come from `torch.profiler` (`profiler_trace`).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


def _sync():
    """Wait for the card's queued work, once this process uses CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ResourceMonitor:
    """Accumulating named phase timers (thread-unsafe by design: one per
    solve, like the per-node monitors in the reference).  Each clock read
    follows a synchronization of the current CUDA device, where this
    process uses one."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 6),
                       "count": self.counts[name],
                       "mean_ms": round(1e3 * self.totals[name]
                                        / max(self.counts[name], 1), 3)}
                for name in sorted(self.totals)}

    def pretty(self) -> str:
        lines = ["phase                 total[s]   count   mean[ms]"]
        for name, d in self.report().items():
            lines.append(f"{name:<20} {d['total_s']:>9.3f} {d['count']:>7} "
                         f"{d['mean_ms']:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Wrap a region in a `torch.profiler` session (host and, where CUDA
    is available, device activity) and write its Chrome trace to
    `logdir/trace.json`.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class Statistics:
    """Per-iteration convergence log (reference Statistics.cpp format:
    objective, residual norms, mu, step lengths at print_level >= 10)."""
    print_level: int = 0
    rows: list = field(default_factory=list)

    def record(self, iteration: int, objective: float, mu: float,
               residual_norm: float, duality_gap: float,
               alpha_primal: float = float("nan"),
               alpha_dual: float = float("nan"),
               n_gondzio: int = 0) -> None:
        row = dict(iteration=iteration, objective=objective, mu=mu,
                   residual_norm=residual_norm, duality_gap=duality_gap,
                   alpha_primal=alpha_primal, alpha_dual=alpha_dual,
                   n_gondzio=n_gondzio)
        self.rows.append(row)
        if self.print_level >= 10:
            print(f"iter {iteration:4d}  obj {objective: .8e}  "
                  f"mu {mu:.3e}  resid {residual_norm:.3e}  "
                  f"gap {duality_gap:.3e}  "
                  f"a_p {alpha_primal:.3f}  a_d {alpha_dual:.3f}  "
                  f"gondzio {n_gondzio}")

    def summary(self) -> dict:
        if not self.rows:
            return {}
        last = self.rows[-1]
        return dict(iterations=len(self.rows), final_mu=last["mu"],
                    final_residual=last["residual_norm"],
                    final_objective=last["objective"])
