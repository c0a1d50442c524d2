"""Public facade — counterpart of `pips_ipmpp_tpu/interface.py`
(reference PIPSIPMppInterface, Core/Interface/PIPSIPMppInterface.hpp:32-128):
construct from problem data + options; run() -> TerminationStatus;
getObjective(); gatherPrimalSolution().

This package's facade takes an ArrowheadLP or a SparseArrowheadLP,
applies the equilibrium scaler when asked, and solves with the
Schur-complement ArrowBackend, or, for a sparse LP whose dense twin does
not fit `Options.sparse_densify_max_mb`, with the CG-leaf
SparseArrowBackend.  It runs on the CUDA card unless the caller passes
`device="cpu"`.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP
from pips_ipmpp_tpu_torch.core.sparse import (SparseArrowheadLP, dense_bytes,
                                              dense_from_sparse)
from pips_ipmpp_tpu_torch.core.options import (Options, PresolverType,
                                               ScalerType)
from pips_ipmpp_tpu_torch.core.status import TerminationStatus


def resolve_factor_dtype(opts: Options, device) -> torch.dtype:
    """Factor precision: f32 on CUDA (the LDL kernel's path), f64 on CPU,
    unless `opts.factor_dtype` names one.  Iterates, residuals and
    refinement run in f64 whatever the factors' dtype
    (`ipm/solver.py::WORKING_DTYPE`)."""
    if opts.factor_dtype == "float32":
        return torch.float32
    if opts.factor_dtype == "float64":
        return torch.float64
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


def _check_supported(opts: Options):
    unported = {
        "presolve": opts.presolve != PresolverType.NONE,
        "hierarchical": opts.hierarchical,
        "banded_leaf": opts.banded_leaf,
        "banded_root": opts.banded_root,
        "sc_blockwise": opts.sc_blockwise > 0,
        "iterative_root_panel": opts.iterative_root_panel > 0,
        "outer_bicgstab": opts.outer_bicgstab,
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(f"Options.{name} is not ported yet")


class PIPSIPMppTorchInterface:
    """Facade wiring scaler -> solver (ctor order mirrors
    PIPSIPMppInterface.cpp:20-130)."""

    def __init__(self, lp, options: Optional[Options] = None, *,
                 device="cuda"):
        if not isinstance(lp, (ArrowheadLP, SparseArrowheadLP)):
            raise TypeError(f"unsupported problem type {type(lp)}: this "
                            f"package solves ArrowheadLP and "
                            f"SparseArrowheadLP")
        self.options = options or Options()
        _check_supported(self.options)
        self.device = torch.device(device)
        self.lp = lp.to(self.device)
        self.result = None
        self.phase_times: dict[str, float] = {}
        self._scaler = None

        from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
        from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend

        be_cls = ArrowBackend
        if isinstance(lp, SparseArrowheadLP):
            budget = self.options.sparse_densify_max_mb * 1024 * 1024
            if budget > 0 and dense_bytes(lp) <= budget:
                # the dense twin fits: batched dense factorization
                self.lp = dense_from_sparse(self.lp)
            else:
                from pips_ipmpp_tpu_torch.linalg.sparse_backend import \
                    SparseArrowBackend
                be_cls = SparseArrowBackend
        self.backend_class = be_cls
        fd = resolve_factor_dtype(self.options, self.device)
        self._solver = IPMSolver(partial(be_cls, factor_dtype=fd),
                                 self.options, device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> TerminationStatus:
        """Scale -> solve.  Per-phase wall times land in `phase_times`
        (seconds)."""
        self.phase_times = {}
        lp = self.lp
        if self.options.scaler != ScalerType.NONE:
            from pips_ipmpp_tpu_torch.scale import make_scaler
            t0 = time.perf_counter()
            self._scaler = make_scaler(self.options.scaler)
            lp = self._scaler.scale(lp)
            self._sync()
            self.phase_times["scale"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.result = self._solver.solve(lp)
        self._sync()
        self.phase_times["solve"] = time.perf_counter() - t0
        return self.result.status

    # ------------------------------------------------------------------
    def _require_result(self):
        if self.result is None:
            raise RuntimeError("call run() first")

    @property
    def n_iterations(self) -> int:
        self._require_result()
        return self.result.iterations

    def getObjective(self) -> float:
        """Objective of the unscaled solution (reference
        PIPSIPMppInterface::getObjective :193-211)."""
        x = self.gatherPrimalSolution()
        lp = self.lp
        return float(np.dot(lp.c0.cpu().numpy(), x[:lp.n0])
                     + np.dot(lp.cN.cpu().numpy().reshape(-1), x[lp.n0:]))

    def gatherPrimalSolution(self) -> np.ndarray:
        """x in the original (unscaled) variables: [x0 | x_1 | ... | x_N]."""
        self._require_result()
        x = self.result.iterate.x
        if self._scaler is not None:
            x = self._scaler.unscale_x(x)
        return np.concatenate([x.first.cpu().numpy(),
                               x.blocks.cpu().numpy().reshape(-1)])
