"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `pips_ipmpp_tpu_torch/csrc`, checks
each against its plain PyTorch version on the card at the shapes the solver
gives it (the ELL kernel on every product the sparse backend launches,
epilogues included, with its bound counted from the nonzeros, and the
sliced layout's stored slots per nonzero), then drives every ported path
once, each with the kernels' launch counts set to 0 just before it and
read just after (the ELL kernel's also per operator and width):

  - the facade on the benchmark's flagship dense shape and the IPMSolver
    on its big-leaf shape (LDL^T kernel), each against the port's own f64
    (Cholesky, kernel-free) solve of the same LP;
  - the facade on the 8 x 8192 sparse instance (ELL kernel in the leaf CG,
    LDL^T kernel at the root) and the f64 sparse solve, both against the
    instance's HiGHS f64 oracle objective;
  - the opt-in sweep path (sweep kernel at leaves and root) on the JAX
    package's own sweep acceptance LP, against its analytic optimum;
  - the fused loop (`IPMSolver.solve_fused`, the whole solve as one
    captured CUDA graph with conditional nodes): the flagship, the big
    leaf, the sparse f32 path (the CG a WHILE node around the ELL
    kernel), the flagship with `residual_update_every=4`, and a stream of
    four flagship LPs through `solve_fused_async`, each held to its twin
    (the host loop; for `residual_update_every=4`, which the host loop
    does not read, the same loop run eagerly: status, iterations,
    objective to 1e-6) and to the f64 objective, with the host-side CUDA
    calls of one warm solve;
  - the fused batch (`IPMSolver.solve_fused_batch_async`, B LPs of the
    bench's stream as one captured graph over a leading batch axis): the
    flagship at B = 8 and the big leaf at B = 4, each LP held to its own
    `solve_fused` (status, iterations, objective to 1e-8), timed against
    the stream of the same LPs through `solve_fused_async`, in turns,
    and the LDL kernel at the batches' leaf and root shapes;
  - the 26 GAMSsmall golden instances in f64 through both loops, every
    fused solve captured and held to its host loop, both loops to
    PIPS-IPM++'s recorded acceptance (`GOLDEN_OPEN` names the instances of
    an open fault that may miss it; none now), the root's f64 Cholesky
    through the potf2 kernel (LAPACK's order), which is also held bit for
    bit to its plain version at the root shapes, and launched by every
    f64 reference solve above;
  - the facade's whole pipeline at full size: the JAX package's 102k-
    variable energy dispatch LP through presolve (the native scans
    loaded, its stats the JAX package's), geometric + equilibrium
    scaling, the solve and the primal postsolve, with f64 factors (potf2
    at the root; objective within 1e-6 of HiGHS, A x - b below 1e-5) and
    with the card's f32 factors (LDL kernel; within 1e-3 of the f64
    objective), the primal gathers at 96 blocks and every gather (the
    dual ones through the whole postsolve, its complementarity products
    held to 1e-3) on the same LP cut to 12 blocks, and the LDL and potf2
    kernels checked at its leaf and root shapes;
  - the entry points (`cli_phase`): the gmspips CLI on the 96-block energy
    LP's block files (`--check`, then `97 stem stepLp scaleGeo presolve
    f.opt`, f32, to HiGHS within 1e-3) and on the T = 24 energy LP's MPS
    file with `--auto-blocks 24 printsol` (f32 leaves, the wide root in
    f64; the JAX package's structure, to HiGHS within 1e-3), the same
    dissected LP through the facade in f64 (potf2 at its ~6.5k-wide root
    blocks; to HiGHS within 1e-6, its recovered x to the rows and bounds),
    then the LDL kernel at the dissected LP's leaves and at its root's
    width (13k, which the JAX package's f32 path factors) and potf2 at its
    root blocks (against cholesky_ex, and bit for bit against
    the plain version on the leading columns);
  - the solve modes (`solve_modes_phase`): the energy LP at 96 blocks
    through the whole pipeline with each mode read from a reference .opt
    file (OUTER_SOLVE 2 in f64 and f32, PRECONDITION_SPARSE 1 and
    SC_COMPUTE_BLOCKWISE 1 in f64), each held as the f64 energy run (the
    f32 one to the f64 BiCGStab objective), the BiCGStab and CG trips, the
    iterative root's panels and the peak memory printed (the blockwise
    run's below the cached run's); the fused flagship under outer BiCGStab
    (f32, LDL kernel) and under the iterative root with the blockwise
    Schur complement (f64, potf2 at S11 and at the panels [2, 64, 64]),
    each against its host loop with its Krylov loop a WHILE node of the
    graph; potf2 at the energy LP's panels [7, 64, 64] and [2, 64, 64];
  - the hierarchy (`hier_phase`): the 96-block energy LP through the
    facade with `hierarchical=True` (8 groups, 2 layers) after presolve
    and geometric + equilibrium scaling, in f64 (potf2 at the groups'
    local Schur complements, S11 and the dual Schur complement; HiGHS
    within 1e-6) and f32 (the LDL kernel at the leaves; 1e-3), every
    gather at 12 blocks; at 3 layers through the fused loop (one graph
    launch per warm solve, the refinement a WHILE node, its host loop's
    iterations); under outer BiCGStab; the reference's two hierarchical
    golden instances through both loops (the JAX package's iterations
    plus one); checkpoint/resume of the flat energy LP (the resumed
    objective within 1e-6 of the uninterrupted one); both kernels at the
    hierarchy's shapes;
  - the presolved GAMSsmall instances of
    tests/test_golden_reference.py:62-110 (every gather, complementarity
    held to 1e-3) and the DenseLP happy path through the facade.

`paths()` defines the solves; `profile_port.py` profiles the same ones.

Every failure raises and exits nonzero.  The last line of standard output
is a JSON object naming the device, the line before it the card's name and
power limit, the line before that the kernels with their launch counts,
errors, times and bounds.

Needs one CUDA device; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from functools import lru_cache, partial
from pathlib import Path

import numpy as np
import torch

from pips_ipmpp_tpu_torch import (Options, PIPSIPMppTorchInterface,
                                  TerminationStatus, _build)
from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp
from pips_ipmpp_tpu_torch.core.options import PresolverType, ScalerType
from pips_ipmpp_tpu_torch.interface import (COMPLEMENTARITY_BOUND,
                                            _auto_groups)
from pips_ipmpp_tpu_torch.io.synthetic import (random_arrowhead_lp,
                                               random_sparse_arrowhead_lp)
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver, pin_float32_precision
from pips_ipmpp_tpu_torch.linalg import ldl, potf2, spmv, sweep
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu_torch.linalg.hier_backend import (HierArrowBackend,
                                                      build_hierarchical_lp)
from pips_ipmpp_tpu_torch.linalg.sparse_backend import (SparseArrowBackend,
                                                        batched_pcg)
from pips_ipmpp_tpu_torch.scale import make_scaler

DEVICE = "cuda"
# bench.py's flagship and big-leaf shapes (64 scenario blocks)
FLAGSHIP = dict(N=64, n=256, mE=128, mI=128, n0=64, m0E=32, m0I=32, mEl=32,
                mIl=32)
BIGLEAF = dict(N=64, n=1024, mE=512, mI=512, n0=64, m0E=32, m0I=32, mEl=32,
               mIl=32)
# (batch, edge, positive pivots): the leaves of the flagship, 512-block and
# big-leaf shapes (SPD), the flagship and linking-dominated roots
# ([[SPD, B'], [B, -SPD]] with n0 = 64 first-stage columns), the sparse
# path's root (n0 = 16 of 32), and an SPD edge past any shared-memory cap
LDL_SHAPES = [(64, 256, 256), (512, 128, 128), (64, 1024, 1024),
              (1, 192, 64), (1, 480, 64), (1, 32, 16), (2, 2048, 2048)]
# the sweep kernel at the flagship leaf (SPD) and root (quasidefinite), at
# the sweep solve's leaves (a = 2) and root (a = 3, n0 = 1), unpadded so
# that the wrapper's identity padding of an odd edge runs too, at the big
# leaf (SPD) and at an SPD edge past the one-CTA kernel's shared-memory cap
# of 1701
SWEEP_SHAPES = [(64, 256, 256), (1, 192, 64), (2, 2, 2), (1, 3, 1),
                (64, 1024, 1024), (2, 2048, 2048)]
# every plain version is timed by its checking call between CUDA events
# (`plain_wall_ms`), and profiled (device time over its repetitions and a
# warm-up) where that many checking calls fit in this budget: `plain_ms`
# is the profiled time, else the checking call's (`plain_by` says which).
# The big plain versions run thousands of small operations per call:
# profiling the sweep's at 1024 and 2048 took ~100 s of the script
PLAIN_PROFILE_BUDGET_MS = 2000.0
# the library call's back-to-back loop (`library_loop_ms`) runs about this
# many milliseconds, 10 to 200 calls (200 calls of the big shapes' library
# calls took ~20 s of the script)
LIBRARY_LOOP_BUDGET_MS = 1000.0
# (batch, edge) of the f64 two-level root's Cholesky blocks (S11 and the
# dual Schur complement) that the potf2 kernel factors: the flagship's and
# the big leaf's (n0 = 64, nD = 128), the same at the batch of 8, the
# 8 x 8192 sparse instance's (16, 16), the two golden instances of F3
# (dual blocks of 14 and 11), and edges that straddle the kernel's
# 32-column panels: nb + 1, 2 nb + 3, 193 at a batch of 2, and 300
POTF2_SHAPES = [(1, 64), (1, 128), (8, 64), (8, 128), (1, 16), (1, 14),
                (1, 11), (1, 33), (1, 67), (2, 193), (1, 300)]
# the JAX package's real-world configuration (bench.py:290-370,
# tests/test_realworld.py:117-131): a 102k-variable energy dispatch LP
# (96 blocks of 1062 columns, 150 + 550 rows, n0 = 550, 384 linking rows)
# through the recommended pipeline (presolve, geometric + equilibrium
# scaling) with the JAX bench's solver settings (bench.py:333-335); its
# HiGHS f64 objective (scipy 1.17.0, io/energy.highs_oracle) and the JAX
# package's presolve stats for it
ENERGY = dict(T=96, R=150, G=550, L=350, S=4, seed=5)
ENERGY_OPTIONS = dict(scaler=ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM,
                      presolve=PresolverType.PRESOLVE, max_iterations=300,
                      max_gondzio_correctors=1, refinement_steps=2)
ENERGY_ORACLE = 522861.86199339543
ENERGY_PRESOLVE_STATS = dict(model_cleanup=15, singleton_rows=0,
                             column_fixation=0, parallel_rows=0,
                             nearly_parallel_rows=0, singleton_columns=96,
                             bound_strengthening=1209)
ENERGY_EQ_RESID = 1e-5      # tests/test_realworld.py:41
# the dual gathers' postsolve (the JAX package's dual transfer, which
# scores every candidate row over the whole LP) takes about ten minutes
# at 96 blocks on the card machine's host (PERF.md §5): they run on the
# same LP cut to 12 blocks (ROADMAP.md §3, F5)
ENERGY_GATHER_T = 12
# ENERGY_OPTIONS' solver settings, its scaler and presolve apart
ENERGY_SOLVER = {k: v for k, v in ENERGY_OPTIONS.items()
                 if k not in ("scaler", "presolve")}
# the gathers and the size of the original space each returns
GATHERS = {
    "gatherPrimalSolution": "vars", "gatherDualSolutionEq": "eq",
    "gatherDualSolutionIneq": "ineq", "gatherEqualityConsValues": "eq",
    "gatherInequalityConsValues": "ineq", "gatherSlacksVarsLow": "vars",
    "gatherSlacksVarsUp": "vars", "gatherSlacksInequalityLow": "ineq",
    "gatherSlacksInequalityUp": "ineq",
    "gatherDualSolutionVarBoundsLow": "vars",
    "gatherDualSolutionVarBoundsUpp": "vars",
    "gatherDualSolutionVarBounds": "vars",
    "gatherDualSolutionIneqLow": "ineq", "gatherDualSolutionIneqUpp": "ineq",
    "gatherPrimalResidsEQ": "eq", "gatherPrimalResidsIneqLow": "ineq",
    "gatherPrimalResidsIneqUp": "ineq", "gatherDualResids": "vars"}
# the JAX package's reference-scale sparse acceptance instance
# (tests/test_sparse.py:186-201) and its HiGHS f64 oracle objective
SPARSE = dict(N=8, n=8192, mE=4096, mI=4096, nnz_per_row=10, n0=16, m0E=4,
              m0I=4, mEl=4, mIl=4)
SPARSE_ORACLE = -27135.692927917404
# the entry points' phase (`cli_phase`): the energy LP at the full
# per-period width over T = 24 periods, written as MPS for `--mps F
# --auto-blocks 24` (the MPS reader builds a dense host LP, ~3.5 GB
# here); its HiGHS f64 objective (scipy 1.17.0, io/energy.highs_oracle)
# and the JAX package's structure_report of its dissection
# (core/dissect.auto_structure after io/mps.read_mps, on the CPU)
CLI_T = 24
CLI_ENERGY_ORACLE = 134197.21758345905
CLI_STRUCTURE = dict(num_blocks=24, block_vars=994, block_eq=195,
                     block_ineq=784, first_vars=6509, linking_eq=2758,
                     linking_ineq=0, dense_kkt_entries=677977444,
                     arrow_leaf_entries=23002584)
# the .opt file of the block-file run: ENERGY_OPTIONS' solver settings in
# the reference's names (the scaler and presolve come as CLI flags)
CLI_OPT = ("MAX_ITERATIONS 300 int\nGONDZIO_MAX_CORRECTORS 1 int\n"
           "REFINEMENT_STEPS 2 int\n")
CLI_RESID = 1e-5        # tests/test_realworld.py:74-77, rows and bounds
# potf2's plain version grows as n^2 small operations (12.0 s at 550):
# at the dissected root's blocks (~6.5k) it would take half an hour.
# There the kernel is held to cholesky_ex within CLI_POTF2_RTOL (max |L -
# L_lib| / max |L_lib|), and bit for bit to the plain version on its
# leading CLI_POTF2_PREFIX columns (dpotf2's order makes them depend on
# the leading block alone; 8 of the kernel's 32-column panels)
CLI_POTF2_RTOL = 1e-10
CLI_POTF2_PREFIX = 256
# the plain LDL version takes one sweep of the trailing matrix per column
# (13k launches at the dissected root): above this edge the check's f64
# reference and plain f32 version are the kernel's blocked algorithm in
# torch operations (`ldl_inverse_factors_blocked_ref`)
LDL_PLAIN_BLOCKED_ABOVE = 2048
# the sweep solve's LP (two_scenario_lp below) and its analytic optimum
SWEEP_OPTIMUM = 7.0
OBJ_RTOL = 1e-3      # the JAX package's f32-vs-f64 bound (test_pallas.py:28)
F64_ORACLE_RTOL = 1e-6
# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32 and f64
# FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Median milliseconds of `fn()` over `reps` timed runs (CUDA events),
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps):
    """Device milliseconds of one `fn()`: the profiler's sum of the device
    time of every kernel, copy and fill that `reps` runs launch, over
    `reps`, after one warm-up run.  Host time between launches is not in
    it, so a kernel of a few microseconds is not hidden behind its
    launch.  The profiler has read no device time at all for runs of one
    ~2 µs kernel: then it measures again over 10 x `reps` runs, and gives
    None (not measured) if it still reads none."""
    fn()
    for n in (reps, 10 * reps):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages())
        if total_us > 0:
            return total_us / 1e3 / n
    return None


def loop_ms(fn, n):
    """Milliseconds per call of `n` back-to-back calls of `fn()` between
    two CUDA events, after one warm-up call: the device time of a call
    where the device keeps up with the host, an upper bound of it where
    the host's launches set the pace."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def timed(fn):
    """`fn()` and its milliseconds between CUDA events (one call, host
    dispatch included)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def timings(kernel, plain, library, reps, plain_reps, check_ms):
    """Device and wall (CUDA events around one call, host dispatch
    included) milliseconds of the kernel, its plain version and, where
    there is one, the library call computing the same function (also over
    back-to-back calls filling LIBRARY_LOOP_BUDGET_MS: `library_loop_ms`).
    The plain version's wall time is its checking call's, `check_ms`; its
    `plain_ms` as PLAIN_PROFILE_BUDGET_MS says."""
    profile = check_ms * (plain_reps + 1) <= PLAIN_PROFILE_BUDGET_MS
    out = dict(ms=device_ms(kernel, reps), wall_ms=cuda_ms(kernel, reps),
               plain_ms=device_ms(plain, plain_reps) if profile
               else check_ms, plain_by="profile" if profile
               else "checking call", plain_wall_ms=check_ms,
               library_ms=None, library_wall_ms=None, library_loop_ms=None)
    if library is not None:
        wall = cuda_ms(library, reps)
        n = int(min(200, max(10, LIBRARY_LOOP_BUDGET_MS / max(wall, 1e-3))))
        out.update(library_ms=device_ms(library, reps),
                   library_wall_ms=wall, library_loop_ms=loop_ms(library, n))
    return out


def bound(nbytes, flops, dtype):
    """The least time (ms) for the work: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- launch counts ---------------------------------------------------------
COUNTED = {"ldl_inverse_f32": ldl.ldl_inverse_factors,
           "ell_spmm": spmv.ell_spmm,
           "sweep_inverse": sweep.sweep_inverse,
           "potf2_f64": potf2.potf2}


def reset_counts():
    for fn in COUNTED.values():
        fn.launches = fn.captured = 0
    spmv.ell_spmm.launches_by.clear()
    batched_pcg.readbacks = batched_pcg.calls = batched_pcg.capped = 0


def read_counts():
    return {name: fn.launches for name, fn in COUNTED.items()}


def read_captured():
    """Launches recorded into captured graphs since the last reset."""
    return {name: fn.captured for name, fn in COUNTED.items()}


def drive(name, run, kernels):
    """Drive one path with every count set to 0 just before it; require a
    launch of each of its `kernels`.  Returns (run's result, counts)."""
    reset_counts()
    out = run()
    torch.cuda.synchronize()
    counts = read_counts()
    out["cg_readbacks"] = batched_pcg.readbacks
    out["cg_calls"] = batched_pcg.calls
    out["cg_capped"] = batched_pcg.capped
    out["ell_launches_by"] = {f"{op}/c={c}": v for (op, c), v in
                              sorted(spmv.ell_spmm.launches_by.items())}
    for k in kernels:
        require(counts[k] > 0, f"{name}: the path launched no {k}")
    return out, counts


# ---- kernel checks against the plain versions --------------------------------
def ldl_input(B, a, n_pos, gen):
    """f64 symmetric quasidefinite batch on the card (SPD when n_pos=a)."""
    R = torch.randn(B, a, a, generator=gen, dtype=torch.float64,
                    device=DEVICE)
    A = R @ R.mT / a + torch.eye(a, dtype=torch.float64, device=DEVICE)
    if n_pos < a:
        A[:, n_pos:, :n_pos] *= 0.5
        A[:, :n_pos, n_pos:] = A[:, n_pos:, :n_pos].mT
        A[:, n_pos:, n_pos:] *= -1.0
    return A


def rel_err(inv, ref_inv):
    diff = (inv.double() - ref_inv).abs().amax()
    return float(diff / ref_inv.abs().amax()), float(diff)


def check_ldl_kernel(shapes=LDL_SHAPES, tag="ldl_check"):
    lib = _build.load()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for B, a, n_pos in shapes:
        A = ldl_input(B, a, n_pos, gen)
        A32 = A.float().contiguous()
        plain = (ldl.ldl_inverse_factors_ref if a <= LDL_PLAIN_BLOCKED_ABOVE
                 else ldl.ldl_inverse_factors_blocked_ref)
        Xr, dr = plain(A)                                   # f64 reference
        ref_inv = ldl.inverse_from_factors(Xr, dr)
        Xk, dk = ldl.ldl_inverse_factors(A32)
        (Xp, dp), check_ms = timed(lambda: plain(A32))      # plain f32
        err_k, abs_k = rel_err(ldl.inverse_from_factors(Xk.double(),
                                                        dk.double()), ref_inv)
        err_p, _ = rel_err(ldl.inverse_from_factors(Xp.double(),
                                                    dp.double()), ref_inv)
        signs = bool(torch.equal(torch.sign(dk.double()), torch.sign(dr)))
        ok = bool(ldl.inverse_ok(Xk, dk, n_pos))
        library = None
        if n_pos == a:
            # the SPD counterpart of the same work in one library pair:
            # Cholesky and the triangular inverse
            eye = torch.eye(a, dtype=torch.float32, device=DEVICE)

            def library():
                L, _ = torch.linalg.cholesky_ex(A32)
                return torch.linalg.solve_triangular(L, eye, upper=False)

        times = timings(lambda: ldl.ldl_inverse_factors(A32),
                        lambda: plain(A32), library, 10, 3, check_ms)
        # LDL^T (a^3/3 flops) + the unit-lower inverse (a^3/3)
        bound_ms, bound_by = bound((2 * B * a * a + B * a) * 4,
                                   B * 2 * a ** 3 / 3, torch.float32)
        row = dict(shape=[B, a, a], n_pos=n_pos, plain=plain.__name__,
                   kernel_rel_err=err_k, plain_f32_rel_err=err_p,
                   kernel_abs_err=abs_k, pivot_signs_equal=signs,
                   inertia_ok=ok, **times, bound_ms=bound_ms,
                   bound_by=bound_by, nb=lib.ldl_inverse_nb(a),
                   cuda_launches_per_call=lib.ldl_inverse_launches(a))
        print(tag, json.dumps(row), flush=True)
        require(err_k <= 4.0 * err_p + 1e-6,
                f"LDL kernel error {err_k:.3e} > 4 x plain {err_p:.3e} + 1e-6 "
                f"at {[B, a, a]}")
        require(signs and ok, f"LDL kernel pivot signs differ at {[B, a, a]}")
        del A, A32, Xr, dr, ref_inv, Xk, dk, Xp, dp
        torch.cuda.empty_cache()
        rows.append(row)
    return rows


def check_potf2_kernel(shapes=POTF2_SHAPES, tag="potf2_check"):
    """The f64 root Cholesky kernel against its plain version on the card
    (the same dpotf2 order in torch operations) at the root shapes: the
    factor must equal the plain version's bit for bit (`torch.equal`),
    with the same info (F3 is a fault of the order of roundings, so
    nothing less than equality holds the order), and every pivot must
    pass; the factor's backward error is reported.  Its `loop_ms` (CUDA
    events over 50 back-to-back calls) is the time the kernels line gives:
    the profiler's device time of the earlier one-CTA kernel read 0.448
    and 0.0448 ms at [1,128,128] in two runs on the same card, while one
    call between CUDA events took 0.48 ms in both."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rows = []
    for B, n in shapes:
        A = ldl_input(B, n, n, gen)
        Lk, ik = potf2.potf2(A)
        (Lp, ip), check_ms = timed(lambda: potf2.cholesky_potf2_ref(A))
        diff = float((Lk - Lp).abs().amax())
        scale = float(Lp.abs().amax())
        backward = float((Lk @ Lk.mT - A).abs().amax() / A.abs().amax())
        times = timings(lambda: potf2.potf2(A),
                        lambda: potf2.cholesky_potf2_ref(A),
                        lambda: torch.linalg.cholesky_ex(A), 10, 1,
                        check_ms)
        times["loop_ms"] = loop_ms(lambda: potf2.potf2(A), 50)
        # A in, L out (n^2 doubles each) and n^3/3 flops per matrix
        bound_ms, bound_by = bound(2 * B * n * n * 8 + B * 4,
                                   B * n ** 3 / 3, torch.float64)
        row = dict(shape=[B, n, n], max_abs_err=diff,
                   exact=bool(torch.equal(Lk, Lp)), rel_err=diff / scale,
                   info_equal=bool(torch.equal(ik, ip)),
                   all_ok=bool((ik == 0).all()), backward_err=backward,
                   **times, bound_ms=bound_ms, bound_by=bound_by,
                   cuda_launches_per_call=_build.load().potf2_launches(n))
        print(tag, json.dumps(row), flush=True)
        require(row["exact"] and row["info_equal"] and row["all_ok"],
                f"potf2 kernel off its plain version at {[B, n, n]}: {row}")
        rows.append(row)
    return rows


def block_csr(val, col, n):
    """The ELL batch as one block-diagonal CSR matrix [N m, N n] (explicit
    zeros dropped), for the library yardstick."""
    N, m, K = val.shape
    rows = torch.arange(N * m, device=val.device).repeat_interleave(K)
    cols = (col.long() + n * torch.arange(N, device=val.device)[:, None,
                                                                  None])
    keep = val.reshape(-1) != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols.reshape(-1)[keep]]),
        val.reshape(-1)[keep], (N * m, N * n))
    return coo.coalesce().to_sparse_csr()


def ell_bound(op, X, Y, epilogue):
    """(ms, "bytes" or "operations") for one product: every nonzero's value
    and column id read once, X, Y and the epilogue's operands once each;
    2 flops per nonzero and column, one per epilogue multiply and add.
    Counted from the nonzeros, so the layout does not move it."""
    e = X.element_size()
    c = X.shape[2]
    extra = sum(t.numel() for t in epilogue.values())
    nbytes = op.nnz * (e + 4) + (X.numel() + Y.numel() + extra) * e
    flops = 2 * op.nnz * c + Y.numel() * (("alpha" in epilogue)
                                          + 2 * ("Z" in epilogue))
    return bound(nbytes, flops, X.dtype)


def ell_cases(be, lp, gen):
    """(label, operator, c, epilogue) of every product the sparse backend
    launches: the CG's merged operators at c = 1 and c = nS, bare and with
    the epilogues `_neq_apply` gives them (transposed with alpha = E^-1,
    forward with beta = F_d and Z = V), and, in f64, the residual
    products' B, D, Bt, Dt at c = 1."""
    dtype = be.factor_dtype
    nS = lp.n0 + lp.mEl + lp.mIl
    a = lp.mE + lp.mI

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype,
                           device=DEVICE)

    out = []
    for c in (1, nS):
        out += [("fwd", be._M, c, {}), ("bwd", be._Mt, c, {}),
                ("sq", be._Msq, c, {})]
        out += [("bwd_alpha", be._Mt, c,
                 dict(alpha=rand(lp.N, lp.n).abs() + 0.1)),
                ("fwd_beta_z", be._M, c,
                 dict(beta=rand(lp.N, a).abs(), Z=rand(lp.N, a, c)))]
    if dtype == torch.float64:
        out += [(name, getattr(be, "_" + name), 1, {})
                for name in ("B", "D", "Bt", "Dt")]
    return out


def check_ell_kernel(slp):
    """The ELL kernel against its plain version on every product the
    sparse backend builds from the scaled 8 x 8192 instance (`ell_cases`),
    in f32 and f64.  Tolerance: max |kernel - plain| <= 1e-5 max |plain| in
    f32 and <= 1e-12 max |plain| in f64 (summation order only); with an
    epilogue the result also equals the kernel's bare product followed by
    the separate torch operations, to the bit.  Prints each operator's
    stored slots against its nonzeros; the transposed one must store at
    most 1.25 slots per nonzero."""
    lp = make_scaler(ScalerType.EQUILIBRIUM).scale(slp.to(DEVICE))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        be = SparseArrowBackend(lp.astype(torch.float64), factor_dtype=dtype)
        for name in ("M", "Mt", "Msq", "B", "D", "Bt", "Dt"):
            op = getattr(be, "_" + name)
            layout = dict(op=name, dtype=str(op.val.dtype).split(".")[-1],
                          padded_shape=list(op.ell.val.shape),
                          padded_slots=op.ell.val.numel(), slots=op.slots,
                          nnz=op.nnz, slots_per_nnz=op.slots / op.nnz,
                          mean_slice_k=float(op.slice_k.double().mean()))
            print("ell_layout", json.dumps(layout), flush=True)
        require(be._Mt.slots <= 1.25 * be._Mt.nnz,
                f"the sliced transpose stores {be._Mt.slots} slots for "
                f"{be._Mt.nnz} nonzeros")
        csrs = {}
        for label, op, c, epi in ell_cases(be, lp, gen):
            X = torch.randn(op.N, op.n, c, generator=gen, dtype=op.val.dtype,
                            device=DEVICE)
            Yk = spmv.ell_spmm(op, X, **epi)
            Yp, check_ms = timed(lambda: spmv.ell_spmm_ref(
                op.ell.val, op.ell.col, X, **epi))
            scale = float(Yp.abs().amax())
            err = float((Yk - Yp).abs().amax())
            row = dict(case=label, op=op.name,
                       dtype=str(op.val.dtype).split(".")[-1],
                       shape=list(op.ell.val.shape), c=c, slots=op.slots,
                       nnz=op.nnz, epilogue=sorted(epi), max_abs_err=err,
                       max_abs_y=scale)
            library = None
            if epi:
                Y0 = spmv.ell_spmm(op, X)
                want = spmv._epilogue(Y0, epi.get("alpha"), epi.get("beta"),
                                      epi.get("Z"))
                row["epilogue_bitwise"] = bool(torch.equal(Yk, want))
            else:
                if op.name not in csrs:
                    csrs[op.name] = block_csr(op.ell.val, op.ell.col, op.n)
                csr, X2 = csrs[op.name], X.reshape(-1, c)
                row["library_abs_err"] = float(
                    (torch.sparse.mm(csr, X2).reshape(Yp.shape)
                     - Yp).abs().amax())
                library = partial(torch.sparse.mm, csr, X2)
            row.update(timings(
                lambda: spmv.ell_spmm(op, X, **epi),
                lambda: spmv.ell_spmm_ref(op.ell.val, op.ell.col, X, **epi),
                library, 20, 5, check_ms))
            row["bound_ms"], row["bound_by"] = ell_bound(op, X, Yp, epi)
            print("ell_check", json.dumps(row), flush=True)
            require(err <= tol * scale,
                    f"ELL kernel error {err:.3e} > {tol} x {scale:.3e} "
                    f"({label}, {dtype}, c={c})")
            require(row.get("epilogue_bitwise", True),
                    f"ELL epilogue differs from the separate operations "
                    f"({label}, {dtype}, c={c})")
            rows.append(row)
        del be, csrs
    torch.cuda.empty_cache()
    return rows


def sweep_bound(B, a):
    """The sweep's bound: A in, X and d out, and a^3 flops per matrix, the
    symmetric rank-nb update's one triangle once per panel."""
    return bound((2 * B * a * a + B * a) * 4, B * a ** 3, torch.float32)


def check_sweep_kernel():
    """The sweep kernel and its plain f32 version against an f64
    torch.linalg.inv: error <= 4 x the plain f32 error + 1e-6, and the
    pivot signs of the quasidefinite inertia."""
    lib = _build.load()
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows = []
    for B, a, n_pos in SWEEP_SHAPES:
        A = ldl_input(B, a, n_pos, gen)
        A32 = A.float().contiguous()
        ref_inv = torch.linalg.inv(A)
        Ik, dk = sweep.sweep_inverse(A32)
        (Ip, _), check_ms = timed(lambda: sweep.sweep_inverse_ref(A32))
        err_k, abs_k = rel_err(Ik, ref_inv)
        err_p, _ = rel_err(Ip, ref_inv)
        ok = bool(ldl.inverse_ok(Ik, dk, n_pos))
        kernel = lambda: sweep.sweep_inverse(A32)           # noqa: E731
        lib_inv = lambda: torch.linalg.inv(A32)             # noqa: E731
        times = timings(kernel, lambda: sweep.sweep_inverse_ref(A32),
                        lib_inv, 10, 3, check_ms)
        bound_ms, bound_by = sweep_bound(B, a)
        row = dict(shape=[B, a, a], n_pos=n_pos, kernel_rel_err=err_k,
                   plain_f32_rel_err=err_p, kernel_abs_err=abs_k,
                   inertia_ok=ok, **times, bound_ms=bound_ms,
                   bound_by=bound_by, cuda_launches_per_call=(
                       lib.sweep_inverse_launches(sweep.padded_edge(a))))
        print("sweep_check", json.dumps(row), flush=True)
        require(err_k <= 4.0 * err_p + 1e-6,
                f"sweep kernel error {err_k:.3e} > 4 x plain {err_p:.3e} "
                f"+ 1e-6 at {[B, a, a]}")
        require(ok, f"sweep kernel pivot signs wrong at {[B, a, a]}")
        del A, A32, ref_inv, Ik, dk, Ip
        torch.cuda.empty_cache()
        rows.append(row)
    return rows


# ---- solves ------------------------------------------------------------------
def two_scenario_lp(dtype):
    """The JAX package's sweep acceptance LP (tests/fixtures.py
    two_scenario_linking_lp): two blocks of two columns with linking
    columns and rows, optimum 7 at x0 = 2.  The JAX package's f32 sweep
    path reaches SUCCESSFUL_TERMINATION on it; on the flagship it does not
    (tests/test_sweep.py)."""
    first = dict(c=np.array([1.0]), A=np.zeros((0, 1)), b=np.zeros(0),
                 C=np.zeros((0, 1)), iclow=np.zeros(0), clow=np.zeros(0),
                 icupp=np.zeros(0), cupp=np.zeros(0), ixlow=np.array([1.0]),
                 xlow=np.array([0.0]), ixupp=np.array([1.0]),
                 xupp=np.array([3.0]), F0=np.array([[1.0]]),
                 G0=np.array([[0.0]]))
    block = dict(c=np.array([1.0, 2.0]), A=np.array([[1.0]]),
                 B=np.array([[1.0, 1.0]]), b=np.array([4.0]),
                 C=np.array([[0.0]]), D=np.array([[1.0, -1.0]]),
                 iclow=np.array([0.0]), clow=np.array([0.0]),
                 icupp=np.array([1.0]), cupp=np.array([2.0]),
                 ixlow=np.ones(2), xlow=np.zeros(2), ixupp=np.ones(2),
                 xupp=np.full(2, 5.0), F=np.array([[1.0, 0.0]]),
                 G=np.array([[0.0, 1.0]]))
    return make_arrowhead_lp(
        [block, dict(block)], first, linking_eq={"b": np.array([5.0])},
        linking_ineq={"iclow": np.array([1.0]), "clow": np.array([1.0]),
                      "icupp": np.array([1.0]), "cupp": np.array([6.0])},
        dtype=dtype, device=DEVICE)


@lru_cache(maxsize=1)
def sparse_lp():
    """The 8 x 8192 sparse instance, f64 data on the host."""
    return random_sparse_arrowhead_lp(0, **SPARSE)


def paths() -> dict:
    """The solve paths: name -> zero-argument builder of (LP, Options,
    backend).  backend None: the facade takes the LP, scales it and picks
    the backend; otherwise the IPMSolver takes the LP on the card as it
    is."""
    f32, f64 = torch.float32, torch.float64
    one = dict(max_gondzio_correctors=1)

    def flagship():
        return (random_arrowhead_lp(0, dtype=f32, **FLAGSHIP),
                Options(scaler=ScalerType.EQUILIBRIUM, factor_dtype="float32",
                        **one), None)

    def bigleaf():
        # the bench's production configuration after equilibrium scaling
        lp = make_scaler(ScalerType.EQUILIBRIUM).scale(
            random_arrowhead_lp(3, dtype=f32, device=DEVICE, **BIGLEAF))
        return (lp, Options(refinement_steps=0, **one),
                partial(ArrowBackend, factor_dtype=f32,
                        factored_inverse=True))

    def sparse_f32():
        # the JAX bench's sparse settings (bench.py:420-435)
        return (sparse_lp(),
                Options(scaler=ScalerType.EQUILIBRIUM, refinement_steps=2,
                        reduced_accuracy=True, factor_dtype="float32", **one),
                None)

    def sparse_f64():
        # the JAX package's acceptance run (tests/test_sparse.py:186-201)
        return (sparse_lp().to(DEVICE), Options(),
                partial(SparseArrowBackend, factor_dtype=f64, cg_iters=500))

    def sweep():
        return (two_scenario_lp(f32), Options(refinement_steps=2),
                partial(ArrowBackend, factor_dtype=f32, sweep_kernel=True))

    def energy_hier3():
        # the 96-block energy LP scaled as its facade runs scale it, in the
        # hierarchical layout at 3 layers (8 groups, then 2), no presolve
        lp = make_scaler(ENERGY_OPTIONS["scaler"]).scale(
            energy_lp(ENERGY["T"])[0])
        groups = _auto_groups(lp.N)
        coarse = _auto_groups(groups)
        hlp, meta = build_hierarchical_lp(
            lp, groups, coarse_levels=(coarse,) if coarse > 1 else ())
        return (hlp, Options(**ENERGY_SOLVER),
                partial(HierArrowBackend, meta=meta, factor_dtype=f64))

    return {fn.__name__: fn
            for fn in (flagship, bigleaf, sparse_f32, sparse_f64, sweep,
                       energy_hier3)}


def facade_run(lp, opts: Options):
    iface = PIPSIPMppTorchInterface(lp, opts, device=DEVICE)
    status = iface.run()
    return dict(status=status, iterations=iface.n_iterations,
                objective=iface.getObjective(),
                solve_s=iface.phase_times["solve"],
                backend=iface.backend_class.__name__,
                x=torch.from_numpy(iface.gatherPrimalSolution()))


def solver_run(lp, backend, opts: Options):
    solver = IPMSolver(backend, opts, device=DEVICE)
    t0 = time.perf_counter()
    res = solver.solve(lp)
    torch.cuda.synchronize()
    x = res.iterate.x
    return dict(status=res.status, iterations=res.iterations,
                objective=res.objective, solve_s=time.perf_counter() - t0,
                x=torch.cat([x.first, x.blocks.reshape(-1)]).cpu())


def path_run(lp, opts, backend):
    """One solve of a path as `paths()` defines it."""
    if backend is None:
        return facade_run(lp, opts)
    return solver_run(lp, backend, opts)


def report(name, out, counts, ref_objective, rtol, n_vars, **extra):
    """Print one path's line and check status, objective and solution."""
    it = out["iterations"]
    rel = abs(out["objective"] - ref_objective) / max(abs(ref_objective), 1.0)
    row = dict(case=name, status=out["status"].name, iterations=it,
               solve_s=out["solve_s"], iter_per_s=it / out["solve_s"],
               launches=counts,
               launches_per_iteration={k: v / max(it, 1)
                                       for k, v in counts.items()},
               cg_readbacks=out["cg_readbacks"],
               cg_readbacks_per_iteration=out["cg_readbacks"] / max(it, 1),
               cg_calls=out["cg_calls"], cg_capped=out["cg_capped"],
               ell_launches_by=out["ell_launches_by"],
               objective=out["objective"], reference_objective=ref_objective,
               objective_rel_diff=rel, **extra)
    print("main_path", json.dumps(row), flush=True)
    require(out["status"] == TerminationStatus.SUCCESSFUL_TERMINATION,
            f"{name}: status {out['status']}")
    require(rel <= rtol, f"{name}: objective off by {rel:.3e} relative")
    x = out["x"]
    require(tuple(x.shape) == (n_vars,) and bool(torch.isfinite(x).all()),
            f"{name}: solution of shape {tuple(x.shape)} not finite")


@dataclass
class Setup:
    """One path ready for an IPMSolver: the LP on the card as the solver
    takes it (scaled, for a facade path), the solver the facade or the
    path builds, and what maps a solution back to the LP as given."""
    lp: object
    solver: IPMSolver
    raw: object
    scaler: object = None

    def objective(self, res) -> float:
        """The objective of a result's iterate on the unscaled LP."""
        x = res.iterate.x
        if self.scaler is not None:
            x = self.scaler.unscale_x(x)
        return float(torch.dot(self.raw.c0.double(), x.first.double())
                     + torch.dot(self.raw.cN.double().reshape(-1),
                                 x.blocks.double().reshape(-1)))


def setup(make, cg_iters=None, **opt_overrides) -> Setup:
    """The solver of one `paths()` entry: for a facade path the LP scaled
    and the solver built as the facade does; `opt_overrides` replace
    options, `cg_iters` the leaf CG's cap of a path with its own sparse
    backend."""
    lp, opts, backend = make()
    opts = opts.replace(**opt_overrides)
    if backend is None:
        if cg_iters is not None:
            raise ValueError("cg_iters needs a path with its own backend")
        iface = PIPSIPMppTorchInterface(lp, opts, device=DEVICE)
        out = Setup(iface.lp, iface._solver, iface.lp)
        if opts.scaler != ScalerType.NONE:
            out.scaler = make_scaler(opts.scaler)
            out.lp = out.scaler.scale(out.lp)
        return out
    if cg_iters is not None:
        backend = partial(backend, cg_iters=cg_iters)
    lp = lp.to(DEVICE)
    return Setup(lp, IPMSolver(backend, opts, device=DEVICE), lp)


def host_launches(fn):
    """Host-side CUDA runtime calls of one `fn()` that put work on the
    card (the profiler's runtime events): kernel launches, graph launches
    and copies or fills.  The profiler does not see the kernels inside a
    replayed graph, and its third session in one process faulted on a
    replay of the sparse graph (ROADMAP.md §3, F4): `fused_host_calls`
    runs it in a fresh process."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    count = lambda *keys: sum(e.count for e in ev           # noqa: E731
                              if any(k in e.key for k in keys))
    return dict(kernel=count("LaunchKernel"), graph=count("GraphLaunch"),
                copy=count("Memcpy", "Memset"))


# the fused loop's paths: name -> (paths() entry, option overrides)
FUSED_PATHS = {"flagship": ("flagship", {}), "bigleaf": ("bigleaf", {}),
               "sparse_f32": ("sparse_f32", {}),
               "flagship_update_every_4": ("flagship",
                                           dict(residual_update_every=4)),
               # the solve modes (`solve_modes_phase`): outer BiCGStab in
               # f32 (LDL kernel), and in f64 the iterative root (panels
               # [2, 64, 64]) with the blockwise Schur complement
               "flagship_bicgstab": ("flagship", dict(outer_bicgstab=True)),
               "flagship_precond_blockwise_f64": (
                   "flagship", dict(factor_dtype="float64",
                                    iterative_root_panel=64,
                                    sc_blockwise=64)),
               # the hierarchy at 3 layers on the energy LP, f64
               # (`hier_phase`)
               "energy_hier3": ("energy_hier3", {})}


# the fused batch (`IPMSolver.solve_fused_batch_async`): name -> (paths()
# entry, B).  The LPs are the bench's batch of its stream
# (`stream_lps`); the big leaf's B = 4 is the bench's half stream of 8
# scaled to its 16x larger leaves.
BATCH_PATHS = {"flagship_batch8": ("flagship", 8),
               "bigleaf_batch4": ("bigleaf", 4)}
# the LDL kernel at the batches' shapes: all B N leaves in one call and
# the B roots in one call
BATCH_LDL_SHAPES = [(512, 256, 256), (8, 192, 64), (256, 1024, 1024),
                    (4, 192, 64)]


def stream_lps(lp, k):
    """The bench's stream of k LPs from one (bench.py:_stream_lps): costs
    times 1 + 1e-5 i."""
    return [dataclasses.replace(lp, c0=lp.c0 * (1.0 + 1e-5 * i),
                                cN=lp.cN * (1.0 + 1e-5 * i))
            for i in range(k)]


def batch_rows(info) -> list:
    """Per LP [status, iterations, objective, turns] of a batch's info, in
    one fetch."""
    return torch.stack([info["status"].double(),
                        info["iterations"].double(), info["objective"],
                        info["turns"].double()], -1).tolist()


def batch_graph(solver, B):
    """The solver's captured graph of a batch of B."""
    return next(g for g in solver._graphs.values()
                if g.be.batch_shape == (B,))


# batches whose f32 solves turn on rounding (ROADMAP.md §3, R1): an LP of
# such a batch may part from its single solve by up to BATCH_ROUNDING_RTOL
# relative in the objective (the singles part by up to 1.2e-6 under
# rounding noise; neighbouring LPs of `stream_lps` lie ~1e-5 apart), its
# objective must be nearer its own single's than any other LP's, and it
# may take one iteration more or fewer than its single solve only where,
# in the same run, that single solve takes the batch's count under
# BATCH_NOISE relative noise on its data (`noise_counts`: draws until one
# does, at most BATCH_NOISE_DRAWS; on the card each flagship single took
# another count in 1 to 3 draws of 24, so 128 draws all miss a count met
# once in 24 with probability 0.4%)
BATCH_ROUNDING = {"flagship_batch8": "R1", "bigleaf_batch4": "R1"}
BATCH_ROUNDING_RTOL = 3e-6
BATCH_NOISE = 1e-16
BATCH_NOISE_DRAWS = 128


def noisy_lp(lp, gen):
    """`lp` in f64 with each data entry (not the 0/1 masks) times
    1 + BATCH_NOISE E, E standard normal drawn from `gen`."""
    lp = lp.astype(torch.float64)

    def jitter(t):
        return t * (1 + BATCH_NOISE * torch.randn(
            t.shape, generator=gen, dtype=t.dtype, device=t.device))
    return dataclasses.replace(lp, **{
        f.name: jitter(getattr(lp, f.name)) for f in dataclasses.fields(lp)
        if not f.name.startswith("i")})


def noise_counts(solver, lp, target, seed, draws=BATCH_NOISE_DRAWS):
    """Iteration counts of `lp`'s single fused solve (the captured single
    graph, replayed) under `noisy_lp`, draw by draw, until one takes
    `target` iterations or `draws` are spent."""
    gen = torch.Generator(device=lp.device).manual_seed(seed)
    seen = []
    while len(seen) < draws and target not in seen:
        seen.append(solver.solve_fused(noisy_lp(lp, gen)).iterations)
    return seen


def fused_batch(name, st: Setup, B, kernels):
    """B LPs of the bench's stream (`stream_lps`) as one captured batch
    graph, each LP held to its own `solve_fused` (the single graph,
    replayed): the same status and iterations, the objective within 1e-8
    relative; in a batch of `BATCH_ROUNDING` (f32 solves that turn on
    rounding) within BATCH_ROUNDING_RTOL and nearer its own single's than
    any other LP's, and one iteration apart only where its single takes
    the batch's count under noise (`noise_counts`).  The same LPs in
    reverse order must give each LP the same answer, bit for bit.  Then,
    warm, the stream of the same LPs through `solve_fused_async` (queued,
    one fetch) and the batch, in turns (stream, batch, batch, stream),
    each timed on the host clock to its fetch; the batch graph's replay
    alone (CUDA events), per loop trip; the first call (warm-up turn,
    capture and solve); and the peak device memory of the first call."""
    t_phase = time.perf_counter()
    lps = stream_lps(st.lp, B)
    singles = [st.solver.solve_fused(lp) for lp in lps]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    _, info = st.solver.solve_fused_batch_async(lps)
    rows = batch_rows(info)
    first_s = time.perf_counter() - t0
    counts, captured = read_counts(), read_captured()
    peak = torch.cuda.max_memory_allocated()
    times = {"stream": [], "batch": []}
    for turn in ("stream", "batch", "batch", "stream"):
        t0 = time.perf_counter()
        if turn == "stream":
            outs = [st.solver.solve_fused_async(lp) for lp in lps]
            torch.stack([o[1]["iterations"] for o in outs]).tolist()
        else:
            _, warm_info = st.solver.solve_fused_batch_async(lps)
            warm = batch_rows(warm_info)
        times[turn].append(time.perf_counter() - t0)
    dev_ms = cuda_ms(batch_graph(st.solver, B).graph.replay, 1)
    batch_s = statistics.median(times["batch"])
    stream_s = statistics.median(times["stream"])
    iters = sum(int(r[1]) for r in rows)
    trips = max(int(r[3]) for r in rows)
    _, rev_info = st.solver.solve_fused_batch_async(lps[::-1])
    reversed_rows = batch_rows(rev_info)[::-1]
    rounding = name in BATCH_ROUNDING
    objs = [s.objective for s in singles]
    per_lp = []
    for i, (s, r) in enumerate(zip(singles, rows)):
        rel = abs(r[2] - s.objective) / max(abs(s.objective), 1.0)
        nearest = min(range(B), key=lambda j: abs(r[2] - objs[j]))
        noisy = (noise_counts(st.solver, lps[i], int(r[1]), seed=i)
                 if rounding and abs(int(r[1]) - s.iterations) == 1
                 else [])
        per_lp.append(dict(lp=i, status=int(r[0]), iterations=int(r[1]),
                           turns=int(r[3]), single_status=s.status.name,
                           single_iterations=s.iterations, objective=r[2],
                           objective_rel_single=rel, nearest_single=nearest,
                           noisy_single_iterations=noisy,
                           exact=(int(r[1]) == s.iterations
                                  and rel <= 1e-8)))
    out = dict(case=name, B=B, graph=info["graph"],
               graphs=len(st.solver._graphs), lps=per_lp,
               first_solve_s=first_s, capture_s=first_s - batch_s,
               batch_s=batch_s, batch_s_all=times["batch"],
               stream_s=stream_s, stream_s_all=times["stream"],
               batch_solves_per_s=B / batch_s,
               stream_solves_per_s=B / stream_s,
               batch_iter_per_s=iters / batch_s,
               stream_iter_per_s=sum(s.iterations for s in singles)
               / stream_s,
               graph_ms=dev_ms, loop_trips=trips,
               graph_ms_per_trip=dev_ms / trips,
               peak_memory_gb=peak / 1e9, launches=counts,
               captured_launches=captured,
               rounding_fault=BATCH_ROUNDING.get(name),
               reversed_same=reversed_rows == rows,
               phase_s=time.perf_counter() - t_phase)
    print("fused_batch", json.dumps(out), flush=True)
    require(info["graph"], f"{name}: the batch was not captured")
    require(len(st.solver._graphs) == 2,
            f"{name}: {len(st.solver._graphs)} graphs, not the single "
            f"solve's and the batch's")
    for k in kernels:
        require(captured[k] > 0, f"{name}: no {k} launch in the graph")
    for r in per_lp:
        require(r["status"] == 1
                and r["single_status"] == "SUCCESSFUL_TERMINATION",
                f"{name}: LP {r['lp']} did not succeed: {r}")
        require(r["exact"] or (
            rounding and r["objective_rel_single"] <= BATCH_ROUNDING_RTOL
            and r["nearest_single"] == r["lp"]
            and (r["iterations"] == r["single_iterations"]
                 or r["iterations"] in r["noisy_single_iterations"])),
            f"{name}: LP {r['lp']} of the batch off its single solve: {r}")
    require(reversed_rows == rows,
            f"{name}: the LPs in reverse order gave {reversed_rows}, in "
            f"order {rows}")
    require(warm == rows, f"{name}: the replay gave {warm}, the first "
                          f"solve {rows}")
    return counts, out


def graph_ms(solver, reps=3):
    """Device milliseconds of one replay of the solver's captured graph
    (CUDA events around the replay alone; its inputs as they stand), the
    median of `reps`."""
    (fused,) = solver._graphs.values()
    return cuda_ms(fused.graph.replay, reps)


def fused_host_calls(names) -> dict:
    """`profile_port.py --fused NAME --reps 1` for every name, each in a
    fresh process (`host_launches`), all started at once and all ended
    before this returns (so that no other timing shares the card with
    them): {name: its host CUDA calls per solve}."""
    here = Path(__file__).resolve().parent
    procs = {name: subprocess.Popen(
        [sys.executable, str(here / "profile_port.py"), "--fused", name,
         "--reps", "1"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=here) for name in names}
    calls = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            require(proc.returncode == 0, f"profile_port.py --fused {name} "
                                          f"failed:\n{out[-2000:]}"
                                          f"{err[-4000:]}")
            calls[name] = json.loads(next(
                line for line in out.splitlines()
                if line.startswith("{")))["host_calls_per_solve"]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return calls


def eager_fused(st: Setup):
    """The fused loop's algorithm run eagerly on the card (no capture):
    `device_loop.solve_on_device` over the backend `solve_fused` builds."""
    from types import SimpleNamespace

    from pips_ipmpp_tpu_torch.ipm.device_loop import (decode_status,
                                                      solve_on_device)
    from pips_ipmpp_tpu_torch.ipm.solver import WORKING_DTYPE

    be = st.solver.be_ctor(st.lp.to(DEVICE).astype(WORKING_DTYPE))
    _, info = solve_on_device(be, st.solver.opts)
    return SimpleNamespace(status=decode_status(int(info["status"])),
                           iterations=int(info["iterations"]),
                           objective=float(info["objective"]))


def fused_twin(name, st: Setup, f64_objective, rtol, kernels, calls):
    """The host loop and the fused loop on one solver and LP: the fused
    solve captured (first call), then replayed warm.  Each kernel of
    `kernels` must be launched into the graph; the fused solve must have
    its twin's status and iterations, an objective within 1e-6 of its,
    and be within `rtol` of the f64 objective.  The twin is the host
    loop, or, where the options ask for carried residuals
    (`residual_update_every`, which the host loop does not read, as in
    the JAX package), the same fused loop run eagerly.  `calls`: the
    host CUDA calls of one warm solve (`fused_host_calls`)."""
    reset_counts()
    t0 = time.perf_counter()
    host = st.solver.solve(st.lp)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    twin = host
    if st.solver.opts.residual_update_every:
        twin = eager_fused(st)
    t0 = time.perf_counter()
    fused = st.solver.solve_fused(st.lp)
    first_s = time.perf_counter() - t0
    counts, captured = read_counts(), read_captured()
    t0 = time.perf_counter()
    warm = st.solver.solve_fused(st.lp)
    warm_s = time.perf_counter() - t0
    dev_ms = graph_ms(st.solver, reps=1)
    obj = st.objective(fused)
    rel_host = abs(fused.objective - twin.objective) / max(
        abs(twin.objective), 1.0)
    rel_f64 = abs(obj - f64_objective) / max(abs(f64_objective), 1.0)
    it = fused.iterations
    row = dict(case=name, graph=fused.info["graph"], status=fused.status.name,
               iterations=it, turns=fused.info["turns"],
               host_status=host.status.name, host_iterations=host.iterations,
               host_solve_s=host_s, twin="host" if twin is host else "eager",
               twin_iterations=twin.iterations, first_solve_s=first_s,
               solve_s=warm_s, iter_per_s=it / warm_s, objective=obj,
               objective_rel_twin=rel_host, f64_objective=f64_objective,
               objective_rel_f64=rel_f64, launches=counts,
               captured_launches=captured, host_calls_per_solve=calls,
               graph_ms=dev_ms, device_ms_per_iteration=dev_ms / max(it, 1),
               busy_share=dev_ms / 1e3 / warm_s)
    print("fused", json.dumps(row), flush=True)
    require(fused.info["graph"], f"{name}: the fused solve was not captured")
    for k in kernels:
        require(captured[k] > 0, f"{name}: no {k} launch in the graph")
    require(fused.status == twin.status
            and fused.iterations == twin.iterations,
            f"{name}: fused {fused.status.name} in {it} iterations, its "
            f"twin {twin.status.name} in {twin.iterations}")
    require(fused.status == TerminationStatus.SUCCESSFUL_TERMINATION
            and host.status == TerminationStatus.SUCCESSFUL_TERMINATION,
            f"{name}: status {fused.status}, host loop {host.status}")
    require(rel_host <= 1e-6, f"{name}: fused objective off its twin's "
                              f"by {rel_host:.3e} relative")
    require(rel_f64 <= rtol, f"{name}: fused objective off f64 by "
                             f"{rel_f64:.3e} relative")
    require(warm.iterations == it and warm.objective == fused.objective,
            f"{name}: the replay gave {warm.iterations} iterations, "
            f"objective {warm.objective}")
    return counts, row


def fused_stream(st: Setup, seeds):
    """A stream of flagship LPs (one per seed, same shapes) queued through
    `solve_fused_async` and fetched once, each against its host loop."""
    lps = [st.scaler.scale(random_arrowhead_lp(
        s, dtype=torch.float32, device=DEVICE, **FLAGSHIP)) for s in seeds]
    hosts = [st.solver.solve(lp) for lp in lps]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [st.solver.solve_fused_async(lp) for lp in lps]
    queued_s = time.perf_counter() - t0
    got = torch.stack([torch.stack([info["status"].double(),
                                    info["iterations"].double(),
                                    info["objective"]])
                       for _, info in outs]).tolist()
    stream_s = time.perf_counter() - t0
    rows = []
    for s, host, (status, its, obj), (_, info) in zip(seeds, hosts, got,
                                                       outs):
        rel = abs(obj - host.objective) / max(abs(host.objective), 1.0)
        rows.append(dict(seed=s, graph=info["graph"], status=int(status),
                         iterations=int(its), host_iterations=host.iterations,
                         objective_rel_host=rel))
        require(info["graph"] and int(status) == 1
                and host.status == TerminationStatus.SUCCESSFUL_TERMINATION
                and int(its) == host.iterations and rel <= 1e-6,
                f"fused stream seed {s}: status {int(status)}, {int(its)} "
                f"iterations, objective off the host loop's by {rel:.3e} "
                f"(host {host.status.name} in {host.iterations})")
    out = dict(case="flagship_stream", lps=len(seeds), queued_s=queued_s,
               stream_s=stream_s, solves_per_s=len(seeds) / stream_s,
               rows=rows)
    print("fused_stream", json.dumps(out), flush=True)
    return out


# golden instances that may miss the acceptance on the card, each with the
# open fault of ROADMAP.md §3 that it shows.  None since the root's f64
# Cholesky runs in LAPACK's order on the card (the potf2 kernel), which
# closed F3: hier_approach_4blocks_2by2 and singletonInequalityColumn_B1
# missed it under cuSOLVER's potrf.
GOLDEN_OPEN: dict = {}


def golden_phase():
    """The 26 GAMSsmall instances (tests/data/gamssmall) in f64 through the
    host loop and the fused loop on the card: every fused solve captured,
    with the host loop's status and iterations and its objective to 1e-6,
    and both loops held to PIPS-IPM++'s acceptance (SUCCESSFUL_TERMINATION,
    objective within 1e-4 of the recorded one, at most ceil(1.1 x
    recorded) iterations).  The instances of `GOLDEN_OPEN` are the only
    ones allowed to miss it: an open fault of the port on the card
    (ROADMAP.md §3), reported per instance."""
    import math

    from pips_ipmpp_tpu_torch.io.blockfile import read_blocks

    data = Path(__file__).resolve().parent / "tests" / "data" / "gamssmall"
    manifest = json.loads((data / "manifest.json").read_text())
    failed = []
    for e in manifest:
        lp = read_blocks(str(data / e["name"]), n_blocks=e["n_files"],
                         device=DEVICE)
        solver = IPMSolver(partial(ArrowBackend, factor_dtype=torch.float64),
                           Options(), device=DEVICE)
        host = solver.solve(lp)
        fused = solver.solve_fused(lp)
        budget = math.ceil(1.1 * e["iterations"])

        def accepted(r):
            return (r.status == TerminationStatus.SUCCESSFUL_TERMINATION
                    and abs(r.objective - e["objective"]) < 1e-4
                    and r.iterations <= budget)

        row = dict(name=e["name"], graph=fused.info["graph"],
                   status=fused.status.name, iterations=fused.iterations,
                   host_iterations=host.iterations, recorded=e["iterations"],
                   budget=budget, objective=fused.objective,
                   recorded_objective=e["objective"],
                   objective_rel_host=abs(fused.objective - host.objective)
                   / max(abs(host.objective), 1.0),
                   accepted=accepted(fused), host_accepted=accepted(host))
        print("golden", json.dumps(row), flush=True)
        require(fused.info["graph"], f"{e['name']}: not captured")
        require(fused.status == host.status
                and fused.iterations == host.iterations
                and row["objective_rel_host"] <= 1e-6,
                f"{e['name']}: fused {row} off the host loop")
        if not (row["accepted"] and row["host_accepted"]):
            require(e["name"] in GOLDEN_OPEN,
                    f"{e['name']}: misses the manifest's acceptance {row}")
            failed.append(e["name"])
    return dict(instances=len(manifest), graphs=len(manifest),
                accepted=len(manifest) - len(failed), not_accepted=failed,
                open_faults={k: GOLDEN_OPEN[k] for k in failed})


def gather_all(iface, lp) -> dict:
    """Every gather accessor of a facade that ran: each must return a
    finite array of its original-space size, and the complementarity
    products of the gathered solution stay within the bound the facade
    holds them to (COMPLEMENTARITY_BOUND, that of tests/test_interface.py).
    Returns the accessors' seconds (the first pays the postsolve)."""
    sizes = dict(vars=lp.total_vars(), eq=lp.total_eq(),
                 ineq=lp.total_ineq())
    secs = {}
    for name, space in GATHERS.items():
        t0 = time.perf_counter()
        v = getattr(iface, name)()
        secs[name] = time.perf_counter() - t0
        require(v.shape == (sizes[space],) and bool(torch.isfinite(
            torch.from_numpy(v)).all()),
            f"{name}: shape {v.shape} (want {sizes[space]}) or not finite")
    cols, eq, ineq = iface.allgatherBlocksizes()
    require((int(cols.sum()), int(eq.sum()), int(ineq.sum()))
            == (sizes["vars"], sizes["eq"], sizes["ineq"]),
            "allgatherBlocksizes disagrees with the LP's sizes")
    norms = iface.printComplementarityResiduals()
    require(max(norms.values()) <= COMPLEMENTARITY_BOUND,
            f"complementarity products {norms} above "
            f"{COMPLEMENTARITY_BOUND:g}")
    return secs


def energy_lp(T):
    """The energy LP with T blocks on the card in f64, built by the port's
    own generator, and the seconds that took."""
    from pips_ipmpp_tpu_torch.io import energy

    t0 = time.perf_counter()
    blocks, first, leq, liq, _ = energy.dispatch_blocks(**dict(ENERGY, T=T))
    lp = make_arrowhead_lp(blocks, first, leq, liq, dtype=torch.float64,
                           device=DEVICE)
    torch.cuda.synchronize()
    return lp, time.perf_counter() - t0


def energy_run(lp, opts: Options, all_gathers=False):
    """The facade's whole pipeline on an energy LP, then the primal
    gathers (they replay the primal reductions alone) or, with
    `all_gathers`, every gather."""
    iface = PIPSIPMppTorchInterface(lp, opts, device=DEVICE)
    status = iface.run()
    solved = dict(status=status.name, iterations=iface.n_iterations,
                  mu=iface.result.mu, residual=iface.result.residual_norm,
                  phase_times=iface.phase_times)
    print("energy_solved", json.dumps(solved), flush=True)
    require(status == TerminationStatus.SUCCESSFUL_TERMINATION,
            f"energy: {solved}")
    t0 = time.perf_counter()
    objective = iface.getObjective()
    eq_resid = float(abs(iface.gatherPrimalResidsEQ()).max())
    x = iface.gatherPrimalSolution()
    require(x.shape == (lp.total_vars(),) and bool(torch.isfinite(
        torch.from_numpy(x)).all()), f"energy: x of shape {x.shape}")
    primal_gathers_s = time.perf_counter() - t0
    gather_s = gather_all(iface, lp) if all_gathers else {}
    return dict(status=status, iterations=iface.n_iterations,
                objective=objective, eq_resid=eq_resid,
                stats=iface._presolve_log.stats,
                phase_times=dict(iface.phase_times),
                primal_gathers_s=primal_gathers_s,
                all_gathers_s=sum(gather_s.values()),
                shapes=energy_shapes(iface._presolve_log.lp))


def energy_shapes(lp) -> dict:
    """The kernels' shapes on this LP, as the backend builds them: the
    condensed leaves [N, mE + mI, mE + mI] (SPD) and the quasidefinite
    root [1, n0 + nD, n0 + nD] with n0 positive pivots for the LDL
    kernel; the two-level root's blocks S11 [n0, n0] and the dual Schur
    complement [nD, nD] for potf2 (nD = m0E + m0I + mEl + mIl)."""
    nD = lp.m0E + lp.m0I + lp.mEl + lp.mIl
    return dict(ldl=[(lp.N, lp.mE + lp.mI, lp.mE + lp.mI),
                     (1, lp.n0 + nD, lp.n0)],
                potf2=[(1, lp.n0), (1, nD)])


def energy_phase():
    """The facade's full pipeline at full size: the energy LP through
    presolve, geometric + equilibrium scaling, the solve and the
    postsolve, then every gather, with f64 factors (held to the HiGHS
    objective and the equality residual of tests/test_realworld.py) and
    with the card's default f32 factors (held to the f64 objective)."""
    from pips_ipmpp_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.build()
    require(native.available(), f"native presolve library: "
            f"{native.build_error}")
    build_s = time.perf_counter() - t0
    lp, gen_s = energy_lp(ENERGY["T"])
    rows = {}
    for name, extra, kernels in (
            ("energy_f64", dict(factor_dtype="float64"), ["potf2_f64"]),
            ("energy_f32", {}, ["ldl_inverse_f32"])):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, counts = drive(name, partial(energy_run, lp, Options(
            **ENERGY_OPTIONS, **extra)), kernels)
        out.pop("ell_launches_by")
        row = dict(case=name, native_library=lib.name,
                   native_build_s=build_s, generate_s=gen_s,
                   total_s=time.perf_counter() - t0, launches=counts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   **{k: v for k, v in out.items() if k != "status"},
                   status=out["status"].name,
                   oracle=ENERGY_ORACLE,
                   oracle_rel=abs(out["objective"] - ENERGY_ORACLE)
                   / abs(ENERGY_ORACLE))
        rows[name] = row
        print("energy", json.dumps(row), flush=True)
        require(out["stats"] == ENERGY_PRESOLVE_STATS,
                f"{name}: presolve stats {out['stats']} are not the JAX "
                f"package's {ENERGY_PRESOLVE_STATS}")
        if name == "energy_f64":
            require(row["oracle_rel"] <= F64_ORACLE_RTOL,
                    f"{name}: objective {out['objective']} off the HiGHS "
                    f"objective by {row['oracle_rel']:.3e} relative")
            require(out["eq_resid"] < ENERGY_EQ_RESID,
                    f"{name}: max |A x - b| = {out['eq_resid']:.3e}")
        else:
            f64 = rows["energy_f64"]["objective"]
            rel = abs(out["objective"] - f64) / abs(f64)
            row["f64_rel"] = rel
            require(rel <= OBJ_RTOL, f"{name}: objective {out['objective']} "
                    f"off the f64 objective {f64} by {rel:.3e}")
    # every gather, the dual ones through the whole postsolve, on the same
    # LP cut to ENERGY_GATHER_T blocks (full width), f64 factors
    del lp
    torch.cuda.empty_cache()
    small, _ = energy_lp(ENERGY_GATHER_T)
    t0 = time.perf_counter()
    out, counts = drive("energy_gathers", partial(
        energy_run, small, Options(**ENERGY_OPTIONS,
                                   factor_dtype="float64"),
        all_gathers=True), ["potf2_f64"])
    row = dict(case="energy_gathers", T=ENERGY_GATHER_T,
               total_s=time.perf_counter() - t0, launches=counts,
               status=out["status"].name, iterations=out["iterations"],
               objective=out["objective"], eq_resid=out["eq_resid"],
               stats=out["stats"], phase_times=out["phase_times"],
               primal_gathers_s=out["primal_gathers_s"],
               all_gathers_s=out["all_gathers_s"])
    rows["energy_gathers"] = row
    print("energy", json.dumps(row), flush=True)
    require(out["eq_resid"] < ENERGY_EQ_RESID,
            f"energy_gathers: max |A x - b| = {out['eq_resid']:.3e}")
    return rows


# ---- the entry points: the gmspips CLI on block files and on MPS ------------
def host_rss() -> int:
    """The process's resident set in bytes (/proc/self/statm, read only)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class HostPeak:
    """The resident set of the process when the block starts (`start`)
    and its largest while the block runs (`peak`), sampled every 20 ms by
    a thread that the block's end stops."""

    def __enter__(self):
        self.start = self.peak = host_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, host_rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss())


def run_cli(argv, codes=(0,)) -> dict:
    """`pips_ipmpp_tpu_torch.cli.main(argv)` as a user runs it (on the
    card, its default), its standard output captured: return code, the
    lines it ends on and its wall seconds; a code outside `codes` fails."""
    from pips_ipmpp_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    require(rc in codes, f"cli {argv}: exit code {rc}; {lines[-5:]}")
    out = dict(rc=rc, seconds=seconds)
    for key in ("auto-structure:", "optimal objective:", "solve time:",
                "termination:", "OK:"):
        out[key] = next((ln for ln in lines if ln.startswith(key)), None)
    if out["optimal objective:"]:
        out["objective"] = float(out["optimal objective:"].split(":")[1])
        out["iterations"] = int(out["solve time:"].rsplit(":", 1)[1])
    return out


def primal_residuals(x, flat) -> dict:
    """c'x and the primal residuals of x in the original order of the
    flat LP `flat` (io/energy.to_scipy's matrices)."""
    c, A_eq, b_eq, A_ub, lb_ub, ub_ub, lo, hi = flat
    act = A_ub @ x
    return dict(cx=float(c @ x),
                eq_resid=float(abs(A_eq @ x - b_eq).max()),
                ineq_violation=float(max((act - ub_ub).max(),
                                         (lb_ub - act).max(), 0.0)),
                bound_violation=float(max((lo - x).max(), (x - hi).max(),
                                          0.0)))


def check_potf2_large(shapes, tag="potf2_cli_check"):
    """The potf2 kernel at root edges where its plain version would take
    half an hour: held to `cholesky_ex` within CLI_POTF2_RTOL, every pivot
    passing, and bit for bit to the plain version on the leading
    CLI_POTF2_PREFIX columns (the plain version timed by that call
    between CUDA events)."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rows = []
    m = CLI_POTF2_PREFIX
    for B, n in shapes:
        A = ldl_input(B, n, n, gen)
        Lk, ik = potf2.potf2(A)
        Ll, il = torch.linalg.cholesky_ex(A)
        scale = float(Ll.abs().amax())
        diff = float((Lk - Ll).abs().amax())
        row = dict(shape=[B, n, n], library_max_abs_diff=diff,
                   library_rel_diff=diff / scale,
                   all_ok=bool((ik == 0).all() and (il == 0).all()),
                   backward_err=float((Lk @ Lk.mT - A).abs().amax()
                                      / A.abs().amax()))
        (Lp, _), prefix_ms = timed(lambda: potf2.cholesky_potf2_ref(
            A[:, :m, :m].contiguous()))
        row.update(prefix=m, prefix_exact=bool(torch.equal(
            Lk[:, :m, :m], Lp)), max_abs_err=float(
            (Lk[:, :m, :m] - Lp).abs().amax()),
            prefix_plain_wall_ms=prefix_ms)
        kern = lambda: potf2.potf2(A)                      # noqa: E731
        lib = lambda: torch.linalg.cholesky_ex(A)          # noqa: E731
        bound_ms, bound_by = bound(2 * B * n * n * 8 + B * 4,
                                   B * n ** 3 / 3, torch.float64)
        row.update(ms=device_ms(kern, 5), wall_ms=cuda_ms(kern, 5),
                   loop_ms=loop_ms(kern, 10), plain_ms=None,
                   library_ms=device_ms(lib, 5),
                   library_wall_ms=cuda_ms(lib, 5), bound_ms=bound_ms,
                   bound_by=bound_by,
                   cuda_launches_per_call=_build.load().potf2_launches(n))
        print(tag, json.dumps(row), flush=True)
        require(row["all_ok"] and row["library_rel_diff"] <= CLI_POTF2_RTOL
                and row["prefix_exact"],
                f"potf2 kernel at {[B, n, n]}: {row}")
        del A, Lk, Ll
        torch.cuda.empty_cache()
        rows.append(row)
    return rows


def cli_phase(energy_f32_iterations):
    """The entry points users come in by, as they run them on the card
    (f32 factors, the CLI's default there):
      - cli_blocks: the 96-block energy LP written as block files, checked
        (`--check`) and solved by `97 stem stepLp scaleGeo presolve
        FILE.opt` (ENERGY_OPTIONS' settings), held to ENERGY_ORACLE;
      - cli_mps: the T = 24 energy LP written as MPS and solved by `--mps
        F --auto-blocks 24 printsol` (f32 leaves through the LDL kernel,
        the 13k-wide root in f64 through potf2: `interface.ROOT_F32_MAX`):
        the structure the JAX package finds, the objective to
        CLI_ENERGY_ORACLE, the written solution's residuals in the MPS
        order;
      - cli_mps_f64: the same dissected LP through the facade with the
        CLI's options and f64 factors (potf2 at the ~9.3k-wide root's
        S11 and dual Schur complement), held to HiGHS within 1e-6 and its
        recovered x to the rows and bounds;
    then the LDL kernel at the dissected LP's leaf shape and at its root's
    width, and the potf2 kernel at its root blocks.  Returns (rows, launch counts, LP
    shapes)."""
    from tempfile import TemporaryDirectory

    from pips_ipmpp_tpu_torch import native
    from pips_ipmpp_tpu_torch.core.dissect import (auto_structure,
                                                   structure_report)
    from pips_ipmpp_tpu_torch.core.options import StepMode
    from pips_ipmpp_tpu_torch.io import energy
    from pips_ipmpp_tpu_torch.io.blockfile import write_blocks
    from pips_ipmpp_tpu_torch.io.mps import read_mps

    t_phase = time.perf_counter()
    native.build()
    require(native.available(), f"native library: {native.build_error}")
    total = dict.fromkeys(COUNTED, 0)
    rows = {}
    with TemporaryDirectory() as tmp:
        # ---- block files, the 96-block energy LP ----
        lp, gen_s = energy_lp(ENERGY["T"])
        stem = f"{tmp}/energy"
        t0 = time.perf_counter()
        write_blocks(lp, stem)
        write_s = time.perf_counter() - t0
        n_blocks = lp.N + 1
        del lp
        opt = Path(tmp) / "energy.opt"
        opt.write_text(CLI_OPT)
        check = run_cli(["--check", stem])
        require(check["OK:"] is not None, f"--check: {check}")
        torch.cuda.reset_peak_memory_stats()
        with HostPeak() as rss:
            out, counts = drive("cli_blocks", partial(run_cli, [
                str(n_blocks), stem, "stepLp", "scaleGeo", "presolve",
                str(opt)]), ["ldl_inverse_f32"])
        row = dict(case="cli_blocks", blocks=n_blocks - 1,
                   generate_s=gen_s, write_s=write_s,
                   check_s=check["seconds"], cli_s=out["seconds"],
                   solve_line=out["solve time:"],
                   iterations=out["iterations"],
                   energy_f32_iterations=energy_f32_iterations,
                   objective=out["objective"], oracle=ENERGY_ORACLE,
                   oracle_rel=abs(out["objective"] - ENERGY_ORACLE)
                   / abs(ENERGY_ORACLE), launches=counts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   host_rss_start_bytes=rss.start,
                   host_rss_peak_bytes=rss.peak)
        rows["cli_blocks"] = row
        print("cli", json.dumps(row), flush=True)
        require(row["oracle_rel"] <= OBJ_RTOL,
                f"cli_blocks: objective off HiGHS: {row}")
        for k, v in counts.items():
            total[k] += v

        # ---- MPS with automatic structure discovery, T = 24 ----
        blocks, first, leq, liq, _ = energy.dispatch_blocks(
            **dict(ENERGY, T=CLI_T))
        flat = energy.to_scipy(blocks, first, leq, liq)
        path = f"{tmp}/energy{CLI_T}.mps"
        t0 = time.perf_counter()
        energy.write_mps(path, blocks, first, leq, liq)
        write_s = time.perf_counter() - t0
        del blocks, first, leq, liq
        torch.cuda.reset_peak_memory_stats()
        with HostPeak() as rss:
            out, counts = drive("cli_mps", partial(run_cli, [
                "--mps", path, "--auto-blocks", str(CLI_T), "printsol"]),
                ["ldl_inverse_f32", "potf2_f64"])
        structure = ast.literal_eval(
            out["auto-structure:"].split(":", 1)[1].strip())
        x = np.load(f"{tmp}/energy{CLI_T}_solution.npz")["x"]
        row = dict(case="cli_mps", T=CLI_T, write_s=write_s,
                   mps_bytes=os.path.getsize(path), cli_s=out["seconds"],
                   structure=structure, solve_line=out["solve time:"],
                   iterations=out["iterations"], objective=out["objective"],
                   oracle=CLI_ENERGY_ORACLE,
                   oracle_rel=abs(out["objective"] - CLI_ENERGY_ORACLE)
                   / abs(CLI_ENERGY_ORACLE), **primal_residuals(x, flat),
                   launches=counts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   host_rss_start_bytes=rss.start,
                   host_rss_peak_bytes=rss.peak)
        rows["cli_mps"] = row
        print("cli", json.dumps(row), flush=True)
        require(structure == CLI_STRUCTURE,
                f"cli_mps: structure {structure}, the JAX package's "
                f"{CLI_STRUCTURE}")
        require(row["oracle_rel"] <= OBJ_RTOL,
                f"cli_mps: objective off HiGHS: {row}")
        require(x.shape == flat[0].shape and bool(np.isfinite(x).all()),
                f"cli_mps: solution of shape {x.shape}")
        for k, v in counts.items():
            total[k] += v

        # ---- the same dissected LP, f64 factors ----
        with HostPeak() as rss:
            t0 = time.perf_counter()
            dense = read_mps(path)
            read_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            alp, dmap = auto_structure(dense, CLI_T, device=DEVICE)
            torch.cuda.synchronize()
            dissect_s = time.perf_counter() - t0
            del dense
        host_start, host_peak = rss.start, rss.peak
    require(structure_report(dmap, alp) == CLI_STRUCTURE,
            f"cli_mps_f64: structure {structure_report(dmap, alp)}")
    opts = Options(step_mode=StepMode.PRIMAL, factor_dtype="float64")
    torch.cuda.reset_peak_memory_stats()

    def solve():
        iface = PIPSIPMppTorchInterface(alp, opts, device=DEVICE)
        status = iface.run()
        xf = iface.gatherPrimalSolution()
        return dict(status=status, iterations=iface.n_iterations,
                    objective=iface.getObjective(),
                    phase_times=dict(iface.phase_times),
                    x=dmap.recover_x(xf[:alp.n0],
                                     xf[alp.n0:].reshape(alp.N, alp.n)))

    out, counts = drive("cli_mps_f64", solve, ["potf2_f64"])
    row = dict(case="cli_mps_f64", read_s=read_s, dissect_s=dissect_s,
               host_rss_start_bytes=host_start,
               host_rss_peak_bytes=host_peak, status=out["status"].name,
               iterations=out["iterations"], objective=out["objective"],
               oracle_rel=abs(out["objective"] - CLI_ENERGY_ORACLE)
               / abs(CLI_ENERGY_ORACLE), phase_times=out["phase_times"],
               **primal_residuals(out["x"], flat), launches=counts,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    rows["cli_mps_f64"] = row
    print("cli", json.dumps(row), flush=True)
    require(out["status"] == TerminationStatus.SUCCESSFUL_TERMINATION
            and row["oracle_rel"] <= F64_ORACLE_RTOL,
            f"cli_mps_f64: objective off HiGHS: {row}")
    require(row["eq_resid"] < ENERGY_EQ_RESID
            and row["ineq_violation"] <= CLI_RESID
            and row["bound_violation"] <= CLI_RESID,
            f"cli_mps_f64: recovered x off the rows or bounds: {row}")
    for k, v in counts.items():
        total[k] += v
    shapes = energy_shapes(alp)
    del alp
    torch.cuda.empty_cache()
    print("cli_phase", json.dumps(dict(
        seconds=time.perf_counter() - t_phase, launches=total,
        shapes=shapes)), flush=True)
    return rows, total, shapes


# ---- the solve modes --------------------------------------------------------
# the energy LP at full size under each mode, its .opt line in the
# reference's names: (case, .opt line, factor dtype, kernels it launches)
SOLVE_MODE_RUNS = (
    ("energy_bicgstab_f64", "OUTER_SOLVE 2 int", "float64", ["potf2_f64"]),
    ("energy_bicgstab_f32", "OUTER_SOLVE 2 int", "auto",
     ["ldl_inverse_f32"]),
    ("energy_precond_sparse_f64", "PRECONDITION_SPARSE 1 bool", "float64",
     ["potf2_f64"]),
    ("energy_blockwise_f64", "SC_COMPUTE_BLOCKWISE 1 bool", "float64",
     ["potf2_f64"]),
)
# the fused loop under the modes: (FUSED_PATHS entry, kernel that must be
# captured, iterative loop that must be a WHILE node, objective rtol
# against the flagship's f64 objective)
SOLVE_MODE_FUSED = (("flagship_bicgstab", "ldl_inverse_f32", "bicgstab",
                     OBJ_RTOL),
                    ("flagship_precond_blockwise_f64", "potf2_f64", "cg",
                     F64_ORACLE_RTOL))
# the potf2 kernel at the iterative root's panels: the energy LP's
# 385-wide dual Schur complement in 64-row panels (padded to 448) and the
# flagship's 128-wide one
POTF2_PANEL_SHAPES = [(7, 64), (2, 64)]


def mode_stats(record) -> dict:
    """The iterative solves of one run from `arrow_backend.SOLVE_RECORD`,
    read back once: BiCGStab trips per direction solve and CG trips per
    root solve (count, sum, max, not converged), the iterative root's
    panels and dropped share, and the loops captured as WHILE nodes."""
    out = {}
    for kind in ("bicgstab", "cg"):
        st = [v for k, v in record if k == kind and v is not None]
        if st:
            its = torch.stack([v["iterations"] for v in st]).tolist()
            conv = torch.stack([v["converged"] for v in st]).tolist()
            out[kind] = dict(solves=len(its), trips=sum(its), max=max(its),
                             unconverged=conv.count(False))
    panels = [v for k, v in record if k == "panels" and v is not None]
    if panels:
        dropped = torch.stack([v["dropped"] for v in panels]).tolist()
        out["panels"] = dict(factorizations=len(panels),
                             count=panels[0]["count"],
                             dropped_min=min(dropped),
                             dropped_max=max(dropped))
    out["captured_loops"] = {
        kind: sum(1 for k, v in record if k == kind and v is None)
        for kind in ("bicgstab", "cg")}
    return out


def recorded(run):
    """`run()` with `arrow_backend.SOLVE_RECORD` on: (its result, the
    record)."""
    from pips_ipmpp_tpu_torch.linalg import arrow_backend

    arrow_backend.SOLVE_RECORD = []
    try:
        out = run()
        return out, arrow_backend.SOLVE_RECORD
    finally:
        arrow_backend.SOLVE_RECORD = None


def solve_modes_phase(energy_f64_peak, flag_f64, flag_calls, host_calls):
    """ArrowBackend's three other solve modes at full size: the energy LP
    through the facade's whole pipeline with each mode read from a
    reference .opt file (outer BiCGStab in f64 and f32, the iterative root
    and the blockwise Schur complement in f64), back to back on one LP,
    each held as the energy f64 run is (or, f32, to the f64 BiCGStab
    objective), the blockwise run's peak memory below `energy_f64`'s; then
    the fused loop on the flagship under outer BiCGStab (f32) and under the
    iterative root with the blockwise Schur complement (f64), each held to
    its host-loop twin with its kernel and its Krylov loop in the graph and
    one graph launch per warm solve.  Returns (rows, launch counts)."""
    from tempfile import TemporaryDirectory

    t_phase = time.perf_counter()
    total = dict.fromkeys(COUNTED, 0)
    lp, gen_s = energy_lp(ENERGY["T"])
    rows = {}
    with TemporaryDirectory() as tmp:
        for name, line, fd, kernels in SOLVE_MODE_RUNS:
            path = Path(tmp) / f"{name}.opt"
            path.write_text(line + "\n")
            opts = Options.from_opt_file(str(path), Options(
                **ENERGY_OPTIONS, factor_dtype=fd))
            require(opts.outer_bicgstab or opts.sc_blockwise
                    or opts.iterative_root_panel,
                    f"{name}: {line!r} set no solve mode")
            torch.cuda.reset_peak_memory_stats()
            start_bytes = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            (out, counts), record = recorded(
                lambda: drive(name, partial(energy_run, lp, opts), kernels))
            peak = torch.cuda.max_memory_allocated()
            for k, v in counts.items():
                total[k] += v
            row = dict(case=name, opt_line=line, factor_dtype=fd,
                       status=out["status"].name,
                       iterations=out["iterations"],
                       objective=out["objective"],
                       oracle_rel=abs(out["objective"] - ENERGY_ORACLE)
                       / abs(ENERGY_ORACLE), eq_resid=out["eq_resid"],
                       stats=out["stats"], phase_times=out["phase_times"],
                       total_s=time.perf_counter() - t0, launches=counts,
                       peak_memory_bytes=peak,
                       start_memory_bytes=start_bytes,
                       **mode_stats(record))
            rows[name] = row
            require(out["stats"] == ENERGY_PRESOLVE_STATS,
                    f"{name}: presolve stats {out['stats']}")
            if fd == "float64":
                require(row["oracle_rel"] <= F64_ORACLE_RTOL
                        and out["eq_resid"] < ENERGY_EQ_RESID,
                        f"{name}: objective {out['objective']} off HiGHS by "
                        f"{row['oracle_rel']:.3e}, max |A x - b| "
                        f"{out['eq_resid']:.3e}")
            else:
                f64 = rows["energy_bicgstab_f64"]["objective"]
                row["f64_rel"] = abs(out["objective"] - f64) / abs(f64)
                require(row["f64_rel"] <= OBJ_RTOL,
                        f"{name}: objective {out['objective']} off the f64 "
                        f"BiCGStab objective {f64} by {row['f64_rel']:.3e}")
            if opts.outer_bicgstab:
                require(row.get("bicgstab", {}).get("solves", 0) > 0,
                        f"{name}: no outer BiCGStab solve ran")
            if opts.iterative_root_panel:
                require(row.get("cg", {}).get("solves", 0) > 0
                        and "panels" in row, f"{name}: no root CG ran")
            if opts.sc_blockwise:
                row["energy_f64_peak_memory_bytes"] = energy_f64_peak
                require(peak < energy_f64_peak,
                        f"{name}: peak {peak} B not below energy_f64's "
                        f"{energy_f64_peak} B")
            print("solve_modes", json.dumps(row), flush=True)
    del lp
    torch.cuda.empty_cache()

    P = paths()
    for name, kernel, loop, rtol in SOLVE_MODE_FUSED:
        path, over = FUSED_PATHS[name]
        st = setup(P[path], **over)
        (counts, row), record = recorded(
            lambda: fused_twin(name, st, flag_f64, rtol, [kernel],
                               host_calls[name]))
        for k, v in counts.items():
            total[k] += v
        calls = row["host_calls_per_solve"]
        line = dict(case=name, captured_launches=row["captured_launches"],
                    host_calls_per_solve=calls,
                    flagship_host_calls_per_solve=flag_calls,
                    **mode_stats(record))
        print("solve_modes_fused", json.dumps(line), flush=True)
        require(line["captured_loops"][loop] > 0,
                f"{name}: the {loop} loop was not captured as a WHILE node")
        require(calls["graph"] == 1 and calls["kernel"] <= flag_calls["kernel"]
                and calls["copy"] <= flag_calls["copy"],
                f"{name}: {calls} host calls per warm solve, the flagship's "
                f"{flag_calls}")
        del st
        torch.cuda.empty_cache()
    print("solve_modes_phase", json.dumps(dict(
        seconds=time.perf_counter() - t_phase, generate_s=gen_s)),
        flush=True)
    return rows, total


# ---- the hierarchy: k-layer Schur over group-local linking rows ------------
# the reference's hierarchical golden instances and the JAX package's
# iterations with hierarchical=True (f64, default options; my CPU runs):
# the bar is that count plus one, for rounding (the manifest records 5 and
# 14, and the JAX package itself takes 7 on the first)
HIER_GOLDEN = {"hier_approach_4blocks_2by2": 7,
               "hier_approach_8blocks_2by3": 6}
# the checkpoint run: stopped after this many iterations, saving every
# HIER_CKPT_EVERY
HIER_CKPT_STOP, HIER_CKPT_EVERY = 20, 10


def hier_layout(meta) -> dict:
    """The layout of a run: groups, local rows per group and the global
    rows, and per coarse level its groups and rows per group."""
    return dict(groups=meta.n_groups, blocks_per_group=meta.group_size,
                local_eq=meta.mElL, local_ineq=meta.mIlL,
                global_eq=meta.mElG, global_ineq=meta.mIlG,
                levels=[dict(groups=C, eq=e, ineq=i)
                        for C, e, i in meta.levels])


def hier_shapes(lp, meta) -> dict:
    """The kernels' shapes on the hierarchical path, from the layout the
    run built on `lp` (the LP the transform took): the condensed leaves
    [N, a, a] for the LDL kernel (f32 factors), and for potf2 (f64) the
    groups' local Schur complements [G, mL], each coarse level's blocks
    [C, k2], S11 [1, n0] and the dual Schur complement [1, nD] left after
    the levels."""
    a = lp.mE + lp.mI
    nD = (lp.m0E + lp.m0I + meta.mElG + meta.mIlG
          - sum(C * (e + i) for C, e, i in meta.levels))
    potf2_shapes = ([(meta.n_groups, meta.mElL + meta.mIlL)]
                    + [(C, e + i) for C, e, i in meta.levels]
                    + [(1, lp.n0), (1, nD)])
    return dict(ldl=[(lp.N, a, a)],
                potf2=[s for s in potf2_shapes if s[1] > 0])


def hier_run(lp, opts: Options, all_gathers=False):
    """The facade's pipeline with `opts` (hierarchical) on an LP, timed by
    a `ResourceMonitor` (device-synchronized phases), then the primal
    gathers or, with `all_gathers`, every gather."""
    from pips_ipmpp_tpu_torch.utils.monitor import ResourceMonitor

    mon = ResourceMonitor()
    iface = PIPSIPMppTorchInterface(lp, opts, device=DEVICE)
    with mon.phase("run"):
        status = iface.run()
    require(status == TerminationStatus.SUCCESSFUL_TERMINATION,
            f"hierarchical: {status.name} after {iface.n_iterations} "
            f"iterations")
    require(iface.backend_class is HierArrowBackend,
            f"hierarchical: solved by {iface.backend_class.__name__}")
    with mon.phase("primal_gathers"):
        objective = iface.getObjective()
        eq_resid = float(abs(iface.gatherPrimalResidsEQ()).max())
    gather_s = {}
    if all_gathers:
        with mon.phase("all_gathers"):
            gather_s = gather_all(iface, lp)
    flat = iface._presolve_log.lp if iface._presolve_log else lp
    return dict(status=status, iterations=iface.n_iterations,
                objective=objective, eq_resid=eq_resid,
                stats=iface._presolve_log.stats if iface._presolve_log
                else None, phase_times=dict(iface.phase_times),
                monitor=mon.report(), monitor_table=mon.pretty(),
                layout=hier_layout(iface._hier_meta),
                shapes=hier_shapes(flat, iface._hier_meta),
                all_gathers_s=sum(gather_s.values()))


def hier_phase(energy_f64, host_calls):
    """The hierarchical approach at full size: the 96-block energy LP
    through the facade with `hierarchical=True` (8 groups, 2 layers) after
    presolve and geometric + equilibrium scaling, in f64 (potf2 at the
    groups' local Schur complements, S11 and the dual Schur complement;
    HiGHS within 1e-6, A x - b below 1e-5) and in f32 (the LDL kernel at
    the leaves; 1e-3), every gather at 12 blocks; the 3-layer layout
    through the fused loop (one captured graph per solve, the refinement
    a WHILE node, the host loop's iterations); outer BiCGStab under the
    hierarchy; the two hierarchical golden instances through both loops;
    and checkpoint/resume on the flat energy LP (f64, host loop).
    `energy_f64`: the flat f64 run's row, printed beside.  Returns
    (launch counts, the kernels' shapes)."""
    from tempfile import TemporaryDirectory

    from pips_ipmpp_tpu_torch.io.blockfile import read_blocks
    from pips_ipmpp_tpu_torch.ipm.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    t_phase = time.perf_counter()
    total = dict.fromkeys(COUNTED, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    lp, gen_s = energy_lp(ENERGY["T"])
    shapes = {}
    for name, extra, kernels, rtol in (
            ("hier_f64", dict(factor_dtype="float64"), ["potf2_f64"],
             F64_ORACLE_RTOL),
            ("hier_f32", {}, ["ldl_inverse_f32"], OBJ_RTOL)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, counts = drive(name, partial(hier_run, lp, Options(
            **ENERGY_OPTIONS, hierarchical=True, **extra)), kernels)
        add(counts)
        table = out.pop("monitor_table")
        row = dict(case=name, iterations=out["iterations"],
                   energy_f64_iterations=energy_f64["iterations"],
                   status=out["status"].name, objective=out["objective"],
                   oracle_rel=abs(out["objective"] - ENERGY_ORACLE)
                   / abs(ENERGY_ORACLE), eq_resid=out["eq_resid"],
                   phase_times=out["phase_times"], monitor=out["monitor"],
                   layout=out["layout"], shapes=out["shapes"],
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   energy_f64_peak_memory_bytes=energy_f64[
                       "peak_memory_bytes"],
                   launches=counts, total_s=time.perf_counter() - t0)
        print("hierarchical", json.dumps(row), flush=True)
        print(table, flush=True)
        shapes[name] = out["shapes"]
        require(out["stats"] == ENERGY_PRESOLVE_STATS,
                f"{name}: presolve stats {out['stats']}")
        require(row["oracle_rel"] <= rtol,
                f"{name}: objective {out['objective']} off HiGHS by "
                f"{row['oracle_rel']:.3e}")
        if name == "hier_f64":
            require(out["eq_resid"] < ENERGY_EQ_RESID,
                    f"{name}: max |A x - b| = {out['eq_resid']:.3e}")

    # every gather, the dual ones in user row order through the whole
    # postsolve, at ENERGY_GATHER_T blocks (F5)
    small, _ = energy_lp(ENERGY_GATHER_T)
    out, counts = drive("hier_gathers", partial(
        hier_run, small, Options(**ENERGY_OPTIONS, factor_dtype="float64",
                                 hierarchical=True), all_gathers=True),
        ["potf2_f64"])
    add(counts)
    out.pop("monitor_table")
    print("hierarchical", json.dumps(dict(
        case="hier_gathers", T=ENERGY_GATHER_T, iterations=out["iterations"],
        objective=out["objective"], eq_resid=out["eq_resid"],
        layout=out["layout"], phase_times=out["phase_times"],
        all_gathers_s=out["all_gathers_s"], launches=counts)), flush=True)
    require(out["eq_resid"] < ENERGY_EQ_RESID,
            f"hier_gathers: max |A x - b| = {out['eq_resid']:.3e}")
    del small

    # outer BiCGStab under the hierarchy, no presolve, f64
    no_presolve = dict(ENERGY_OPTIONS, presolve=PresolverType.NONE)
    (out, counts), record = recorded(lambda: drive(
        "hier_bicgstab_f64", partial(hier_run, lp, Options(
            **no_presolve, factor_dtype="float64", hierarchical=True,
            outer_bicgstab=True)), ["potf2_f64"]))
    add(counts)
    out.pop("monitor_table")
    row = dict(case="hier_bicgstab_f64", iterations=out["iterations"],
               objective=out["objective"],
               oracle_rel=abs(out["objective"] - ENERGY_ORACLE)
               / abs(ENERGY_ORACLE), phase_times=out["phase_times"],
               layout=out["layout"], launches=counts, **mode_stats(record))
    print("hierarchical", json.dumps(row), flush=True)
    require(row.get("bicgstab", {}).get("solves", 0) > 0,
            "hier_bicgstab_f64: no outer BiCGStab solve ran")
    require(row["oracle_rel"] <= F64_ORACLE_RTOL,
            f"hier_bicgstab_f64: off HiGHS by {row['oracle_rel']:.3e}")

    # checkpoint/resume: the flat energy LP, scaled, f64 host loop,
    # uninterrupted, stopped at HIER_CKPT_STOP, resumed from its file
    slp = make_scaler(ENERGY_OPTIONS["scaler"]).scale(lp)
    del lp
    reset_counts()
    ctor = partial(ArrowBackend, factor_dtype=torch.float64)
    full = IPMSolver(ctor, Options(**ENERGY_SOLVER),
                     device=DEVICE).solve(slp)
    with TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "energy.npz")
        stopped = IPMSolver(ctor, Options(**ENERGY_SOLVER).replace(
            max_iterations=HIER_CKPT_STOP), device=DEVICE).solve(
            slp, checkpoint_path=path, checkpoint_every=HIER_CKPT_EVERY)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "again.npz"), stopped.iterate,
                        HIER_CKPT_STOP, 1e-8, 1e-8)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_checkpoint(path, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = IPMSolver(ctor, Options(**ENERGY_SOLVER),
                            device=DEVICE).solve(slp, checkpoint_path=path,
                                                 resume=True)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
    counts = read_counts()
    add(counts)
    rel = abs(resumed.objective - full.objective) / abs(full.objective)
    print("hierarchical", json.dumps(dict(
        case="checkpoint_f64", iterations=full.iterations,
        stopped_iterations=stopped.iterations,
        stopped_status=stopped.status.name,
        resumed_status=resumed.status.name,
        resumed_iterations=resumed.iterations, objective=full.objective,
        resumed_objective=resumed.objective, resumed_rel=rel,
        oracle_rel=abs(full.objective - ENERGY_ORACLE) / abs(ENERGY_ORACLE),
        file_bytes=size, save_s=save_s, load_s=load_s,
        resumed_solve_s=resumed_s, launches=counts)), flush=True)
    require(full.status == resumed.status
            == TerminationStatus.SUCCESSFUL_TERMINATION and rel <= 1e-6,
            f"checkpoint_f64: resumed {resumed.status.name}, "
            f"{rel:.3e} off the uninterrupted objective")
    require(stopped.iterations == HIER_CKPT_STOP,
            f"checkpoint_f64: stopped after {stopped.iterations}")
    del slp, full, stopped, resumed
    torch.cuda.empty_cache()

    # the 3-layer layout through the fused loop against its host loop
    st = setup(paths()["energy_hier3"])
    (counts, frow), record = recorded(lambda: fused_twin(
        "energy_hier3", st, ENERGY_ORACLE, F64_ORACLE_RTOL, ["potf2_f64"],
        host_calls["energy_hier3"]))
    add(counts)
    warm = [frow["solve_s"]]
    for _ in range(2):
        t0 = time.perf_counter()
        st.solver.solve_fused(st.lp)
        warm.append(time.perf_counter() - t0)
    layout = hier_layout(st.solver.be_ctor.keywords["meta"])
    calls = host_calls["energy_hier3"]
    line = dict(case="hier3_fused_f64", layout=layout,
                iterations=frow["iterations"],
                host_iterations=frow["host_iterations"],
                capture_s=frow["first_solve_s"],
                warm_solve_s=statistics.median(warm), warm_solves_s=warm,
                graph_ms=frow["graph_ms"], host_calls_per_solve=calls,
                refinement_loops_captured=sum(
                    1 for k, v in record if k == "refinement" and v is None),
                refinement_loops_host=sum(
                    1 for k, v in record if k == "refinement"
                    and v is not None))
    print("hierarchical_fused", json.dumps(line), flush=True)
    require(len(layout["levels"]) == 1,
            f"hier3_fused_f64: layout {layout} has no coarse level")
    require(calls["graph"] == 1,
            f"hier3_fused_f64: {calls} host calls per warm solve")
    require(line["refinement_loops_captured"] > 0,
            "hier3_fused_f64: the refinement was not captured as a WHILE "
            "node")
    del st
    torch.cuda.empty_cache()

    # the hierarchical golden instances, f64, through both loops
    data = Path(__file__).resolve().parent / "tests" / "data" / "gamssmall"
    manifest = {e["name"]: e for e in
                json.loads((data / "manifest.json").read_text())}
    reset_counts()
    for name, jax_iterations in HIER_GOLDEN.items():
        e = manifest[name]
        g = read_blocks(str(data / name), n_blocks=e["n_files"],
                        device=DEVICE)
        iface = PIPSIPMppTorchInterface(g, Options(
            hierarchical=True, factor_dtype="float64"), device=DEVICE)
        status = iface.run()
        hlp, meta = build_hierarchical_lp(g, _auto_groups(g.N))
        fused = IPMSolver(partial(HierArrowBackend, meta=meta,
                                  factor_dtype=torch.float64), Options(),
                          device=DEVICE).solve_fused(hlp)
        row = dict(case="hier_golden", name=name, status=status.name,
                   iterations=iface.n_iterations,
                   objective=iface.getObjective(),
                   fused_graph=fused.info["graph"],
                   fused_status=fused.status.name,
                   fused_iterations=fused.iterations,
                   fused_objective=fused.objective,
                   recorded_objective=e["objective"],
                   recorded_iterations=e["iterations"],
                   jax_iterations=jax_iterations,
                   layout=hier_layout(meta))
        print("hierarchical", json.dumps(row), flush=True)
        for loop, st_, its, obj in (
                ("host", status, row["iterations"], row["objective"]),
                ("fused", fused.status, fused.iterations,
                 fused.objective)):
            require(st_ == TerminationStatus.SUCCESSFUL_TERMINATION
                    and abs(obj - e["objective"]) < 1e-4
                    and its <= jax_iterations + 1,
                    f"{name} ({loop} loop): misses the bar {row}")
        require(fused.info["graph"], f"{name}: the fused solve was not "
                                     f"captured")
    counts = read_counts()
    require(counts["potf2_f64"] > 0, f"hier_golden: no potf2 launch "
                                     f"({counts})")
    add(counts)
    print("hierarchical_phase", json.dumps(dict(
        seconds=time.perf_counter() - t_phase, generate_s=gen_s,
        launches=total)), flush=True)
    return total, shapes


# the golden instances that tests/test_golden_reference.py:62-76 runs
# through the facade with presolve and geometric + equilibrium scaling
GOLDEN_PIPELINE = ("exampleAC_boundStrength", "hier_approach_8blocks_2by3",
                   "nearlyParallelInequalityRows_B0A2")


def golden_presolved_phase():
    """The GAMSsmall instances of tests/test_golden_reference.py:62-76
    (presolve, geometric + equilibrium scaling) and :93-110 (the
    singletonInequalityColumn ones, presolve, a singleton-column reduction
    firing) through the facade on the card, in f64 factors as those tests
    run on the CPU, each to the manifest's objective (1e-4)."""
    from pips_ipmpp_tpu_torch.io.blockfile import read_blocks

    data = Path(__file__).resolve().parent / "tests" / "data" / "gamssmall"
    manifest = {e["name"]: e for e in
                json.loads((data / "manifest.json").read_text())}
    cases = [(n, ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM)
             for n in GOLDEN_PIPELINE]
    cases += [(n, ScalerType.NONE) for n in manifest
              if "singletonInequalityColumn" in n]
    rows = []
    for name, scaler in cases:
        e = manifest[name]
        lp = read_blocks(str(data / name), n_blocks=e["n_files"],
                         device=DEVICE)
        iface = PIPSIPMppTorchInterface(lp, Options(
            scaler=scaler, presolve=PresolverType.PRESOLVE,
            factor_dtype="float64"), device=DEVICE)
        status = iface.run()
        row = dict(name=name, scaler=scaler.name, status=status.name,
                   iterations=iface.n_iterations,
                   objective=iface.getObjective(),
                   recorded_objective=e["objective"],
                   stats=iface._presolve_log.stats)
        print("golden_presolved", json.dumps(row), flush=True)
        require(status == TerminationStatus.SUCCESSFUL_TERMINATION
                and abs(row["objective"] - e["objective"]) < 1e-4,
                f"{name}: misses the manifest's objective {row}")
        if "singletonInequalityColumn" in name:
            require(row["stats"].get("singleton_columns", 0) > 0,
                    f"{name}: no singleton-column reduction fired")
        gather_all(iface, lp)
        rows.append(row)
    return rows


def dense_lp_phase():
    """The DenseLP happy path of the verification recipe on the card
    (DenseBackend, torch.linalg's Cholesky): x* = (0.5, 1), objective
    -2.5, with the card's default f32 factors and with f64."""
    from pips_ipmpp_tpu_torch import DenseLP

    def f(v):
        return torch.as_tensor(np.asarray(v, np.float64), device=DEVICE)

    lp = DenseLP(c=f([-1.0, -2.0]), A=f([[1.0, 1.0]]), b=f([1.5]),
                 C=f(np.zeros((0, 2))), iclow=f([]), clow=f([]),
                 icupp=f([]), cupp=f([]), ixlow=f([1, 1]), xlow=f([0, 0]),
                 ixupp=f([1, 1]), xupp=f([1, 1]))
    rows = []
    for extra in ({}, dict(factor_dtype="float64")):
        iface = PIPSIPMppTorchInterface(lp, Options(**extra), device=DEVICE)
        status = iface.run()
        x = iface.gatherPrimalSolution()
        row = dict(options=extra, backend=iface.backend_class.__name__,
                   status=status.name, iterations=iface.n_iterations,
                   objective=iface.getObjective(), x=x.tolist())
        print("dense_lp", json.dumps(row), flush=True)
        require(status == TerminationStatus.SUCCESSFUL_TERMINATION
                and abs(row["objective"] + 2.5) < 1e-6
                and float(abs(x - np.array([0.5, 1.0])).max()) < 1e-6,
                f"DenseLP happy path: {row}")
        rows.append(row)
    return rows


def dense_path(name, f32_run, f64_run, n_vars, kernel):
    """The f64 reference (no kernel launch allowed but the f64 root
    Cholesky's), then the f32 path."""
    ref, ref_counts = drive(f"{name} f64 reference", f64_run, ["potf2_f64"])
    require(not any(v for k, v in ref_counts.items() if k != "potf2_f64"),
            f"{name}: the f64 reference launched {ref_counts}")
    require(ref["status"] == TerminationStatus.SUCCESSFUL_TERMINATION,
            f"{name}: f64 reference status {ref['status']}")
    out, counts = drive(name, f32_run, [kernel])
    report(name, out, counts, ref["objective"], OBJ_RTOL, n_vars,
           f64_iterations=ref["iterations"], f64_solve_s=ref["solve_s"])
    require(counts[kernel] >= 2 * out["iterations"],
            f"{name}: {counts[kernel]} {kernel} launches for "
            f"{out['iterations']} iterations")
    return counts, out, ref["objective"]


def main():
    t_main = time.perf_counter()

    def clock(after):
        """The script's seconds so far, on a line of their own."""
        print("clock", json.dumps(dict(after=after, seconds=(
            time.perf_counter() - t_main))), flush=True)

    # ---- 1. device ----
    require(torch.cuda.is_available(), "no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)
    pin_float32_precision()
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "TF32 is not off")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print("build", json.dumps(dict(seconds=time.perf_counter() - t0,
                                   library=lib_path.name)), flush=True)

    # ---- 3. kernels against their plain versions ----
    slp = sparse_lp()
    ldl_rows = check_ldl_kernel()
    ell_rows = check_ell_kernel(slp)
    sweep_rows = check_sweep_kernel()
    potf2_rows = check_potf2_kernel()
    clock("kernel checks")

    total = dict.fromkeys(COUNTED, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    P = paths()
    f64_factors = partial(ArrowBackend, factor_dtype=torch.float64)

    # ---- 4. dense main path: flagship through the facade ----
    flag, opts, _ = P["flagship"]()
    counts, _, flag_f64 = dense_path(
        "flagship_facade", partial(facade_run, flag, opts),
        partial(facade_run, flag.astype(torch.float64),
                opts.replace(factor_dtype="float64")),
        flag.total_vars(), "ldl_inverse_f32")
    add(counts)

    # ---- 5. dense main path: big leaves, bench production configuration
    big, opts, backend = P["bigleaf"]()
    counts, _, big_f64 = dense_path(
        "bigleaf_ipmsolver", partial(solver_run, big, backend, opts),
        partial(solver_run, big, f64_factors, opts),
        big.total_vars(), "ldl_inverse_f32")
    add(counts)

    # ---- 6. sparse path through the facade, f32 factors: 4.3 GB of dense
    #         twin > the 256 MB default budget -> SparseArrowBackend ----
    out, counts = drive("sparse_facade_f32",
                        partial(path_run, *P["sparse_f32"]()),
                        ["ell_spmm", "ldl_inverse_f32"])
    require(out["backend"] == "SparseArrowBackend",
            f"sparse facade routed to {out['backend']}")
    report("sparse_facade_f32", out, counts, SPARSE_ORACLE, OBJ_RTOL,
           slp.total_vars(), backend=out["backend"])
    add(counts)

    # ---- 7. sparse f64 check: the JAX package's acceptance run ----
    out, counts = drive("sparse_ipmsolver_f64",
                        partial(path_run, *P["sparse_f64"]()), ["ell_spmm"])
    report("sparse_ipmsolver_f64", out, counts, SPARSE_ORACLE,
           F64_ORACLE_RTOL, slp.total_vars())
    add(counts)

    # ---- 8. opt-in sweep path, the JAX package's sweep test in f32 ----
    sweep_lp, opts, backend = P["sweep"]()
    sweep_counts, sweep_out, _ = dense_path(
        "sweep_ipmsolver", partial(solver_run, sweep_lp, backend, opts),
        partial(solver_run, sweep_lp, f64_factors, opts),
        sweep_lp.total_vars(), "sweep_inverse")
    add(sweep_counts)
    require(abs(sweep_out["objective"] - SWEEP_OPTIMUM)
            <= OBJ_RTOL * (1.0 + SWEEP_OPTIMUM),
            f"sweep solve objective {sweep_out['objective']} is not the "
            f"optimum {SWEEP_OPTIMUM}")

    clock("main paths")

    # ---- 9. the fused loop: each path as one captured graph, against its
    #         host loop and the f64 objective; every fused path's host
    #         CUDA calls first (the solve modes' too), in fresh processes
    #         at once ----
    host_calls = fused_host_calls(list(FUSED_PATHS))
    fused_rows = []
    for name, f64_obj, kernels in (
            ("flagship", flag_f64, ["ldl_inverse_f32"]),
            ("bigleaf", big_f64, ["ldl_inverse_f32"]),
            ("sparse_f32", SPARSE_ORACLE, ["ell_spmm", "ldl_inverse_f32"]),
            ("flagship_update_every_4", flag_f64, ["ldl_inverse_f32"])):
        path, over = FUSED_PATHS[name]
        st = setup(P[path], **over)
        counts, row = fused_twin(name, st, f64_obj, OBJ_RTOL, kernels,
                                 host_calls[name])
        add(counts)
        fused_rows.append(row)
        if name == "flagship":
            reset_counts()
            fused_stream(st, range(4))
            add(read_counts())
        # ---- 9b. the fused batch of this path, against its singles ----
        for bname, (bpath, B) in BATCH_PATHS.items():
            if bpath == name:
                counts, _ = fused_batch(bname, st, B, kernels)
                add(counts)
        del st
        torch.cuda.empty_cache()

    # ---- 9c. the LDL kernel at the batches' leaf and root shapes ----
    ldl_rows += check_ldl_kernel(BATCH_LDL_SHAPES, "ldl_batch_check")
    clock("fused loops")

    # ---- 10. the golden instances, f64, both loops: the root through the
    #          potf2 kernel, also inside every captured graph ----
    reset_counts()
    golden = golden_phase()
    golden.update(launches=read_counts(), captured_launches=read_captured())
    print("golden_summary", json.dumps(golden), flush=True)
    require(golden["launches"]["potf2_f64"] > 0
            and golden["captured_launches"]["potf2_f64"] > 0,
            f"golden: the root's potf2 kernel was not launched "
            f"({golden['launches']}, captured {golden['captured_launches']})")
    add(golden["launches"])
    clock("golden")

    # ---- 11. the facade's full pipeline at full size: the energy LP
    #          through presolve, scaling, the solve (f64 factors: potf2
    #          at the root; f32: the LDL kernel) and the postsolve ----
    energy = energy_phase()
    for row in energy.values():
        add(row["launches"])
    shapes = energy["energy_f32"]["shapes"]
    ldl_rows += check_ldl_kernel([(B, a, p) for B, a, p in shapes["ldl"]],
                                 "ldl_energy_check")
    potf2_rows += check_potf2_kernel(
        [tuple(x) for x in energy["energy_f64"]["shapes"]["potf2"]],
        "potf2_energy_check")
    clock("energy")

    # ---- 11a. the entry points: the CLI on the 96-block LP's block
    #           files and on the T = 24 LP's MPS with --auto-blocks (f32
    #           leaves, LDL kernel; the wide root in f64, potf2), the
    #           dissected LP in f64 (potf2 at its root);
    #           the kernels at the dissected LP's shapes ----
    _, counts, shapes = cli_phase(energy["energy_f32"]["iterations"])
    add(counts)
    ldl_rows += check_ldl_kernel([(B, a, p) for B, a, p in shapes["ldl"]],
                                 "ldl_cli_check")
    potf2_rows += check_potf2_large([tuple(x) for x in shapes["potf2"]])
    clock("entry points")

    # ---- 11b. the solve modes: the energy LP under outer BiCGStab, the
    #           iterative root and the blockwise Schur complement, and the
    #           fused flagship under them; potf2 at the root's panels ----
    _, counts = solve_modes_phase(
        energy["energy_f64"]["peak_memory_bytes"], flag_f64,
        fused_rows[0]["host_calls_per_solve"], host_calls)
    add(counts)
    potf2_rows += check_potf2_kernel(POTF2_PANEL_SHAPES,
                                     "potf2_panels_check")
    clock("solve modes")

    # ---- 11c. the hierarchy on the energy LP (f64: potf2 at the groups'
    #           local Schur complements, S11 and the dual Schur complement;
    #           f32: the LDL kernel at the leaves), 3 layers fused, outer
    #           BiCGStab, the golden hier instances, checkpoint/resume; both
    #           kernels at the hierarchy's shapes ----
    counts, shapes = hier_phase(energy["energy_f64"], host_calls)
    add(counts)
    # the shapes an earlier check of this run took (the leaves and S11 are
    # the flat energy LP's) are not checked again
    done = {tuple(r["shape"]) for r in ldl_rows + potf2_rows}
    ldl_all = [(B, a, a) for B, a, _ in shapes["hier_f32"]["ldl"]]
    potf2_all = [(B, n, n) for B, n in shapes["hier_f64"]["potf2"]]
    ldl_new = [s for s in ldl_all if s not in done]
    potf2_new = [(B, n) for B, n, _ in potf2_all if (B, n, n) not in done]
    print("hier_kernel_checks", json.dumps(dict(
        ldl=ldl_all, potf2=potf2_all,
        checked_earlier=[s for s in ldl_all + potf2_all if s in done])),
        flush=True)
    ldl_rows += check_ldl_kernel(ldl_new, "ldl_hier_check")
    potf2_rows += check_potf2_kernel(potf2_new, "potf2_hier_check")
    clock("hierarchical")

    # ---- 12. the golden instances through the facade with presolve,
    #          and the DenseLP happy path ----
    reset_counts()
    golden_presolved_phase()
    dense_lp_phase()
    add(read_counts())
    clock("golden presolved, DenseLP")

    # ---- 13. the kernels line ----
    leaf = ldl_rows[0]
    ell = next(r for r in ell_rows if r["case"] == "fwd"
               and r["dtype"] == "float32" and r["c"] > 1)
    sw = sweep_rows[0]
    pr = potf2_rows[1]          # the flagship's dual block [1, 128, 128]
    kernels = [
        dict(name="ldl_inverse_f32", route="cuda",
             source="pips_ipmpp_tpu_torch/csrc/ldl_inverse.cu",
             replaces="pips_ipmpp_tpu/linalg/pallas_ldl.py:224",
             launches=total["ldl_inverse_f32"],
             max_abs_err=max(r["kernel_abs_err"] for r in ldl_rows),
             ms=leaf["ms"], plain_ms=leaf["plain_ms"],
             bound_ms=leaf["bound_ms"], bound_by=leaf["bound_by"],
             library_ms=leaf["library_ms"]),
        dict(name="ell_spmm", route="cuda",
             source="pips_ipmpp_tpu_torch/csrc/ell_spmm.cu",
             replaces="pips_ipmpp_tpu/linalg/pallas_spmv.py:185",
             launches=total["ell_spmm"],
             max_abs_err=max(r["max_abs_err"] for r in ell_rows),
             ms=ell["ms"], plain_ms=ell["plain_ms"],
             bound_ms=ell["bound_ms"], bound_by=ell["bound_by"],
             library_ms=ell["library_ms"]),
        dict(name="sweep_inverse", route="cuda",
             source="pips_ipmpp_tpu_torch/csrc/sweep_inverse.cu",
             replaces="pips_ipmpp_tpu/linalg/pallas_sweep.py:158",
             launches=total["sweep_inverse"],
             max_abs_err=max(r["kernel_abs_err"] for r in sweep_rows),
             ms=sw["ms"], plain_ms=sw["plain_ms"],
             bound_ms=sw["bound_ms"], bound_by=sw["bound_by"],
             library_ms=sw["library_ms"]),
        dict(name="potf2_f64", route="cuda",
             source="pips_ipmpp_tpu_torch/csrc/potf2.cu",
             replaces="none: the f64 root Cholesky, jnp.linalg.cholesky "
                      "(LAPACK) at pips_ipmpp_tpu/linalg/arrow_backend.py:741",
             launches=total["potf2_f64"],
             max_abs_err=max(r["max_abs_err"] for r in potf2_rows),
             ms=pr["loop_ms"], plain_ms=pr["plain_ms"],
             bound_ms=pr["bound_ms"], bound_by=pr["bound_by"],
             library_ms=pr["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
