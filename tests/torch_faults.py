"""The runs behind the entries of ROADMAP.md §3 (faults of the PyTorch port
against the JAX package), on the CPU unless an entry says the card.

    PYTHONPATH=. python tests/torch_faults.py f1 {jax,port}
    PYTHONPATH=. python tests/torch_faults.py f2 {2048,8192} {jax,port} [EPS [SEED]]
    PYTHONPATH=. python tests/torch_faults.py init NAME
    python tests/torch_faults.py golden ROOT NAME DEVICE
    PYTHONPATH=. python tests/torch_faults.py f3 NAME
    PYTHONPATH=. python tests/torch_faults.py replay {all,SCENARIO...}
    PYTHONPATH=. python tests/torch_faults.py f3noise NAME {jax,port}
    PYTHONPATH=. python tests/torch_faults.py f3lapack [cuda|cpu] [NAME...]
    python3 tests/torch_faults.py batchnoise PATH B [REPS]
    python3 tests/torch_faults.py batchinput PATH B [DRAWS]
    PYTHONPATH=. python tests/torch_faults.py f32batch {jax,small} SEEDS...
    PYTHONPATH=. python tests/torch_faults.py f32triple SEEDS...
    PYTHONPATH=. python tests/torch_faults.py f2cg N K TRIPS...
    PYTHONPATH=. python tests/torch_faults.py f6cr [SEEDS...]
    PYTHONPATH=. python tests/torch_faults.py climps T [jax|port]
    PYTHONPATH=. python tests/torch_faults.py f32root T CASE
    PYTHONPATH=. python tests/torch_faults.py hier T {f64,f32} [LAYERS] [presolve] [jax|port]
    PYTHONPATH=. python tests/torch_faults.py hiernoise NAME {jax,port} [SEEDS...]

hiernoise: f3noise through the facade with `hierarchical=True` (default
options otherwise): every Cholesky input of the solve (the leaves, the
groups' local Schur complements, S11 and the dual Schur complement)
multiplied by 1 + 1e-16 E, E symmetric standard normal, per seed (default
0-9), and seed -1 for the solve without noise.  The JAX package's noisy
solves run with jit off (so that numpy draws fresh noise per call), its
seed -1 as its facade runs it, jitted.  One JSON line per seed: status,
iterations, objective.

hier: the energy LP at T periods and full width (`dispatch_blocks(T,
R=150, G=550, L=350, S=4, seed=5)`) through each package's facade on the
CPU with `chip_smoke.ENERGY_OPTIONS`' scaler and solver settings
(geometric + equilibrium scaling, max_iterations 300, one Gondzio
corrector, refinement_steps 2), `hierarchical=True`,
`hierarchical_layers=LAYERS` (default 2), the factor dtype named, and no
presolve unless `presolve` is given; both packages unless one is named.
One JSON line per package: status, iterations, objective and its
relative distance to HiGHS, the layout (`n_groups`, local and global
rows per level), seconds.

f32root: the same MPS file as climps, read and dissected into T blocks
(`auto_structure(read_mps(F), T)`) by one package and solved through its
facade with the CLI's options and f32 factors (R2).  CASE is `jax` (its
LDL's default panel), `jax_p32` (`PIPS_LDL_PANEL=32`), `port_root32` (the
root in f32 as the JAX package factors it, `ROOT_F32_MAX` lifted; the
plain unblocked LDL of the port's CPU path), `port_root32_blocked` (the
same with the kernel's blocked order, nb = 64, at leaves and root),
`port` (the facade as it stands: a root wider than `ROOT_F32_MAX` in
f64) or `port_blocked` (that with the blocked leaves).  The IPM's lines,
then one JSON line: status, iterations, objective, its distance to
HiGHS, the root's width, seconds.  Each case in its own process (the panel is read at import).

climps: the energy LP at the full per-period width
(`dispatch_blocks(T, R=150, G=550, L=350, S=4, seed=5)`) written as MPS
(`io/energy.write_mps`) and solved on the CPU, f64, by each package's CLI
as `tests/test_realworld.py:57` runs it (`--mps F --auto-blocks T
printsol`; the port's `main(argv, device="cpu")`), both packages unless
one is named.  One JSON line per package: return code, status line,
iterations, objective and its relative distance to HiGHS
(`io/energy.highs_oracle`), c'x and the primal residuals of the written
solution in the MPS order (max |A_eq x - b_eq|, the inequality and bound
violations), seconds.  At T = 12 the dissected root is ~4.8k wide: minutes.

f1: the f32 sweep solve of the two-scenario linking LP
(`tests/fixtures.py::two_scenario_linking_lp`, `ArrowBackend(factor_dtype
=f32, sweep_kernel=True)`, `Options(refinement_steps=2)`) with every input
of the sweep inverse perturbed by 1e-7 relative symmetric noise, for seeds
0-9.  The JAX package runs its Pallas sweep kernel in interpret mode with
jit off (so that numpy draws fresh noise per call); the port runs the
plain version its CPU path takes.  One line per seed: status, iterations,
objective.

f2: the f64 CG-leaf solve of `random_sparse_arrowhead_lp(0, N=8, n=n,
mE=n/2, mI=n/2, nnz_per_row=10, n0=16, m0E=4, m0I=4, mEl=4, mIl=4)`
through `IPMSolver(partial(SparseArrowBackend, cg_iters=500),
Options(record_history=True))`, no scaling, as
`tests/test_sparse.py:166-201` runs it.  One JSON line: status,
iterations, objective, per-iteration mu and residual, the final mu and
residual and the data norm (and, for the port, the CG's calls and capped
calls).  At n = 8192 a run takes tens of minutes.  With EPS the costs c
are multiplied by 1 + EPS * N(0, 1) (numpy, seed SEED, default 0): a change
at the level of rounding, to see whether the run's outcome turns on it.

init: where the two packages' golden solves part (ROADMAP.md §3): the
relative difference of their initial iterates on one instance.

f3: one GAMSsmall instance in f64 through the port's host loop on the card
(F3), every step repeated on the CPU from the card's own iterate and with
the card's shifts: per step the shifts, the factorization's health flag,
mu after the step on both devices, the new iterates' relative difference,
and for every `arrow_backend._cholesky` factorization of the step on
either device its size, its flag, its backward error max|LL' - S| /
max|S| and its smallest over largest squared pivot (since the potf2 fix
the card's root goes through `_root_cholesky` and the kernel, so on the
card these are the leaves' only).  Then the same instance's host loop on
the CPU alone, for its per-iteration mu.

f3noise: one GAMSsmall instance in f64 through a host loop on the CPU
(ArrowBackend, default Options) with the input of every Cholesky
factorization multiplied by 1 + 1e-16 E, E symmetric standard normal
(numpy, seeds 0-9): a change at the level of rounding, to see whether the
instance's outcome turns on it, in the JAX package (jit off, so that numpy
draws fresh noise per call) and in the port.  One line per seed: status,
iterations, objective.

f3lapack: the LAPACK-order cause of F3.  Each GAMSsmall instance named
(by default the two that missed the acceptance on the card before the
potf2 kernel) in f64 through the host loop and the fused loop of the port
on the device given (default cuda), with the root's two Cholesky factors
(S11 and the dual Schur complement) computed three ways: by torch.linalg
(cuSOLVER on the card), by the plain torch Cholesky in LAPACK's unblocked
order (dpotf2, `linalg/potf2.py::cholesky_potf2_ref`), and as the port
computes them (on the card the potf2 kernel).  One line per run with
status, iterations against the acceptance budget ceil(1.1 x recorded),
objective, and, outside a capture, the smallest over largest squared pivot
of every root factor.

batchnoise: on the card, a batch of `chip_smoke.py` (PATH flagship or
bigleaf, B LPs of the bench's stream, `chip_smoke.stream_lps`) through
`solve_fused_batch_async`, each LP through `solve_fused`, and each LP
REPS times (default 4) with rounding noise on every factorization input
(`rounding_band`): per LP the batch's status, iterations and
objective beside the single solve's and the noisy ones', to see whether
an iteration count that the batch and the single solve disagree on turns
on rounding.

batchinput: on the card, `chip_smoke.py`'s fused_batch phase on PATH at
B (its checks printed, not raised), then each LP's single solve DRAWS
times (default 24) with 1e-16 relative noise on the LP's data
(`chip_smoke.noisy_lp`): the counts, statuses and objectives the noise
gives, the band its ±1-iteration allowance draws from.

f32batch: on the CPU, f32 factors (`ArrowBackend(factor_dtype=f32)`,
default options) on `random_arrowhead_lp(SEED, ...)` at the JAX package's
batch test shape (jax: N=4, n=24, mE=10, mI=12, n0=6, m0E=3, m0I=3, mEl=3,
mIl=3) or at N=2, n=48 (small): per seed the single fused solve's
iterations and whether its root escalation fired, the iterations of the
same LP three times in one batch, and of three single solves with its
costs times 1 + 1e-15 N(0, 1) (torch generator seeded by SEED).

f32triple: on the CPU, f32 factors, the JAX package's batch test batch
(`random_arrowhead_lp(SEED, ...)` at its shape, costs times 1 + 1e-4 i, i
= 0, 1, 2) through both packages: per seed and package the three single
fused solves' iterations and objectives and the batch's
(`solve_fused_batch_async`; the JAX package's f32 LDL in Pallas interpret
mode, one compile for the batch), to see whether the JAX package's own
f32 batch parts from its singles as the port's does.

replay: the fault behind profiling the fused loop in-process (F4), on the
card.  `replay all` (or several scenarios named) runs each scenario in a
process of its own (an
illegal address ends the process's CUDA context) and prints its exit code,
its steps that held and its first error; `replay SCENARIO` runs one.  The
graphs are the fused solves of the flagship (A), the big leaf (B) and the
sparse f32 path (C) of `chip_smoke.paths()`; every fused result is held to
its host-loop twin (status, iterations, objective to 1e-6 relative).  The
scenarios (`REPLAY_SCENARIOS`) capture, replay, free and profile them in
different orders.

f2cg: one leaf CG call of the factorization, operation by operation: the
f2 instance at n = N through the port's host loop up to its iterate K, then
the factorization's CG inputs (Einv, F_d, the Jacobi diagonal's inverse,
the right-hand sides) from that iterate with shifts 1e-10 in both packages,
and their relative difference.  Then, on the JAX package's inputs, each
package's `batched_pcg` stopped after each count of TRIPS: the relative
difference of their results; the port's loop with the JAX package's
operator against the JAX package's CG; and each package's CG against
itself on right-hand sides times 1 + 1e-16 N(0, 1) (numpy, seed 0), its
response to noise at the level of rounding; and the true relative residual
max ||Neq X - B|| / ||B|| of each result.

golden: one GAMSsmall instance in f64 through the host loop of the port
package found under ROOT (this checkout, or another one unpacked beside
it, such as a parent commit without `io/blockfile.py`) on DEVICE (cpu or
cuda): status, iterations, objective and the first mu values (F3).

f6cr: Curtis-Reid scaling in both packages (F6) on the dense LPs
`random_dense_lp(PRNGKey(k), n=16, mE=5, mI=7)` and `(n=24, mE=7, mI=9)`
and the arrowhead LPs `random_arrowhead_lp(k, N=4, n=6, mE=2, mI=3, n0=3,
m0E=1, m0I=2, mEl=2, mIl=2)`, k in SEEDS (default 0-5).  One JSON line
each: the number of the rounded factors s, rE, rC that differ; for the
dense LPs also the largest difference of the log2 row factors before
rounding and of rho_i + gamma_j over the nonzeros a_ij.
"""
import json
import sys
import time
from functools import partial

import numpy as np


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def f1(which, seeds=range(10)):
    import torch
    torch.set_num_threads(1)
    out = {}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        if which == "jax":
            jax = _jax_cpu()
            jax.config.update("jax_disable_jit", True)
            import jax.numpy as jnp

            import pips_ipmpp_tpu.linalg.pallas_sweep as ps
            from pips_ipmpp_tpu.core.options import Options
            from pips_ipmpp_tpu.ipm.solver import IPMSolver
            from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
            from tests.fixtures import two_scenario_linking_lp
            plain = ps.__dict__.setdefault("_unperturbed", ps.sweep_inverse)

            def noisy(A, *a, **k):
                E = rng.standard_normal(np.shape(A))
                E = (E + np.swapaxes(E, -1, -2)) / 2
                return plain(jnp.asarray(np.asarray(A, np.float64)
                                         * (1 + 1e-7 * E), A.dtype), *a, **k)
            ps.sweep_inverse = noisy
            lp, _ = two_scenario_linking_lp(jnp.float32)
            r = IPMSolver(partial(ArrowBackend, factor_dtype=jnp.float32,
                                  sweep_kernel=True),
                          Options(refinement_steps=2)).solve(lp)
        else:
            import pips_ipmpp_tpu_torch.linalg.arrow_backend as ab
            from chip_smoke import two_scenario_lp
            from pips_ipmpp_tpu_torch.core.options import Options
            from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
            from pips_ipmpp_tpu_torch.linalg.sweep import sweep_inverse

            def noisy(A):
                E = torch.from_numpy(rng.standard_normal(tuple(A.shape)))
                E = (E + E.mT) / 2
                return sweep_inverse((A.double() * (1 + 1e-7 * E))
                                     .to(A.dtype))
            ab.sweep_inverse = noisy
            import chip_smoke
            chip_smoke.DEVICE = "cpu"
            r = IPMSolver(partial(ab.ArrowBackend, factor_dtype=torch.float32,
                                  sweep_kernel=True),
                          Options(refinement_steps=2), device="cpu").solve(
                two_scenario_lp(torch.float32))
        out[seed] = (r.status.name, int(r.iterations), float(r.objective))
        print(json.dumps(dict(fault="F1", package=which, seed=seed,
                              status=out[seed][0], iterations=out[seed][1],
                              objective=out[seed][2])), flush=True)
    return out


def f2(n, which, eps=0.0, seed=0):
    dims = dict(N=8, n=n, mE=n // 2, mI=n // 2, nnz_per_row=10, n0=16,
                m0E=4, m0I=4, mEl=4, mIl=4)
    t0 = time.perf_counter()
    extra = {}
    if which == "jax":
        _jax_cpu()
        from pips_ipmpp_tpu.core.options import Options
        from pips_ipmpp_tpu.io.synthetic import random_sparse_arrowhead_lp
        from pips_ipmpp_tpu.ipm.solver import IPMSolver
        from pips_ipmpp_tpu.linalg.sparse_backend import SparseArrowBackend
        lp = random_sparse_arrowhead_lp(0, **dims)
        if eps:
            import dataclasses
            rng = np.random.default_rng(seed)
            noise = lambda t: t * (1 + eps * rng.standard_normal(  # noqa
                t.shape))
            lp = dataclasses.replace(lp, c0=noise(lp.c0), cN=noise(lp.cN))
        r = IPMSolver(partial(SparseArrowBackend, cg_iters=500),
                      Options(record_history=True)).solve(lp)
        extra = dict(eps=eps, seed=seed)
    else:
        from pips_ipmpp_tpu_torch.core.options import Options
        from pips_ipmpp_tpu_torch.io.synthetic import \
            random_sparse_arrowhead_lp
        from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
        from pips_ipmpp_tpu_torch.linalg.sparse_backend import (
            SparseArrowBackend, batched_pcg)
        import dataclasses

        import torch
        lp = random_sparse_arrowhead_lp(0, **dims)
        if eps:
            rng = np.random.default_rng(seed)
            noise = lambda t: t * (1 + eps * torch.from_numpy(  # noqa: E731
                rng.standard_normal(tuple(t.shape))))
            lp = dataclasses.replace(lp, c0=noise(lp.c0), cN=noise(lp.cN))
        r = IPMSolver(partial(SparseArrowBackend, cg_iters=500),
                      Options(record_history=True), device="cpu").solve(lp)
        extra = dict(cg_calls=batched_pcg.calls, cg_capped=batched_pcg.capped,
                     eps=eps, seed=seed)
    print(json.dumps(dict(
        fault="F2", package=which, n=n, status=r.status.name,
        iterations=r.iterations, objective=float(r.objective),
        mu=[h.mu for h in r.history],
        residual=[h.residual_norm for h in r.history], final_mu=float(r.mu),
        final_residual=float(r.residual_norm),
        datanorm=float(lp.datanorm()), seconds=time.perf_counter() - t0,
        **extra)), flush=True)


def init(name):
    """The initial iterate of both packages' host loops (f64, ArrowBackend,
    default Options) on the GAMSsmall instance NAME: per iterate field,
    max |port - jax| / max |jax|."""
    import os

    import torch
    torch.set_num_threads(1)
    _jax_cpu()
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.io.blockfile import read_blocks as jax_read
    from pips_ipmpp_tpu.ipm.solver import _init_fn
    from pips_ipmpp_tpu.linalg.arrow_backend import \
        ArrowBackend as JArrowBackend
    from pips_ipmpp_tpu_torch.core.options import Options
    from pips_ipmpp_tpu_torch.io.blockfile import read_blocks
    from pips_ipmpp_tpu_torch.ipm.device_loop import initial_point
    from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
    from torch_parity import np_tree

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "gamssmall")
    entry = next(m for m in json.load(open(os.path.join(
        data, "manifest.json"))) if m["name"] == name)
    stem = os.path.join(data, name)
    got, _ = initial_point(ArrowBackend(read_blocks(
        stem, n_blocks=entry["n_files"])), Options())
    want, _ = _init_fn(JArrowBackend, JOptions(),
                       jax_read(stem, n_blocks=entry["n_files"]))
    got, want = np_tree(got), np_tree(want)
    rel = {}
    for field in want:
        for part in want[field]:
            w, g = np.asarray(want[field][part]), got[field][part]
            if w.size:
                rel[f"{field}.{part}"] = float(
                    np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
    print(json.dumps(dict(name=name, initial_iterate_rel_diff=rel)))


def _golden_lp(name, device):
    import os

    from pips_ipmpp_tpu_torch.io.blockfile import read_blocks
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "gamssmall")
    entry = next(m for m in json.load(open(os.path.join(
        data, "manifest.json"))) if m["name"] == name)
    return read_blocks(os.path.join(data, name), n_blocks=entry["n_files"],
                       device=device), entry


def f3(name):
    import torch

    import pips_ipmpp_tpu_torch.linalg.arrow_backend as ab
    from pips_ipmpp_tpu_torch.core.options import Options
    from pips_ipmpp_tpu_torch.core.spaces import tmap
    from pips_ipmpp_tpu_torch.ipm import formulation as F
    from pips_ipmpp_tpu_torch.ipm.mehrotra import ipm_step
    from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver

    chols = []
    plain_chol = ab._cholesky

    def chol(S):
        L, ok = plain_chol(S)
        Sd, Ld = S.double(), L.double()
        d = torch.diagonal(Ld, dim1=-2, dim2=-1) ** 2
        chols.append(dict(
            device=S.device.type, n=int(S.shape[-1]), ok=bool(ok),
            backward=float((Ld @ Ld.mT - Sd).abs().max()
                           / Sd.abs().max().clamp(min=1e-300)),
            pivot_ratio=float(d.min() / d.max())))
        return L, ok
    ab._cholesky = chol

    lp_cpu, entry = _golden_lp(name, "cpu")
    be_cpu = ab.ArrowBackend(lp_cpu)
    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa
    plain_step = IPMSolver._step

    def step(self, be, it, dp, dd, k):
        chols.clear()
        new, stats, stats_h = plain_step(self, be, it, dp, dd, k)
        card = list(chols)
        chols.clear()
        new_c, stats_c = ipm_step(be_cpu, tmap(cpu, it), cpu(dp), cpu(dd),
                                  self.opts, iteration=k)
        diff = max(float((a.cpu() - b).abs().max()
                         / b.abs().max().clamp(min=1e-300))
                   for a, b in zip(_leaves(new), _leaves(new_c))
                   if b.numel())
        print(json.dumps(dict(
            k=k, delta_p=float(dp), delta_d=float(dd), ok=stats_h[0],
            ok_cpu=bool(stats_c.factor_ok), mu=float(F.mu(be, new)),
            mu_cpu=float(F.mu(be_cpu, new_c)),
            alpha=stats_h[1:3], alpha_cpu=[float(stats_c.alpha_primal),
                                           float(stats_c.alpha_dual)],
            new_iterate_rel_diff=diff, chol_card=card,
            chol_cpu=list(chols))), flush=True)
        return new, stats, stats_h
    IPMSolver._step = step
    lp, _ = _golden_lp(name, "cuda")
    r = IPMSolver(ab.ArrowBackend, Options(max_iterations=12),
                  device="cuda").solve(lp)
    IPMSolver._step = plain_step
    ab._cholesky = plain_chol
    rc = IPMSolver(ab.ArrowBackend, Options(record_history=True),
                   device="cpu").solve(lp_cpu)
    print(json.dumps(dict(
        fault="F3", name=name, recorded=entry["iterations"],
        card=dict(status=r.status.name, iterations=r.iterations,
                  objective=r.objective),
        cpu=dict(status=rc.status.name, iterations=rc.iterations,
                 objective=rc.objective, mu=[h.mu for h in rc.history]))),
        flush=True)


def f3lapack(device="cuda", *names):
    import math

    import torch

    import pips_ipmpp_tpu_torch.linalg.arrow_backend as ab
    from pips_ipmpp_tpu_torch.core.options import Options
    from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver

    names = names or ("hier_approach_4blocks_2by2",
                      "singletonInequalityColumn_B1")
    port = ab._root_cholesky
    pivots = []

    def recorded(chol):
        def root(S, nb=0):
            L, ok = chol(S, nb)
            if S.device.type == "cpu" or \
                    not torch.cuda.is_current_stream_capturing():
                d = torch.diagonal(L, dim1=-2, dim2=-1) ** 2
                pivots.append(float(d.min() / d.max()))
            return L, ok
        return root

    # torch.linalg (LAPACK on the CPU, cuSOLVER on the card), the plain
    # torch dpotf2 order, and the port's own root (on the card the potf2
    # kernel)
    roots = (("torch.linalg", ab._cholesky),
             ("potf2_plain", lambda S, nb: cholesky_potf2_ref_flagged(S)),
             ("port", port))
    for name in names:
        lp, entry = _golden_lp(name, device)
        budget = math.ceil(1.1 * entry["iterations"])
        for order, chol in roots:
            ab._root_cholesky = recorded(chol)
            solver = IPMSolver(partial(ab.ArrowBackend,
                                       factor_dtype=torch.float64),
                               Options(), device=device)
            for loop in ("host", "fused"):
                pivots.clear()
                r = (solver.solve if loop == "host"
                     else solver.solve_fused)(lp)
                print(json.dumps(dict(
                    fault="F3", name=name, device=device, root=order,
                    loop=loop, graph=r.info.get("graph"),
                    status=r.status.name, iterations=r.iterations,
                    budget=budget, objective=r.objective,
                    recorded_objective=entry["objective"],
                    accepted=(r.status.name == "SUCCESSFUL_TERMINATION"
                              and r.iterations <= budget
                              and abs(r.objective - entry["objective"])
                              < 1e-4),
                    root_pivot_ratios=list(pivots))), flush=True)
        ab._root_cholesky = port


def cholesky_potf2_ref_flagged(S):
    """The plain dpotf2-order Cholesky of (S + S')/2 with its health flag,
    the kernel's arithmetic on any device."""
    import torch

    from pips_ipmpp_tpu_torch.linalg.potf2 import cholesky_potf2_ref
    L, info = cholesky_potf2_ref((S + S.mT) / 2)
    return L, (info == 0) & torch.isfinite(L).flatten(-2).all(-1)


def rounding_band(st, lps, reps):
    """Each LP's single fused solve `reps` times with every input of a
    factorization (the LDL kernel's leaves and roots with f32 factors, the
    Cholesky blocks with f64 factors) times 1 + u E, E symmetric standard
    normal and u the factor dtype's unit roundoff (2^-24, 2^-53): rounding
    noise of the factor arithmetic, as `f3noise` puts 1e-16 on every f64
    Cholesky input.  The noise is drawn on the card
    inside a graph of its own (a fresh draw on every replay, one per
    solve; the same draw on every trip of a loop within it)."""
    import torch

    import chip_smoke as cs
    from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
    from pips_ipmpp_tpu_torch.linalg import arrow_backend as ab

    plain = dict(ldl=ab.ldl_inverse_factors, chol=ab._cholesky,
                 root=ab._root_cholesky)

    def noisy(A):
        u = torch.finfo(A.dtype).eps / 2
        E = torch.randn_like(A)
        return A * (1 + u * (E + E.mT) / 2)

    solver = IPMSolver(st.solver.be_ctor, st.solver.opts, device=cs.DEVICE)
    ab.ldl_inverse_factors = lambda A: plain["ldl"](noisy(A))
    ab._cholesky = lambda S, nb=0: plain["chol"](noisy(S), nb)
    ab._root_cholesky = lambda S, nb=0: plain["root"](noisy(S), nb)
    try:
        solver.solve_fused(lps[0])              # the capture, noise in it
    finally:
        ab.ldl_inverse_factors = plain["ldl"]
        ab._cholesky = plain["chol"]
        ab._root_cholesky = plain["root"]
    torch.manual_seed(0)
    out = [[solver.solve_fused(lp) for _ in range(reps)] for lp in lps]
    del solver
    return out


def batchnoise(path, B, reps=4):
    import os

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    cs.pin_float32_precision()
    st = cs.setup(cs.paths()[path])
    st.solver.opts = st.solver.opts.replace(record_history=True)
    lps = cs.stream_lps(st.lp, int(B))
    _, info = st.solver.solve_fused_batch_async(lps)
    rows = cs.batch_rows(info)
    hist = torch.stack([info["history"].mu, info["history"].residual],
                       -1).tolist()
    singles = [st.solver.solve_fused(lp) for lp in lps]
    bands = rounding_band(st, lps, int(reps))
    for i, (single, band) in enumerate(zip(singles, bands)):
        n = int(rows[i][1])
        print(json.dumps(dict(
            path=path, B=int(B), lp=i, batch_status=int(rows[i][0]),
            batch_iterations=n, batch_objective=rows[i][2],
            batch_mu_residual_last3=hist[i][max(n - 3, 0):n],
            single_status=single.status.name,
            single_iterations=single.iterations,
            single_objective=single.objective,
            single_mu_residual_last3=[
                [h.mu, h.residual_norm] for h in single.history[-3:]],
            single_final_mu_residual=[single.mu, single.residual_norm],
            tolerances=st.solver.opts.tolerances(),
            rounding=[[r.status.name, r.iterations, r.objective]
                      for r in band])), flush=True)


def batchinput(path, B, draws=24):
    """`chip_smoke.py`'s fused_batch phase on one batch path (its checks
    reported, not raised), then each LP's single fused solve `draws`
    times under `chip_smoke.noisy_lp` (1e-16 relative noise on the LP's
    data): the iteration counts and objectives the noise gives."""
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    cs.pin_float32_precision()
    cs._build.build()
    cs._build.load()
    name = f"{path}_batch{B}"
    st = cs.setup(cs.paths()[path])
    try:
        cs.fused_batch(name, st, int(B), ["ldl_inverse_f32"])
    except RuntimeError as e:
        print("fused_batch check failed:", e, flush=True)
    import torch
    for i, lp in enumerate(cs.stream_lps(st.lp, int(B))):
        gen = torch.Generator(device=lp.device).manual_seed(1000 + i)
        runs = [st.solver.solve_fused(cs.noisy_lp(lp, gen))
                for _ in range(int(draws))]
        print(json.dumps(dict(path=path, B=int(B), lp=i,
                              noisy_iterations=[r.iterations for r in runs],
                              noisy_status=sorted({r.status.name
                                                   for r in runs}),
                              noisy_objectives=[r.objective for r in runs])),
              flush=True)


def f32batch(shape, *seeds):
    import dataclasses

    import torch

    from pips_ipmpp_tpu_torch.core.options import Options
    from pips_ipmpp_tpu_torch.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
    from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend

    torch.set_num_threads(1)
    dims = (dict(N=4, n=24, mE=10, mI=12, n0=6, m0E=3, m0I=3, mEl=3, mIl=3)
            if shape == "jax" else dict(N=2, n=48))
    fired = []
    plain = ArrowBackend._assemble_root

    def record(self, *a, **k):
        fac = plain(self, *a, **k)
        fired.append(bool((fac.extra_root > 0).any()))
        return fac
    ArrowBackend._assemble_root = record
    solver = IPMSolver(partial(ArrowBackend, factor_dtype=torch.float32),
                       Options(), device="cpu")
    for seed in map(int, seeds):
        lp = random_arrowhead_lp(seed, **dims)
        fired.clear()
        single = solver.solve_fused(lp)
        escalated = any(fired)
        _, info = solver.solve_fused_batch_async([lp, lp, lp])
        gen = torch.Generator().manual_seed(seed)

        def jitter(t):
            return t * (1 + 1e-15 * torch.randn(t.shape, generator=gen,
                                                dtype=t.dtype))
        noisy = [solver.solve_fused(dataclasses.replace(
            lp, c0=jitter(lp.c0), cN=jitter(lp.cN))).iterations
            for _ in range(3)]
        print(json.dumps(dict(shape=shape, seed=seed,
                              single=single.iterations,
                              status=single.status.name,
                              root_escalation=escalated,
                              batch=info["iterations"].tolist(),
                              noisy=noisy)), flush=True)
    ArrowBackend._assemble_root = plain


def f32triple(*seeds):
    import dataclasses

    import numpy as np
    import torch

    jax = _jax_cpu()
    import jax.numpy as jnp

    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp as jax_lp
    from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend as JArrow
    from pips_ipmpp_tpu_torch.core.options import Options
    from pips_ipmpp_tpu_torch.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
    from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend

    torch.set_num_threads(1)
    dims = dict(N=4, n=24, mE=10, mI=12, n0=6, m0E=3, m0I=3, mEl=3, mIl=3)
    jsolver = JIPMSolver(partial(JArrow, factor_dtype=jnp.float32),
                         JOptions())
    solver = IPMSolver(partial(ArrowBackend, factor_dtype=torch.float32),
                       Options(), device="cpu")

    def triple(lp):
        return [dataclasses.replace(lp, c0=lp.c0 * (1 + 1e-4 * i),
                                    cN=lp.cN * (1 + 1e-4 * i))
                for i in range(3)]
    for seed in map(int, seeds):
        for pkg, sv, make in (("jax", jsolver, jax_lp),
                              ("port", solver, random_arrowhead_lp)):
            lps = triple(make(seed, **dims))
            singles = [sv.solve_fused(lp) for lp in lps]
            _, info = sv.solve_fused_batch_async(lps)
            info = {k: np.asarray(jax.device_get(info[k]))
                    for k in ("iterations", "objective")}
            print(json.dumps(dict(
                seed=seed, package=pkg,
                single_iterations=[s.iterations for s in singles],
                batch_iterations=info["iterations"].tolist(),
                single_objectives=[s.objective for s in singles],
                batch_objectives=info["objective"].tolist())), flush=True)


def _leaves(it):
    from pips_ipmpp_tpu_torch.core.spaces import leaves
    return [x for x in leaves(it) if hasattr(x, "numel")]


def f3noise(name, which, seeds=range(10)):
    import torch
    torch.set_num_threads(1)
    for seed in seeds:
        rng = np.random.default_rng(seed)

        def noise(shape):
            E = rng.standard_normal(shape)
            return 1 + 1e-16 * (E + np.swapaxes(E, -1, -2)) / 2
        if which == "jax":
            jax = _jax_cpu()
            jax.config.update("jax_disable_jit", True)
            import jax.numpy as jnp

            from pips_ipmpp_tpu.core.options import Options
            from pips_ipmpp_tpu.io.blockfile import read_blocks
            from pips_ipmpp_tpu.ipm.solver import IPMSolver
            from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
            plain = jnp.linalg.__dict__.setdefault("_unperturbed",
                                                   jnp.linalg.cholesky)
            jnp.linalg.cholesky = lambda S: plain(  # noqa: E731
                S * noise(S.shape))
            entry = next(m for m in json.load(open(
                "tests/data/gamssmall/manifest.json")) if m["name"] == name)
            r = IPMSolver(ArrowBackend, Options()).solve(read_blocks(
                f"tests/data/gamssmall/{name}", n_blocks=entry["n_files"]))
        else:
            import pips_ipmpp_tpu_torch.linalg.arrow_backend as ab
            from pips_ipmpp_tpu_torch.core.options import Options
            from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
            plain = ab.__dict__.setdefault("_unperturbed", ab._cholesky)
            ab._cholesky = lambda S: plain(  # noqa: E731
                S * torch.from_numpy(noise(tuple(S.shape))))
            lp, entry = _golden_lp(name, "cpu")
            r = IPMSolver(ab.ArrowBackend, Options(), device="cpu").solve(lp)
        print(json.dumps(dict(fault="F3", package=which, name=name,
                              seed=seed, recorded=entry["iterations"],
                              status=r.status.name,
                              iterations=int(r.iterations),
                              objective=float(r.objective))), flush=True)


# scenario -> steps, each an operation and a graph of GRAPHS: m builds the
# graph's setup and its host-loop twin, f runs a fused solve (the first
# captures), r replays its graph bare four times (`chip_smoke.graph_ms`),
# x drops the setup and empties the allocator's cache, p and c
# run a fused solve under the profiler with its CUDA or only its CPU
# activity, h the host loop under the profiler
REPLAY_SCENARIOS = {
    "kept": "mA fA mB fB fA fB fA",
    "freed": "mA fA xA mB fB fB mA fA fA",
    "prof_first": "mA fA pA",
    "prof_second": "mA fA mB fB pB fB",
    "prof_freed": "mA fA xA mB fB pB fB",
    "prof_host": "mA fA mB hB fA",
    "prof_cpu_only": "mA fA mB fB cB fB",
    "sparse_prof": "mC fC fC pC fC",
    "sparse_after_kept": "mA fA mC fC fC fC fA",
    "sparse_after_kept_prof": "mA fA mC fC pC fC",
    "sparse_after_freed": "mA fA xA mC fC fC fC",
    "sparse_after_freed_prof": "mA fA xA mC fC pC fC",
    "sparse_after_freed_prof_cpu": "mA fA xA mC fC cC fC",
    "sparse_after_two_freed_prof": "mA fA xA mB fB xB mC fC pC fC",
    # `profile_port.py --fused`'s order: per graph a capture, a warm
    # solve, bare replays timed, a profiled solve, the setup dropped
    "profile_port_order": "mA fA fA rA pA xA mB fB fB rB pB xB mC fC fC rC "
                          "pC fC",
    "profile_port_order_no_prof": "mA fA fA rA xA mB fB fB rB xB mC fC fC "
                                  "rC fC fC",
    "profile_port_order_no_replay": "mA fA pA xA mB fB pB xB mC fC pC fC",
}
GRAPHS = dict(A="flagship", B="bigleaf", C="sparse_f32")


def replay(*scenarios):
    import gc
    import os
    import subprocess

    if len(scenarios) > 1 or scenarios[0] == "all":
        for sc in REPLAY_SCENARIOS if scenarios[0] == "all" else scenarios:
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "replay", sc], capture_output=True,
                               text=True, timeout=900)
            out = (p.stdout + p.stderr).strip().splitlines()
            print(json.dumps(dict(
                fault="F4", scenario=sc, steps=REPLAY_SCENARIOS[sc],
                rc=p.returncode, steps_ok=sum('"ok": true' in line
                                              for line in out),
                error=next((line for line in out if "Error" in line), None),
                tail=out[-2:])), flush=True)
        return
    import torch

    import chip_smoke as cs
    scenario = scenarios[0]
    from pips_ipmpp_tpu_torch.core.status import TerminationStatus
    sts, hosts = {}, {}

    def fused(g):
        f = sts[g].solver.solve_fused(sts[g].lp)
        h = hosts[g]
        rel = abs(f.objective - h.objective) / max(abs(h.objective), 1.0)
        ok = (f.info["graph"] and f.status == h.status
              == TerminationStatus.SUCCESSFUL_TERMINATION
              and f.iterations == h.iterations and rel <= 1e-6)
        print(json.dumps(dict(scenario=scenario, graph=GRAPHS[g], ok=ok,
                              iterations=f.iterations,
                              host_iterations=h.iterations,
                              objective_rel_host=rel)), flush=True)
        if not ok:
            raise SystemExit(f"fused {GRAPHS[g]} off its host loop")

    def profiled(fn, cpu_only=False):
        acts = [torch.profiler.ProfilerActivity.CPU] if cpu_only else \
            [torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        print(json.dumps(dict(scenario=scenario, profiled_events=sum(
            e.count for e in prof.key_averages()))), flush=True)

    for op, g in REPLAY_SCENARIOS[scenario].split():
        if op == "m":
            sts[g] = cs.setup(cs.paths()[GRAPHS[g]])
            hosts[g] = sts[g].solver.solve(sts[g].lp)
        elif op == "f":
            fused(g)
        elif op == "r":
            cs.graph_ms(sts[g].solver)
        elif op == "x":
            del sts[g]
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        elif op in "pc":
            profiled(lambda: fused(g), cpu_only=op == "c")
        elif op == "h":
            profiled(lambda: sts[g].solver.solve(sts[g].lp))
    torch.cuda.synchronize()
    print(json.dumps(dict(scenario=scenario, done=True)), flush=True)


def f2cg(n, k, trips):
    _jax_cpu()
    import jax.numpy as jnp
    import torch

    from pips_ipmpp_tpu.io.synthetic import \
        random_sparse_arrowhead_lp as jax_lp
    from pips_ipmpp_tpu.ipm import formulation as JF
    from pips_ipmpp_tpu.linalg import sparse_backend as jsb
    from pips_ipmpp_tpu_torch.core.options import Options
    from pips_ipmpp_tpu_torch.io.synthetic import random_sparse_arrowhead_lp
    from pips_ipmpp_tpu_torch.ipm import formulation as TF
    from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
    from pips_ipmpp_tpu_torch.linalg import sparse_backend as tsb
    from torch_parity import jspace, np_tree, tspace

    torch.set_num_threads(1)
    dims = dict(N=8, n=n, mE=n // 2, mI=n // 2, nnz_per_row=10, n0=16,
                m0E=4, m0I=4, mEl=4, mIl=4)
    lp = random_sparse_arrowhead_lp(0, **dims)
    saved = {}

    def keep(i, it, _info):
        if i + 1 == k:
            saved["it"] = np_tree(it)
    IPMSolver(partial(tsb.SparseArrowBackend, cg_iters=500),
              Options(max_iterations=k), device="cpu").solve(
        lp, callback=keep)
    parts = saved["it"]
    tbe = tsb.SparseArrowBackend(lp, cg_iters=500)
    jbe = jsb.SparseArrowBackend(jax_lp(0, **dims), cg_iters=500)

    class Stop(Exception):
        pass
    cap = {}

    def grab(name):
        def leaf_cg(Einv, Fd, dinv, Bc):
            cap[name] = [np.array(v) for v in (Einv, Fd, dinv, Bc)]
            raise Stop
        return leaf_cg
    tbe._leaf_cg, jbe._leaf_cg = grab("port"), grab("jax")
    for be, F_, space, name in ((tbe, TF, tspace, "port"),
                                (jbe, JF, jspace, "jax")):
        it = F_.Iterate(**{f: space(v) for f, v in parts.items()})
        Dx, Ominv = F_.kkt_diagonals(be, it)
        try:
            be.factorize(Dx, Ominv, 1e-10, 1e-10)
        except Stop:
            pass

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
    print(json.dumps(dict(fault="F2", n=n, k=k, inputs_rel_diff={
        name: rel(a, b) for name, a, b in zip(
            ("Einv", "Fd", "dinv", "rhs"), cap["port"], cap["jax"])})),
        flush=True)
    Einv, Fd, dinv, B = cap["jax"]
    tE, tF, td, tB = (torch.from_numpy(v) for v in cap["jax"])
    jE, jF, jd, jB = (jnp.asarray(v) for v in cap["jax"])

    def japply(V):
        return jbe._neq_apply(jE, jF, V)

    def bridged(V):
        return torch.from_numpy(np.array(japply(jnp.asarray(V.numpy()))))

    def jcg(Bx, m):
        return np.array(jsb.batched_pcg(japply, jnp.asarray(Bx), jd, m,
                                        1e-12)[0])

    def tcg(Bx, m, apply=None):
        apply = apply or (lambda V: tbe._neq_apply(tE, tF, V))
        return tsb.batched_pcg(apply, torch.from_numpy(Bx), td, m,
                               1e-12)[0].numpy()

    def resid(X):
        R = np.array(japply(jnp.asarray(X))) - B
        return float((np.sqrt((R * R).sum(1))
                      / np.sqrt((B * B).sum(1))).max())
    noisy = B * (1 + 1e-16 * np.random.default_rng(0).standard_normal(
        B.shape))
    for m in trips:
        J, T = jcg(B, m), tcg(B, m)
        print(json.dumps(dict(
            fault="F2", trips=m, port_vs_jax=rel(T, J),
            port_loop_jax_operator_vs_jax=rel(tcg(B, m, bridged), J),
            jax_noise=rel(jcg(noisy, m), J), port_noise=rel(tcg(noisy, m), T),
            residual_jax=resid(J), residual_port=resid(T))), flush=True)


def golden(root, name, device):
    import os
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp
    from pips_ipmpp_tpu_torch.core.options import Options
    from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
    from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "gamssmall")
    entry = next(m for m in json.load(open(os.path.join(
        data, "manifest.json"))) if m["name"] == name)
    stem = os.path.join(data, name)
    meta, b0 = np.load(f"{stem}_meta.npz"), np.load(f"{stem}_block0.npz")
    first = {k: b0[k] for k in ("c", "A", "b", "C", "iclow", "clow",
                                "icupp", "cupp", "ixlow", "xlow", "ixupp",
                                "xupp", "F0", "G0")}
    blocks = []
    for i in range(entry["n_files"] - 1):
        bf = np.load(f"{stem}_block{i + 1}.npz")
        blocks.append({k: bf[k] for k in (
            "c", "A", "B", "b", "C", "D", "iclow", "clow", "icupp", "cupp",
            "ixlow", "xlow", "ixupp", "xupp", "F", "G")})
    lp = make_arrowhead_lp(
        blocks, first, linking_eq={"b": meta["bl"]},
        linking_ineq={k: meta[k + "l"] for k in ("iclow", "clow", "icupp",
                                                 "cupp")},
        dtype=torch.float64, device=device)
    r = IPMSolver(partial(ArrowBackend, factor_dtype=torch.float64),
                  Options(record_history=True), device=device).solve(lp)
    print(json.dumps(dict(root=root, name=name, device=device,
                          status=r.status.name, iterations=r.iterations,
                          objective=float(r.objective),
                          mu=[h.mu for h in r.history[:8]])))


def f6cr(*seeds):
    jax = _jax_cpu()
    import jax.numpy as jnp
    import torch

    from pips_ipmpp_tpu.core.options import ScalerType as JScalerType
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu.linalg.dense_backend import random_dense_lp
    from pips_ipmpp_tpu.scale import scaling as jsc
    from pips_ipmpp_tpu_torch import DenseLP, bridge
    from pips_ipmpp_tpu_torch.core.options import ScalerType
    from pips_ipmpp_tpu_torch.scale import scaling as tsc
    from torch_parity import jax_fields, np_tree

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        return [np.asarray(t)]

    def port(jlp):
        cls = DenseLP if hasattr(jlp, "A") and not hasattr(jlp, "N") \
            else None
        kw = dict(cls=cls) if cls else {}
        return bridge.lp_from_numpy(jax_fields(jlp), device="cpu",
                                    dtype=torch.float64, **kw)

    cases = []
    for k in [int(a) for a in seeds] or range(6):
        cases += [("dense", k, dict(n=16, mE=5, mI=7)),
                  ("dense", k, dict(n=24, mE=7, mI=9)),
                  ("arrow", k, dict(N=4, n=6, mE=2, mI=3, n0=3, m0E=1,
                                    m0I=2, mEl=2, mIl=2))]
    for kind, k, shape in cases:
        jlp = (random_dense_lp(jax.random.PRNGKey(k), **shape)
               if kind == "dense" else random_arrowhead_lp(k, **shape))
        tlp = port(jlp)
        js = jsc.make_scaler(JScalerType.CURTIS_REID)
        ts = tsc.make_scaler(ScalerType.CURTIS_REID)
        js.scale(jlp)
        ts.scale(tlp)
        row = dict(view=kind, seed=k, shape=shape, factors_differ=sum(
            int((a != b).sum()) for name in ("s", "rE", "rC")
            for a, b in zip(leaves(np_tree(getattr(js, name))),
                            leaves(np_tree(getattr(ts, name))))))
        if kind == "dense":
            seen, round_ = [], jnp.round
            jnp.round = lambda v, *a, **kw: (seen.append(np.asarray(v)),
                                             round_(v, *a, **kw))[1]
            try:
                js._compute(jsc._view(jlp))
            finally:
                jnp.round = round_
            rho_j, gamma_j = np.concatenate(seen[:2]), seen[2]
            gamma, rhoE, rhoC = ts.log2_factors(tsc._view(tlp))
            rho_t = torch.cat([rhoE, rhoC]).numpy()
            nz = np.concatenate([np.asarray(jlp.A), np.asarray(jlp.C)]) != 0
            row.update(
                log2_row_shift=float(np.abs(rho_t - rho_j).max()),
                log2_sum_diff=float(np.abs(
                    (rho_t[:, None] + gamma.numpy()[None, :])
                    - (rho_j[:, None] + gamma_j[None, :]))[nz].max()))
        print(json.dumps(row), flush=True)



def climps(T, which="both"):
    import contextlib
    import io
    import resource
    import tempfile

    _jax_cpu()
    from pips_ipmpp_tpu.io.energy import (dispatch_blocks, highs_oracle,
                                          to_scipy, write_mps)

    T = int(T)
    blocks, first, leq, liq, _ = dispatch_blocks(T=T, R=150, G=550, L=350,
                                                 S=4, seed=5)
    oracle, _ = highs_oracle(blocks, first, leq, liq)
    c, A_eq, b_eq, A_ub, lb_ub, ub_ub, lo, hi = to_scipy(blocks, first, leq,
                                                         liq)
    with tempfile.TemporaryDirectory() as d:
        mps = f"{d}/energy{T}.mps"
        write_mps(mps, blocks, first, leq, liq)
        for pkg in ("jax", "port"):
            if which not in ("both", pkg):
                continue
            if pkg == "jax":
                from pips_ipmpp_tpu.cli import main
            else:
                from pips_ipmpp_tpu_torch.cli import main as tmain
                main = partial(tmain, device="cpu")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main(["--mps", mps, "--auto-blocks", str(T),
                           "printsol"])
            seconds = time.perf_counter() - t0
            lines = buf.getvalue().splitlines()
            pick = lambda key: next((ln for ln in lines  # noqa: E731
                                     if ln.startswith(key)), None)
            row = dict(package=pkg, T=T, rc=rc, seconds=seconds,
                       structure=pick("auto-structure:"),
                       objective_line=pick("optimal objective:"),
                       solve_line=pick("solve time:") or pick("termination:"),
                       highs=oracle, max_rss_gb=resource.getrusage(
                           resource.RUSAGE_SELF).ru_maxrss / 1e6)
            if rc == 0:
                obj = float(row["objective_line"].split(":")[1])
                sol = np.load(f"{d}/energy{T}_solution.npz")
                x = sol["x"]
                act = A_ub @ x
                row.update(
                    iterations=int(row["solve_line"].rsplit(":", 1)[1]),
                    objective=obj, solution_objective=float(sol["objective"]),
                    highs_rel=abs(obj - oracle) / abs(oracle),
                    cx=float(c @ x),
                    eq_resid=float(np.abs(A_eq @ x - b_eq).max()),
                    ineq_violation=float(max(np.max(act - ub_ub),
                                             np.max(lb_ub - act), 0.0)),
                    bound_violation=float(max(np.max(lo - x),
                                              np.max(x - hi), 0.0)))
            print(json.dumps(row), flush=True)

def f32root(T, case):
    import os
    import tempfile

    if case == "jax_p32":
        os.environ["PIPS_LDL_PANEL"] = "32"
    _jax_cpu()
    from pips_ipmpp_tpu.io.energy import (dispatch_blocks, highs_oracle,
                                          write_mps)

    T = int(T)
    blocks, first, leq, liq, _ = dispatch_blocks(T=T, R=150, G=550, L=350,
                                                 S=4, seed=5)
    oracle, _ = highs_oracle(blocks, first, leq, liq)
    with tempfile.TemporaryDirectory() as d:
        mps = f"{d}/energy{T}.mps"
        write_mps(mps, blocks, first, leq, liq)
        del blocks, first, leq, liq
        if case.startswith("jax"):
            from pips_ipmpp_tpu.core.dissect import auto_structure
            from pips_ipmpp_tpu.core.options import Options, StepMode
            from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
            from pips_ipmpp_tpu.io.mps import read_mps
            lp, _ = auto_structure(read_mps(mps), T)
            make = partial(PIPSIPMppTPUInterface, lp)
        else:
            import torch

            from pips_ipmpp_tpu_torch import interface
            from pips_ipmpp_tpu_torch.core.dissect import auto_structure
            from pips_ipmpp_tpu_torch.core.options import Options, StepMode
            from pips_ipmpp_tpu_torch.io.mps import read_mps
            from pips_ipmpp_tpu_torch.linalg import arrow_backend, ldl
            torch.set_num_threads(4)
            if case.startswith("port_root32"):
                interface.ROOT_F32_MAX = float("inf")
            if case.endswith("blocked"):
                arrow_backend.ldl_inverse_factors = partial(
                    ldl.ldl_inverse_factors_blocked_ref, nb=64)
            lp, _ = auto_structure(read_mps(mps), T)
            make = partial(interface.PIPSIPMppTorchInterface, lp,
                           device="cpu")
    # the CLI's options (its per-iteration lines show a stall as it goes)
    opts = Options(print_level=10, step_mode=StepMode.PRIMAL,
                   factor_dtype="float32")
    t0 = time.perf_counter()
    iface = make(opts)
    status = iface.run()
    obj = float(iface.getObjective())
    print(json.dumps(dict(
        case=case, T=T, status=status.name, iterations=iface.n_iterations,
        objective=obj, highs=oracle, highs_rel=abs(obj - oracle) / abs(oracle),
        root_width=lp.n0 + lp.m0E + lp.m0I + lp.mEl + lp.mIl,
        seconds=time.perf_counter() - t0)), flush=True)


def hier(T, dtype, *args):
    _jax_cpu()
    from pips_ipmpp_tpu.io.energy import dispatch_blocks, highs_oracle

    layers = int(next((a for a in args if a.isdigit()), 2))
    presolve = "presolve" in args
    which = [a for a in args if a in ("jax", "port")] or ["jax", "port"]
    T = int(T)
    blocks, first, leq, liq, _ = dispatch_blocks(T=T, R=150, G=550, L=350,
                                                 S=4, seed=5)
    oracle, _ = highs_oracle(blocks, first, leq, liq)
    settings = dict(max_iterations=300, max_gondzio_correctors=1,
                    refinement_steps=2, hierarchical=True,
                    hierarchical_layers=layers,
                    factor_dtype={"f64": "float64", "f32": "float32"}[dtype])
    for pkg in which:
        if pkg == "jax":
            import jax.numpy as jnp

            from pips_ipmpp_tpu.core.lp import make_arrowhead_lp
            from pips_ipmpp_tpu.core.options import (Options, PresolverType,
                                                     ScalerType)
            from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
            lp = make_arrowhead_lp(blocks, first, leq, liq,
                                   dtype=jnp.float64)
            make = partial(PIPSIPMppTPUInterface, lp)
        else:
            import torch

            from pips_ipmpp_tpu_torch.core.lp import \
                make_arrowhead_lp as tmake
            from pips_ipmpp_tpu_torch.core.options import (Options,
                                                           PresolverType,
                                                           ScalerType)
            from pips_ipmpp_tpu_torch.interface import \
                PIPSIPMppTorchInterface
            torch.set_num_threads(4)
            lp = tmake(blocks, first, leq, liq, dtype=torch.float64)
            make = partial(PIPSIPMppTorchInterface, lp, device="cpu")
        opts = Options(scaler=ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM,
                       presolve=(PresolverType.PRESOLVE if presolve
                                 else PresolverType.NONE), **settings)
        t0 = time.perf_counter()
        iface = make(opts)
        status = iface.run()
        obj = float(iface.getObjective())
        m = iface._hier_meta
        print(json.dumps(dict(
            package=pkg, T=T, dtype=dtype, layers=layers, presolve=presolve,
            status=status.name, iterations=iface.n_iterations,
            objective=obj, highs=oracle,
            highs_rel=abs(obj - oracle) / abs(oracle),
            n_groups=m.n_groups, mElL=m.mElL, mIlL=m.mIlL, mElG=m.mElG,
            mIlG=m.mIlG, levels=[list(v) for v in m.levels],
            seconds=time.perf_counter() - t0)), flush=True)


def hiernoise(name, which, *seeds):
    import torch
    torch.set_num_threads(1)
    entry = next(m for m in json.load(open(
        "tests/data/gamssmall/manifest.json")) if m["name"] == name)
    stem = f"tests/data/gamssmall/{name}"
    for seed in [int(s) for s in seeds] or [-1, *range(10)]:
        rng = np.random.default_rng(max(seed, 0))

        def noise(shape):
            if seed < 0:
                return np.ones(shape)
            E = rng.standard_normal(shape)
            return 1 + 1e-16 * (E + np.swapaxes(E, -1, -2)) / 2
        if which == "jax":
            jax = _jax_cpu()
            jax.config.update("jax_disable_jit", seed >= 0)
            import jax.numpy as jnp

            from pips_ipmpp_tpu.core.options import Options
            from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
            from pips_ipmpp_tpu.io.blockfile import read_blocks
            plain = jnp.linalg.__dict__.setdefault("_unperturbed",
                                                   jnp.linalg.cholesky)
            jnp.linalg.cholesky = lambda S: plain(  # noqa: E731
                S * noise(S.shape))
            iface = PIPSIPMppTPUInterface(
                read_blocks(stem, n_blocks=entry["n_files"]),
                Options(hierarchical=True))
        else:
            import pips_ipmpp_tpu_torch.linalg.arrow_backend as ab
            from pips_ipmpp_tpu_torch.core.options import Options
            from pips_ipmpp_tpu_torch.interface import \
                PIPSIPMppTorchInterface
            from pips_ipmpp_tpu_torch.io.blockfile import read_blocks
            plain = ab.__dict__.setdefault("_unperturbed", ab._cholesky)
            ab._cholesky = lambda S, nb=0: plain(  # noqa: E731
                S * torch.from_numpy(noise(tuple(S.shape))), nb)
            iface = PIPSIPMppTorchInterface(
                read_blocks(stem, n_blocks=entry["n_files"]),
                Options(hierarchical=True), device="cpu")
        status = iface.run()
        print(json.dumps(dict(package=which, name=name, seed=seed,
                              recorded=entry["iterations"],
                              status=status.name,
                              iterations=int(iface.n_iterations),
                              objective=float(iface.getObjective()))),
              flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "hiernoise":
        hiernoise(*sys.argv[2:])
        sys.exit(0)
    if sys.argv[1] == "hier":
        hier(*sys.argv[2:])
        sys.exit(0)
    if sys.argv[1] == "f32root":
        f32root(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1] == "climps":
        climps(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1] == "f1":
        f1(sys.argv[2])
    elif sys.argv[1] == "init":
        init(sys.argv[2])
    elif sys.argv[1] == "f2cg":
        f2cg(int(sys.argv[2]), int(sys.argv[3]), [int(a) for a in sys.argv[4:]])
    elif sys.argv[1] == "f3noise":
        f3noise(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "replay":
        replay(*sys.argv[2:])
    elif sys.argv[1] == "f32triple":
        f32triple(*sys.argv[2:])
    elif sys.argv[1] == "f32batch":
        f32batch(*sys.argv[2:])
    elif sys.argv[1] == "batchinput":
        batchinput(*sys.argv[2:5])
    elif sys.argv[1] == "batchnoise":
        batchnoise(*sys.argv[2:5])
    elif sys.argv[1] == "f3lapack":
        f3lapack(*sys.argv[2:])
    elif sys.argv[1] == "f3":
        f3(sys.argv[2])
    elif sys.argv[1] == "golden":
        golden(*sys.argv[2:5])
    elif sys.argv[1] == "f6cr":
        f6cr(*sys.argv[2:])
    else:
        f2(int(sys.argv[2]), sys.argv[3], *map(float, sys.argv[4:5]),
           *map(int, sys.argv[5:6]))
