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
    package's own sweep acceptance LP, against its analytic optimum.

`paths()` defines the solves; `profile_port.py` profiles the same ones.

Every failure raises and exits nonzero.  The last line of standard output
is a JSON object naming the device, the line before it the card's name and
power limit, the line before that the kernels with their launch counts,
errors, times and bounds.

Needs one CUDA device; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from functools import lru_cache, partial

import torch

from pips_ipmpp_tpu_torch import (Options, PIPSIPMppTorchInterface,
                                  TerminationStatus, _build)
from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp
from pips_ipmpp_tpu_torch.core.options import ScalerType
from pips_ipmpp_tpu_torch.io.synthetic import (random_arrowhead_lp,
                                               random_sparse_arrowhead_lp)
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver, pin_float32_precision
from pips_ipmpp_tpu_torch.linalg import ldl, spmv, sweep
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
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
# the JAX package's reference-scale sparse acceptance instance
# (tests/test_sparse.py:186-201) and its HiGHS f64 oracle objective
SPARSE = dict(N=8, n=8192, mE=4096, mI=4096, nnz_per_row=10, n0=16, m0E=4,
              m0I=4, mEl=4, mIl=4)
SPARSE_ORACLE = -27135.692927917404
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


def timings(kernel, plain, library, reps, plain_reps):
    """Device and wall (CUDA events around one call, host dispatch
    included) milliseconds of the kernel, its plain version and, where
    there is one, the library call computing the same function."""
    out = dict(ms=device_ms(kernel, reps), wall_ms=cuda_ms(kernel, reps),
               plain_ms=device_ms(plain, plain_reps),
               plain_wall_ms=cuda_ms(plain, plain_reps),
               library_ms=None, library_wall_ms=None)
    if library is not None:
        out.update(library_ms=device_ms(library, reps),
                   library_wall_ms=cuda_ms(library, reps))
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
           "sweep_inverse": sweep.sweep_inverse}


def reset_counts():
    for fn in COUNTED.values():
        fn.launches = 0
    spmv.ell_spmm.launches_by.clear()
    batched_pcg.readbacks = batched_pcg.calls = batched_pcg.capped = 0


def read_counts():
    return {name: fn.launches for name, fn in COUNTED.items()}


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


def check_ldl_kernel():
    lib = _build.load()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for B, a, n_pos in LDL_SHAPES:
        A = ldl_input(B, a, n_pos, gen)
        A32 = A.float().contiguous()
        Xr, dr = ldl.ldl_inverse_factors_ref(A)            # f64 reference
        ref_inv = ldl.inverse_from_factors(Xr, dr)
        Xk, dk = ldl.ldl_inverse_factors(A32)
        torch.cuda.synchronize()
        Xp, dp = ldl.ldl_inverse_factors_ref(A32)           # plain f32
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
                        lambda: ldl.ldl_inverse_factors_ref(A32), library,
                        10, 3)
        # LDL^T (a^3/3 flops) + the unit-lower inverse (a^3/3)
        bound_ms, bound_by = bound((2 * B * a * a + B * a) * 4,
                                   B * 2 * a ** 3 / 3, torch.float32)
        row = dict(shape=[B, a, a], n_pos=n_pos, kernel_rel_err=err_k,
                   plain_f32_rel_err=err_p, kernel_abs_err=abs_k,
                   pivot_signs_equal=signs, inertia_ok=ok, **times,
                   bound_ms=bound_ms, bound_by=bound_by,
                   nb=lib.ldl_inverse_nb(a),
                   cuda_launches_per_call=lib.ldl_inverse_launches(a))
        print("ldl_check", json.dumps(row), flush=True)
        require(err_k <= 4.0 * err_p + 1e-6,
                f"LDL kernel error {err_k:.3e} > 4 x plain {err_p:.3e} + 1e-6 "
                f"at {[B, a, a]}")
        require(signs and ok, f"LDL kernel pivot signs differ at {[B, a, a]}")
        del A, A32, Xr, dr, ref_inv, Xk, dk, Xp, dp
        torch.cuda.empty_cache()
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
            torch.cuda.synchronize()
            Yp = spmv.ell_spmm_ref(op.ell.val, op.ell.col, X, **epi)
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
                library, 20, 5))
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
        torch.cuda.synchronize()
        Ip, _ = sweep.sweep_inverse_ref(A32)
        err_k, abs_k = rel_err(Ik, ref_inv)
        err_p, _ = rel_err(Ip, ref_inv)
        ok = bool(ldl.inverse_ok(Ik, dk, n_pos))
        times = timings(lambda: sweep.sweep_inverse(A32),
                        lambda: sweep.sweep_inverse_ref(A32),
                        lambda: torch.linalg.inv(A32), 10, 3)
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
    import numpy as np

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

    return {fn.__name__: fn
            for fn in (flagship, bigleaf, sparse_f32, sparse_f64, sweep)}


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


def dense_path(name, f32_run, f64_run, n_vars, kernel):
    """The f64 reference (no kernel launch allowed), then the f32 path."""
    ref, ref_counts = drive(f"{name} f64 reference", f64_run, [])
    require(not any(ref_counts.values()),
            f"{name}: the f64 reference launched {ref_counts}")
    require(ref["status"] == TerminationStatus.SUCCESSFUL_TERMINATION,
            f"{name}: f64 reference status {ref['status']}")
    out, counts = drive(name, f32_run, [kernel])
    report(name, out, counts, ref["objective"], OBJ_RTOL, n_vars,
           f64_iterations=ref["iterations"], f64_solve_s=ref["solve_s"])
    require(counts[kernel] >= 2 * out["iterations"],
            f"{name}: {counts[kernel]} {kernel} launches for "
            f"{out['iterations']} iterations")
    return counts, out


def main():
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

    total = dict.fromkeys(COUNTED, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    P = paths()
    f64_factors = partial(ArrowBackend, factor_dtype=torch.float64)

    # ---- 4. dense main path: flagship through the facade ----
    flag, opts, _ = P["flagship"]()
    add(dense_path(
        "flagship_facade", partial(facade_run, flag, opts),
        partial(facade_run, flag.astype(torch.float64),
                opts.replace(factor_dtype="float64")),
        flag.total_vars(), "ldl_inverse_f32")[0])

    # ---- 5. dense main path: big leaves, bench production configuration
    big, opts, backend = P["bigleaf"]()
    add(dense_path(
        "bigleaf_ipmsolver", partial(solver_run, big, backend, opts),
        partial(solver_run, big, f64_factors, opts),
        big.total_vars(), "ldl_inverse_f32")[0])

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
    sweep_counts, sweep_out = dense_path(
        "sweep_ipmsolver", partial(solver_run, sweep_lp, backend, opts),
        partial(solver_run, sweep_lp, f64_factors, opts),
        sweep_lp.total_vars(), "sweep_inverse")
    add(sweep_counts)
    require(abs(sweep_out["objective"] - SWEEP_OPTIMUM)
            <= OBJ_RTOL * (1.0 + SWEEP_OPTIMUM),
            f"sweep solve objective {sweep_out['objective']} is not the "
            f"optimum {SWEEP_OPTIMUM}")

    # ---- 9. the kernels line ----
    leaf = ldl_rows[0]
    ell = next(r for r in ell_rows if r["case"] == "fwd"
               and r["dtype"] == "float32" and r["c"] > 1)
    sw = sweep_rows[0]
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
