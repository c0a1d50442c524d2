"""Where the time of the port's solves goes, on one CUDA card.

    python3 profile_port.py [path ...] [--window W] [--cg-iters K]
    python3 profile_port.py --ldl [--ldl-against DIR]
    python3 profile_port.py --ell [--ell-against DIR]
    python3 profile_port.py --sweep [--sweep-against DIR]
    python3 profile_port.py --potf2 [--potf2-against DIR]
    python3 profile_port.py --fused [path ...] [--reps R]

Paths are `chip_smoke.paths()`: `flagship`, `bigleaf`, `sparse_f32`,
`sparse_f64` and `sweep` (default: every path), each solved by the
IPMSolver that the facade or `chip_smoke.py` builds for it.  `--cg-iters`
sets the leaf CG's cap on the paths that name their own sparse backend
(`sparse_f64`; chip_smoke.py uses 500).

Each path is solved once to warm up, once timed (host clock around work
that ends in `torch.cuda.synchronize()`), and once more with
`torch.profiler` (CUDA activity) on for `--window` iterations (default 4)
from the middle of the solve; `--window 0` makes the timed solve the only
one.  Per path one JSON line: iterations, status, objective, solve
seconds, iterations per second, the hand-written kernels' launch counts
(the ELL kernel's also per operator and width) and the CG's read-backs,
calls and capped calls of the timed solve; for the window, kernel
launches (`*LaunchKernel*` runtime calls) and device time per iteration,
the busy share (device time over the window's host-clock time) and the
kernels that took the most device time, every CUDA runtime call's count
and host milliseconds per iteration; and the iterations' mu,
residual, step lengths and Gondzio correctors.  The last
line is the card's name and power limit.

`--fused` times the fused loop (`solve_fused`) instead, on
`chip_smoke.FUSED_PATHS` and the batches of `chip_smoke.BATCH_PATHS`
(`solve_fused_batch_async` over B LPs of the bench's stream; default:
every single path; run one per process: a third profiler session in one
process faulted on the sparse graph's replay, ROADMAP.md §3, F4): per
path one JSON line with the first call (capture included), `--reps` warm
solves, the graph's replay alone (CUDA events), the busy share and the
host's CUDA calls per warm solve.

`--ldl` times the LDL kernel instead, at `chip_smoke.LDL_SHAPES`: per
shape one JSON line with its device time per call (profiler), each of its
CUDA kernels' share and launches, and its error against the f64 inverse
beside the plain f32 version's (`chip_smoke.rel_err`).  `--ldl-against
DIR` also builds `DIR/pips_ipmpp_tpu_torch/csrc/ldl_inverse.cu` (another
checkout, for example the parent commit unpacked with `git archive`) with
the same flags, gives its error too, and times the two in turns, other,
this, this, other; a shape the other kernel refuses shows its CUDA error
instead.

`--ell` times the ELL kernel instead, on every product the sparse
backend launches at the 8 x 8192 instance (`chip_smoke.ell_cases`, f32
and f64): per case one JSON line with its device time per call, its
error against the plain version, its bound (`chip_smoke.ell_bound`) and,
for a product without epilogue, `torch.sparse.mm`'s device time on the
block-diagonal CSR matrix (`chip_smoke.block_csr`).
`--ell-against DIR` also builds `DIR/pips_ipmpp_tpu_torch/csrc/ell_spmm.cu`
alone and times the two in turns, other, this, this, other.  A source
that reads the padded K-major ELL (the kernel before the sliced layout)
gets K-major copies of the padded operators, and its epilogue cases run
as its product followed by the separate torch operations, as its
backend ran them; a source that reads the sliced layout gets this tree's
operators.

`--sweep` times the sweep kernel instead, at `chip_smoke.SWEEP_SHAPES`:
per shape one JSON line with its device time per call, each of its CUDA
kernels' share and launches (the pivot block, the panel and the update,
and the wrapper's identity padding where a is odd), its CUDA launches per
call, and its error against the f64 inverse beside the plain f32
version's.  `--sweep-against DIR` also builds
`DIR/pips_ipmpp_tpu_torch/csrc/sweep_inverse.cu` alone, gives its error
too, and times the two in turns, other, this, this, other, the other
behind the identity padding to a multiple of 16 that its wrapper gave
it; a library without `sweep_inverse_workspace` (the one-CTA kernel of
earlier commits) takes no scratch, and a shape it refuses shows its CUDA
error instead.

`--potf2` times the f64 root Cholesky kernel instead, at
`chip_smoke.POTF2_SHAPES` and the energy LP's root blocks (550 and 385),
beside `torch.linalg.cholesky_ex`: per shape one JSON line with its
milliseconds per call from CUDA events over back-to-back calls
(`loop_ms`: the profiler misreads one-CTA kernels, and where the host's
launches set the pace this is an upper bound) and over the same calls
captured into one CUDA graph (`graph_ms`: no host launch between
kernels), its CUDA launches per call, each of its CUDA kernels' device
time and launches per call (profiler), the serial chain's floor,
ceil(n / nb) times the diagonal-block kernel's time per panel (its
part in a call at an edge of nb + 1, the first line), and its bound
(`chip_smoke.bound`).  `--potf2-against DIR` also builds
`DIR/pips_ipmpp_tpu_torch/csrc/potf2.cu` alone (the same C interface; a
[B, 3n] workspace covers every version), requires its factor and info to
equal this kernel's bit for bit, and times the two in turns, other,
this, this, other (mean of the two turns in `*_mean`).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import torch

import chip_smoke as cs
from pips_ipmpp_tpu_torch import _build
from pips_ipmpp_tpu_torch.core.options import ScalerType
from pips_ipmpp_tpu_torch.ipm.solver import pin_float32_precision
from pips_ipmpp_tpu_torch.linalg import ldl, potf2, spmv, sweep
from pips_ipmpp_tpu_torch.linalg.sparse_backend import (SparseArrowBackend,
                                                        batched_pcg)
from pips_ipmpp_tpu_torch.scale import make_scaler


def profile(name, make, window, cg_iters):
    st = cs.setup(make, cg_iters)
    lp, solver = st.lp, st.solver
    if window:
        solver.solve(lp)                               # warm-up
        torch.cuda.synchronize()
    cs.reset_counts()
    t0 = time.perf_counter()
    res = solver.solve(lp)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    it = res.iterations
    row = dict(path=name, status=res.status.name, iterations=it,
               objective=res.objective, solve_s=solve_s,
               iter_per_s=it / solve_s, kernels=cs.read_counts(),
               cg_readbacks=batched_pcg.readbacks,
               cg_readbacks_per_iteration=batched_pcg.readbacks / max(it, 1),
               cg_calls=batched_pcg.calls, cg_capped=batched_pcg.capped,
               ell_launches_by={f"{op}/c={c}": v for (op, c), v in sorted(
                   spmv.ell_spmm.launches_by.items())},
               history=[[h.mu, h.residual_norm, h.alpha_primal,
                         h.alpha_dual, h.n_gondzio] for h in res.history])
    if window:
        row.update(profile_window(lp, solver, it, window))
    print(json.dumps(row), flush=True)


def profile_window(lp, solver, it, window):
    """Solve once more with the profiler on for `window` iterations from
    the middle of the solve."""
    k0 = max(0, min(it - window, it // 2 - window // 2))
    k1 = min(it, k0 + window)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    clock = {}

    def callback(k, _it, _info):
        if k + 1 == k0:
            torch.cuda.synchronize()
            prof.start()
            clock["t0"] = time.perf_counter()
        if k + 1 == k1:
            torch.cuda.synchronize()
            clock["t1"] = time.perf_counter()
            prof.stop()

    if k0 == 0:
        torch.cuda.synchronize()
        prof.start()
        clock["t0"] = time.perf_counter()
    solver.solve(lp, callback=callback)
    events = prof.key_averages()
    window_s = clock["t1"] - clock["t0"]
    n = k1 - k0
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    # every CUDA runtime call of the window: calls and host milliseconds
    # per iteration (a copy from pageable memory or a synchronize holds
    # the host until the device has drained its queue)
    runtime = {e.key: [e.count / n, e.cpu_time_total / 1e3 / n]
               for e in events if e.key.startswith("cuda")}
    device = [e for e in events if e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    return dict(window=[k0, k1], window_s=window_s,
                launches_per_iteration=launches / n,
                device_ms_per_iteration=device_ms / n,
                busy_share=device_ms / 1e3 / window_s,
                runtime_per_iteration=runtime,
                top_device=[dict(name=e.key[:80], count=e.count,
                                 ms=e.self_device_time_total / 1e3)
                            for e in top])


def profile_fused(name, reps):
    """One fused path (`chip_smoke.FUSED_PATHS`): the first call (build,
    warm-up turn, capture and solve), then `reps` warm solves timed on the
    host clock (each ends in the fetch of its result), the graph's replay
    alone timed with CUDA events (`chip_smoke.graph_ms`), and the host's
    CUDA calls of one more warm solve under the profiler.  `reps` 0 takes
    the host's CUDA calls alone (no timing: `chip_smoke.fused_host_calls`
    reads nothing else)."""
    if name in cs.BATCH_PATHS:
        return profile_fused_batch(name, reps)
    path, over = cs.FUSED_PATHS[name]
    st = cs.setup(cs.paths()[path], **over)
    cs.reset_counts()
    t0 = time.perf_counter()
    res = st.solver.solve_fused(st.lp)
    first_s = time.perf_counter() - t0
    captured = cs.read_captured()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        st.solver.solve_fused(st.lp)
        times.append(time.perf_counter() - t0)
    calls = cs.host_launches(lambda: st.solver.solve_fused(st.lp))
    it = res.iterations
    out = dict(path=name, fused=True, graph=res.info["graph"],
               status=res.status.name, iterations=it,
               turns=res.info["turns"], objective=res.objective,
               first_solve_s=first_s, captured_launches=captured,
               host_calls_per_solve=calls)
    if times:
        solve_s = sorted(times)[len(times) // 2]
        dev_ms = cs.graph_ms(st.solver)
        out.update(solve_s=solve_s, solve_s_all=times,
                   iter_per_s=it / solve_s, graph_ms=dev_ms,
                   device_ms_per_iteration=dev_ms / max(it, 1),
                   busy_share=dev_ms / 1e3 / solve_s)
    print(json.dumps(out), flush=True)


def profile_fused_batch(name, reps):
    """`profile_fused` for a batch of `chip_smoke.BATCH_PATHS`: B LPs of
    the bench's stream through `solve_fused_batch_async`, each call timed
    to the fetch of its per-LP results, iterations summed over the LPs,
    the replay per loop trip (the trips of the LP that ends last)."""
    path, B = cs.BATCH_PATHS[name]
    st = cs.setup(cs.paths()[path])
    lps = cs.stream_lps(st.lp, B)

    def run():
        return cs.batch_rows(st.solver.solve_fused_batch_async(lps)[1])

    cs.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = run()
    first_s = time.perf_counter() - t0
    captured = cs.read_captured()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    solve_s = sorted(times)[len(times) // 2]
    dev_ms = cs.cuda_ms(cs.batch_graph(st.solver, B).graph.replay, 3)
    calls = cs.host_launches(run)
    its = sum(int(r[1]) for r in rows)
    trips = max(int(r[3]) for r in rows)
    print(json.dumps(dict(
        path=name, fused=True, batch=B, graph=True,
        status=[int(r[0]) for r in rows],
        iterations=[int(r[1]) for r in rows], loop_trips=trips,
        objective=[r[2] for r in rows], first_solve_s=first_s,
        solve_s=solve_s, solve_s_all=times, solves_per_s=B / solve_s,
        iter_per_s=its / solve_s, captured_launches=captured,
        host_calls_per_solve=calls, graph_ms=dev_ms,
        graph_ms_per_trip=dev_ms / trips, busy_share=dev_ms / 1e3 / solve_s,
        peak_memory_gb=peak / 1e9)), flush=True)


def _other_lib(root, source, stem):
    """The shared library of another checkout's `csrc/<source>`, built
    alone with this tree's nvcc flags into this tree's build directory."""
    src = (Path(root) / "pips_ipmpp_tpu_torch" / "csrc" / source).resolve()
    text = src.read_bytes()
    header = src.with_name("ffma_tile.cuh")  # the tiles it may include
    tag = hashlib.sha256(text + (header.read_bytes() if header.exists()
                                 else b"")).hexdigest()[:16]
    out = _build.BUILD_DIR / f"lib{stem}_other_{tag}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o",
                        str(out), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out)), text


def other_ldl(root):
    """`ldl_inverse_f32` of another checkout's source."""
    fn = _other_lib(root, "ldl_inverse.cu", "ldl")[0].ldl_inverse_f32
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ci, ci, vp]
    fn.restype = ci
    return fn


def ldl_table(against):
    """The LDL kernel's device time per call at every LDL_SHAPES entry,
    with its parts, and, given another checkout, that one's in turns."""
    lib = _build.load()
    other = other_ldl(against) if against else None
    gen = torch.Generator(device=cs.DEVICE).manual_seed(0)
    for B, a, n_pos in cs.LDL_SHAPES:
        A = cs.ldl_input(B, a, n_pos, gen)
        A32 = A.float().contiguous()
        ref_inv = ldl.inverse_from_factors(*ldl.ldl_inverse_factors_ref(A))
        del A

        def err(X, d):
            return cs.rel_err(ldl.inverse_from_factors(X.double(), d.double()),
                              ref_inv)[0]

        X, W = torch.empty_like(A32), torch.empty_like(A32)
        d = torch.empty(B, a, device=cs.DEVICE)
        stream = torch.cuda.current_stream().cuda_stream
        this = lambda: ldl.ldl_inverse_factors(A32)           # noqa: E731
        reps = 5 if a >= 1024 else 20
        row = dict(shape=[B, a, a], n_pos=n_pos, nb=lib.ldl_inverse_nb(a),
                   launches_per_call=lib.ldl_inverse_launches(a),
                   this_rel_err=err(*this()),
                   plain_f32_rel_err=err(*ldl.ldl_inverse_factors_ref(A32)))
        if other is not None:
            rc = other(A32.data_ptr(), X.data_ptr(), d.data_ptr(),
                       W.data_ptr(), B, a, stream)
            torch.cuda.synchronize()
            if rc:
                row["other_error"] = rc
                row["this_ms"] = [cs.device_ms(this, reps)]
            else:
                row["other_rel_err"] = err(X, d)
                run_other = lambda: other(                    # noqa: E731
                    A32.data_ptr(), X.data_ptr(), d.data_ptr(),
                    W.data_ptr(), B, a, stream)
                t = [cs.device_ms(f, reps)
                     for f in (run_other, this, this, run_other)]
                row.update(other_ms=[t[0], t[3]], this_ms=[t[1], t[2]])
        else:
            row["this_ms"] = [cs.device_ms(this, reps)]
        row["parts"] = kernel_parts(this, reps)
        print("ldl_time", json.dumps(row), flush=True)
        del A32, X, W, d, ref_inv
        torch.cuda.empty_cache()


def other_ell(root):
    """(`ell_spmm_f32`, `ell_spmm_f64`, sliced) of another checkout's ELL
    kernel; `sliced` says whether it reads the sliced layout or the padded
    K-major one."""
    lib, text = _other_lib(root, "ell_spmm.cu", "ell")
    sliced = b"slice_ptr" in text
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = []
    for name in ("ell_spmm_f32", "ell_spmm_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([vp] * 10 + [ci] * 5 + [vp] if sliced
                       else [vp] * 4 + [ci] * 5 + [vp])
        fn.restype = ci
        fns.append(fn)
    return fns[0], fns[1], sliced


def _kmajor(t):
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def ell_table(against):
    """The ELL kernel's device time per call on every product of the
    sparse backend at the 8 x 8192 instance, and, given another checkout,
    that one's in turns."""
    other = other_ell(against) if against else None
    lp = make_scaler(ScalerType.EQUILIBRIUM).scale(
        cs.sparse_lp().to(cs.DEVICE))
    gen = torch.Generator(device=cs.DEVICE).manual_seed(1)
    reps = 50
    for dtype in (torch.float32, torch.float64):
        be = SparseArrowBackend(lp.astype(torch.float64), factor_dtype=dtype)
        padded, csrs = {}, {}
        for label, op, c, epi in cs.ell_cases(be, lp, gen):
            X = torch.randn(op.N, op.n, c, generator=gen, dtype=op.val.dtype,
                            device=cs.DEVICE)
            Yp = spmv.ell_spmm_ref(op.ell.val, op.ell.col, X, **epi)

            def err(Y):
                return float((Y - Yp).abs().amax() / Yp.abs().amax())

            this = partial(spmv.ell_spmm, op, X, **epi)
            row = dict(case=label, op=op.name,
                       dtype=str(op.val.dtype).split(".")[-1], c=c,
                       epilogue=sorted(epi), padded_shape=list(
                           op.ell.val.shape), slots=op.slots, nnz=op.nnz,
                       bound_ms=cs.ell_bound(op, X, Yp, epi)[0],
                       this_rel_err=err(this()), library_ms=None)
            if not epi:
                # the library yardstick: one block-diagonal CSR product
                if op.name not in csrs:
                    csrs[op.name] = cs.block_csr(op.ell.val, op.ell.col,
                                                 op.n)
                row["library_ms"] = cs.device_ms(partial(
                    torch.sparse.mm, csrs[op.name], X.reshape(-1, c)), reps)
            if other is None:
                row["this_ms"] = [cs.device_ms(this, reps)]
                print("ell_time", json.dumps(row), flush=True)
                continue
            fn = other[0] if op.val.dtype == torch.float32 else other[1]
            stream = torch.cuda.current_stream().cuda_stream
            Y = torch.empty_like(Yp)
            if other[2]:
                ptr = spmv._ptr
                args = (op.val.data_ptr(), op.col.data_ptr(),
                        op.slice_ptr.data_ptr(), op.slice_k.data_ptr(),
                        op.row.data_ptr(), X.data_ptr(), Y.data_ptr(),
                        ptr(epi.get("alpha")), ptr(epi.get("beta")),
                        ptr(epi.get("Z")), op.N, op.S, op.m, op.n, c,
                        stream)

                def run_other():
                    cs.require(fn(*args) == 0, "other ELL kernel failed")
                    return Y
            else:
                if op.name not in padded:
                    padded[op.name] = (_kmajor(op.ell.val),
                                       _kmajor(op.ell.col))
                val, col = padded[op.name]
                args = (val.data_ptr(), col.data_ptr(), X.data_ptr(),
                        Y.data_ptr(), op.N, op.m, op.ell.K, op.n, c, stream)

                def run_other():
                    cs.require(fn(*args) == 0, "other ELL kernel failed")
                    return spmv._epilogue(Y, epi.get("alpha"),
                                          epi.get("beta"), epi.get("Z"))
            row["other_rel_err"] = err(run_other())
            t = [cs.device_ms(f, reps)
                 for f in (run_other, this, this, run_other)]
            row.update(other_ms=[t[0], t[3]], this_ms=[t[1], t[2]])
            print("ell_time", json.dumps(row), flush=True)
        del be, padded, csrs
        torch.cuda.empty_cache()


def other_sweep(root):
    """`run(A) -> (A^{-1}, d)` of another checkout's sweep kernel on an
    input already padded to a multiple of 16, raising its CUDA error.  A
    library without `sweep_inverse_workspace` is the one-CTA kernel of
    earlier commits: it takes no scratch."""
    lib, _ = _other_lib(root, "sweep_inverse.cu", "sweep")
    fn = lib.sweep_inverse_f32
    vp, ci = ctypes.c_void_p, ctypes.c_int
    scratch = hasattr(lib, "sweep_inverse_workspace")
    fn.argtypes = [vp] * (4 if scratch else 3) + [ci, ci, vp]
    fn.restype = ci
    if scratch:
        lib.sweep_inverse_workspace.argtypes = [ci]
        lib.sweep_inverse_workspace.restype = ci

    def run(A):
        B, a, _ = A.shape
        X = torch.empty_like(A)
        d = torch.empty(B, a, device=A.device)
        ptrs = [A.data_ptr(), X.data_ptr(), d.data_ptr()]
        if scratch:
            work = torch.empty(B, lib.sweep_inverse_workspace(a),
                               device=A.device)
            ptrs.append(work.data_ptr())
        rc = fn(*ptrs, B, a, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return X, d
    return run


def kernel_parts(fn, reps):
    """{CUDA kernel name: device ms and launches per call} of `fn()`."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("::")[-1].split("(")[0]: dict(
        ms=e.self_device_time_total / 1e3 / reps, launches=e.count / reps)
        for e in prof.key_averages() if e.self_device_time_total > 0}


def sweep_table(against):
    """The sweep kernel's device time per call at every SWEEP_SHAPES
    entry, with its parts, and, given another checkout, that one's in
    turns."""
    lib = _build.load()
    other = other_sweep(against) if against else None
    gen = torch.Generator(device=cs.DEVICE).manual_seed(2)
    for B, a, n_pos in cs.SWEEP_SHAPES:
        A = cs.ldl_input(B, a, n_pos, gen)
        A32 = A.float().contiguous()
        ref_inv = torch.linalg.inv(A)
        del A

        def err(out):
            return cs.rel_err(out[0], ref_inv)[0]

        this = partial(sweep.sweep_inverse, A32)
        reps = 5 if a >= 1024 else 20
        row = dict(shape=[B, a, a], n_pos=n_pos,
                   launches_per_call=lib.sweep_inverse_launches(
                       sweep.padded_edge(a)),
                   bound_ms=cs.sweep_bound(B, a)[0],
                   this_rel_err=err(this()),
                   plain_f32_rel_err=err(sweep.sweep_inverse_ref(A32)))
        run_other = None
        if other is not None:
            run_other = partial(sweep._padded, A32, other, sweep.PANEL)
            try:
                row["other_rel_err"] = err(run_other())
            except RuntimeError as exc:
                row["other_error"] = str(exc)
                run_other = None
        if run_other is not None:
            t = [cs.device_ms(f, reps)
                 for f in (run_other, this, this, run_other)]
            row.update(other_ms=[t[0], t[3]], this_ms=[t[1], t[2]])
        else:
            row["this_ms"] = [cs.device_ms(this, reps)]
        row["parts"] = kernel_parts(this, reps)
        print("sweep_time", json.dumps(row), flush=True)
        del A32, ref_inv
        torch.cuda.empty_cache()


# the energy LP's root blocks (S11, the dual Schur complement)
POTF2_ENERGY_SHAPES = [(1, 550), (1, 385)]


def graph_loop_ms(fn, n):
    """Milliseconds per call of `n` back-to-back calls of `fn()` captured
    into one CUDA graph, one replay between CUDA events (median of 3,
    after a warm-up replay); the error's text where the capture fails."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
    except RuntimeError as exc:
        torch.cuda.synchronize()
        return f"not captured: {exc}"[:200]
    torch.cuda.synchronize()
    return cs.cuda_ms(graph.replay, 3) / n


def potf2_table(against):
    """The potf2 kernel's milliseconds per call at every POTF2_SHAPES
    entry and the energy shapes, with its parts, beside cholesky_ex and,
    given another checkout, that one's kernel in turns."""
    lib = _build.load()
    nb = lib.potf2_nb()
    other = None
    if against:
        other = _other_lib(against, "potf2.cu", "potf2")[0].potf2_f64
        vp, ci = ctypes.c_void_p, ctypes.c_int
        other.argtypes = [vp, vp, vp, vp, ci, ci, vp]
        other.restype = ci
    gen = torch.Generator(device=cs.DEVICE).manual_seed(3)
    # the diagonal-block kernel of a call at edge nb + 1: one warp factors
    # a whole kNb-wide block, the time per panel of the serial chain
    A = cs.ldl_input(1, nb + 1, nb + 1, gen)
    diag = kernel_parts(lambda: potf2.potf2(A), 50)["potf2_diag_kernel"]
    diag_ms = diag["ms"]
    print("potf2_diag_block", json.dumps(dict(nb=nb, **diag)), flush=True)
    for B, n in cs.POTF2_SHAPES + POTF2_ENERGY_SHAPES:
        A = cs.ldl_input(B, n, n, gen)
        stream = torch.cuda.current_stream().cuda_stream

        def raw(fn, W):
            """One call of a kernel's C function into its own outputs."""
            L = torch.empty_like(A)
            info = torch.empty(B, dtype=torch.int32, device=A.device)

            def run():
                rc = fn(A.data_ptr(), L.data_ptr(), W.data_ptr(),
                        info.data_ptr(), B, n,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"potf2 at {[B, n, n]}: CUDA "
                                       f"error {rc}")
            return run, L, info

        this, L, info = raw(lib.potf2_f64, torch.empty(
            B, 2 * n, dtype=A.dtype, device=A.device))
        this()
        Lw, iw = potf2.potf2(A)
        torch.cuda.synchronize()
        reps = 20 if n >= 300 else 200
        library = lambda: torch.linalg.cholesky_ex(A)          # noqa: E731
        bound_ms, bound_by = cs.bound(2 * B * n * n * 8 + B * 4,
                                      B * n ** 3 / 3, torch.float64)
        row = dict(shape=[B, n, n], nb=nb,
                   launches_per_call=lib.potf2_launches(n),
                   wrapper_equal=bool(torch.equal(Lw, L)
                                      and torch.equal(iw, info)),
                   info_ok=bool((info == 0).all()), bound_ms=bound_ms,
                   bound_by=bound_by,
                   library_loop_ms=cs.loop_ms(library, reps),
                   library_graph_ms=graph_loop_ms(library, reps))
        cs.require(row["wrapper_equal"], f"potf2 wrapper differs: {row}")
        timed = [("this", this)]
        if other is not None:
            run_other, Lo, io = raw(other, torch.empty(
                B, 3 * n, dtype=A.dtype, device=A.device))
            run_other()
            torch.cuda.synchronize()
            row["equal_to_other"] = bool(torch.equal(Lo, L)
                                         and torch.equal(io, info))
            cs.require(row["equal_to_other"],
                       f"potf2 differs from {against}'s at {[B, n, n]}")
            timed = [("other", run_other), ("this", this), ("this", this),
                     ("other", run_other)]
        for key, timer in (("loop_ms", cs.loop_ms),
                           ("graph_ms", graph_loop_ms)):
            for who, fn in timed:
                row.setdefault(f"{who}_{key}", []).append(timer(fn, reps))
            for who in dict(timed):
                t = row[f"{who}_{key}"]
                if all(isinstance(x, float) for x in t):
                    row[f"{who}_{key}_mean"] = sum(t) / len(t)
        parts = kernel_parts(this, 5 if n >= 300 else 20)
        row.update(parts=parts, diag_block_ms=diag_ms,
                   chain_floor_ms=-(-n // nb) * diag_ms,
                   device_ms=sum(p["ms"] for p in parts.values()))
        print("potf2_time", json.dumps(row), flush=True)
        del A, L, info
        torch.cuda.empty_cache()


def main(argv):
    table = cs.paths()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", metavar="path",
                    help=f"one of {', '.join(table)} (default: all)")
    ap.add_argument("--window", type=int, default=4,
                    help="profiled iterations (0: one timed solve only)")
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("--ldl", action="store_true",
                    help="time the LDL kernel at chip_smoke.LDL_SHAPES")
    ap.add_argument("--ldl-against", metavar="DIR", default=None,
                    help="with --ldl: also time DIR's LDL kernel, in turns")
    ap.add_argument("--ell", action="store_true",
                    help="time the ELL kernel on the sparse backend's "
                         "products at the 8 x 8192 instance")
    ap.add_argument("--ell-against", metavar="DIR", default=None,
                    help="with --ell: also time DIR's ELL kernel, in turns")
    ap.add_argument("--sweep", action="store_true",
                    help="time the sweep kernel at chip_smoke.SWEEP_SHAPES")
    ap.add_argument("--sweep-against", metavar="DIR", default=None,
                    help="with --sweep: also time DIR's sweep kernel, in "
                         "turns")
    ap.add_argument("--potf2", action="store_true",
                    help="time the potf2 kernel at chip_smoke.POTF2_SHAPES "
                         "and the energy shapes")
    ap.add_argument("--potf2-against", metavar="DIR", default=None,
                    help="with --potf2: also time DIR's potf2 kernel, in "
                         "turns")
    ap.add_argument("--fused", nargs="*", metavar="path", default=None,
                    help=f"time the fused loop (solve_fused) on "
                         f"{', '.join(cs.FUSED_PATHS)} (default: all), or "
                         f"a batch: {', '.join(cs.BATCH_PATHS)}")
    ap.add_argument("--reps", type=int, default=3,
                    help="with --fused: warm solves timed")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.paths) - set(table))
    if unknown:
        ap.error(f"unknown paths {unknown}")
    cs.require(torch.cuda.is_available(), "no CUDA device")
    pin_float32_precision()
    if args.ldl:
        ldl_table(args.ldl_against)
    if args.ell:
        ell_table(args.ell_against)
    if args.sweep:
        sweep_table(args.sweep_against)
    if args.potf2:
        potf2_table(args.potf2_against)
    if args.fused is not None:
        bad = sorted(set(args.fused) - set(cs.FUSED_PATHS)
                     - set(cs.BATCH_PATHS))
        if bad:
            ap.error(f"unknown fused paths {bad}")
        for name in args.fused or list(cs.FUSED_PATHS):
            profile_fused(name, args.reps)
    kernels = (args.ldl or args.ell or args.sweep or args.potf2
               or args.fused is not None)
    for name in args.paths or ([] if kernels else list(table)):
        profile(name, table[name], args.window, args.cg_iters)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
