"""Where the time of the port's solves goes, on one CUDA card.

    python3 profile_port.py [path ...] [--window W] [--cg-iters K]

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
and the CG's read-backs, calls and capped calls of the timed solve; for the
window, kernel launches (`*LaunchKernel*` runtime calls) and device time
per iteration, the busy share (device time over the window's host-clock
time) and the kernels that took the most device time; and the
iterations' mu, residual, step lengths and Gondzio correctors.  The last
line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial

import torch

import chip_smoke as cs
from pips_ipmpp_tpu_torch import PIPSIPMppTorchInterface
from pips_ipmpp_tpu_torch.core.options import ScalerType
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver, pin_float32_precision
from pips_ipmpp_tpu_torch.linalg.sparse_backend import batched_pcg
from pips_ipmpp_tpu_torch.scale import make_scaler


def setup(make, cg_iters):
    """(LP on the card, IPMSolver) of one path: for a facade path the LP
    scaled and the solver built as the facade does."""
    lp, opts, backend = make()
    if backend is None:
        if cg_iters is not None:
            raise ValueError("--cg-iters needs a path with its own backend")
        iface = PIPSIPMppTorchInterface(lp, opts, device=cs.DEVICE)
        lp, solver = iface.lp, iface._solver
        if opts.scaler != ScalerType.NONE:
            lp = make_scaler(opts.scaler).scale(lp)
        return lp, solver
    if cg_iters is not None:
        backend = partial(backend, cg_iters=cg_iters)
    return lp.to(cs.DEVICE), IPMSolver(backend, opts, device=cs.DEVICE)


def profile(name, make, window, cg_iters):
    lp, solver = setup(make, cg_iters)
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
    device = [e for e in events if e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    return dict(window=[k0, k1], window_s=window_s,
                launches_per_iteration=launches / n,
                device_ms_per_iteration=device_ms / n,
                busy_share=device_ms / 1e3 / window_s,
                top_device=[dict(name=e.key[:80], count=e.count,
                                 ms=e.self_device_time_total / 1e3)
                            for e in top])


def main(argv):
    table = cs.paths()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", metavar="path",
                    help=f"one of {', '.join(table)} (default: all)")
    ap.add_argument("--window", type=int, default=4,
                    help="profiled iterations (0: one timed solve only)")
    ap.add_argument("--cg-iters", type=int, default=None)
    args = ap.parse_args(argv)
    unknown = sorted(set(args.paths) - set(table))
    if unknown:
        ap.error(f"unknown paths {unknown}")
    cs.require(torch.cuda.is_available(), "no CUDA device")
    pin_float32_precision()
    for name in args.paths or list(table):
        profile(name, table[name], args.window, args.cg_iters)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
