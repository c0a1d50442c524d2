"""Command-line driver mirroring the reference's gmspips CLI
(Drivers/gams/gmspips/gmspips.cpp:12-58; README.md:84-95):

    python -m pips_ipmpp_tpu_torch.cli <N+1> <stem> [scaleGeo|scale|
        scaleEqui|scaleCurtisReid] [stepLp] [presolve] [printsol]
        [hierarchical] [bandedLeaf] [bandedRoot] [FILE.opt]
    python -m pips_ipmpp_tpu_torch.cli --mps FILE [--auto-blocks K] [flags]
    python -m pips_ipmpp_tpu_torch.cli --check <stem> [N+1]

reads `<stem>_block*.npz` files (the GDX replacement), solves, and
optionally writes `<stem>_solution.npz`.  `--mps FILE` reads an MPS file
(reference MpsReader) into a dense host LP; `--auto-blocks K` discovers
an arrowhead structure with K blocks in it (core/dissect.py), and
`printsol` then writes the solution in the file's own order.  `--check`
validates block files (the reference's gmspipschk).

Counterpart of `pips_ipmpp_tpu/cli.py`, with the same arguments, output
lines and return codes.  The solve runs on the CUDA card: `main(argv,
device="cpu")` runs it on the CPU instead.  `hierarchical` solves on the
hierarchical layout (`HierArrowBackend`).  `bandedLeaf` and `bandedRoot`
are not ported yet: the facade refuses them and the CLI prints its
refusal and returns 2."""
from __future__ import annotations

import sys
import time

import numpy as np
import torch


def main(argv=None, *, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0

    from pips_ipmpp_tpu_torch.core.options import (Options, PresolverType,
                                                   ScalerType, StepMode)
    from pips_ipmpp_tpu_torch.core.status import TerminationStatus
    from pips_ipmpp_tpu_torch.interface import PIPSIPMppTorchInterface

    # gmspips defaults to the PRIMAL (single steplength) rule; `stepLp`
    # opts into primal-dual (gmspips.cpp flag of the same name)
    opts = Options(print_level=10, step_mode=StepMode.PRIMAL)
    if argv[0] == "--check":
        # block-file consistency check (the reference's gmspipschk)
        return check_blocks(argv[1], int(argv[2]) if len(argv) > 2 else None)
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CLI solves on the card "
                           "(main(argv, device='cpu') runs on the CPU)")
    dmap = None
    if argv[0] == "--mps":
        from pips_ipmpp_tpu_torch.io.mps import read_mps
        # the dense LP stays on the host: the dissection reads it there
        lp = read_mps(argv[1])
        flags = argv[2:]
        stem = argv[1].rsplit(".", 1)[0]
        # --auto-blocks K: discover arrowhead structure in the flat LP
        # (core/dissect.py) so un-annotated MPS models run on the batched
        # structured path — a capability gmspips does not have (it needs
        # GAMS block annotations)
        if "--auto-blocks" in flags:
            i = flags.index("--auto-blocks")
            if i + 1 >= len(flags) or not flags[i + 1].isdigit():
                print("error: --auto-blocks requires an integer block "
                      "count (e.g. --auto-blocks 16)", file=sys.stderr)
                return 2
            k = int(flags[i + 1])
            flags = flags[:i] + flags[i + 2:]
            from pips_ipmpp_tpu_torch.core.dissect import (dissect,
                                                           structure_report)
            from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp
            # auto_structure's two steps, the dense host LP dropped between
            # them: it is not held beside the arrowhead's padded blocks
            *parts, dmap = dissect(lp, num_blocks=k)
            del lp
            lp = make_arrowhead_lp(*parts, dtype=torch.float64, device=device)
            del parts
            print("auto-structure:", structure_report(dmap, lp))
    else:
        from pips_ipmpp_tpu_torch.io.blockfile import read_blocks
        n_blocks = int(argv[0])
        stem = argv[1]
        flags = argv[2:]
        try:
            lp = read_blocks(stem, n_blocks, device=device)
        except FileNotFoundError as e:
            print(f"error: block file not found: {e.filename or e}",
                  file=sys.stderr)
            return 2

    printsol = False
    for flag in flags:
        f = flag.lower()
        if f == "scalegeo":
            opts = opts.replace(scaler=ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM)
        elif f == "scale":
            opts = opts.replace(scaler=ScalerType.GEOMETRIC_MEAN)
        elif f == "scaleequi":
            opts = opts.replace(scaler=ScalerType.EQUILIBRIUM)
        elif f == "scalecurtisreid":
            opts = opts.replace(scaler=ScalerType.CURTIS_REID)
        elif f == "steplp":
            opts = opts.replace(step_mode=StepMode.PRIMAL_DUAL)
        elif f == "presolve":
            opts = opts.replace(presolve=PresolverType.PRESOLVE)
        elif f == "printsol":
            printsol = True
        elif f == "hierarchical":
            opts = opts.replace(hierarchical=True)
        elif f == "bandedleaf":
            opts = opts.replace(banded_leaf=True)
        elif f == "bandedroot":
            opts = opts.replace(banded_root=True)
        elif f.endswith(".opt"):
            opts = Options.from_opt_file(flag, base=opts)
        else:
            print(f"warning: unknown flag {flag!r} ignored")

    t0 = time.time()
    try:
        iface = PIPSIPMppTorchInterface(lp, opts, device=device)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    status = iface.run()
    dt = time.time() - t0

    if status == TerminationStatus.SUCCESSFUL_TERMINATION:
        print(f"optimal objective: {iface.getObjective():.10g}")
        print(f"solve time: {dt:.2f}s, iterations: {iface.n_iterations}")
    else:
        print(f"termination: {status.name} after "
              f"{iface.n_iterations if iface.result else 0} iterations "
              f"({dt:.2f}s)")

    if printsol and status == TerminationStatus.SUCCESSFUL_TERMINATION:
        from pips_ipmpp_tpu_torch.io.blockfile import write_solution
        x = iface.gatherPrimalSolution()
        y = iface.gatherDualSolutionEq()
        z = iface.gatherDualSolutionIneq()
        if dmap is not None:
            # --auto-blocks permuted + padded the LP; map the solution
            # back to the original MPS column/row order (DissectMap)
            x = dmap.recover_x(x[:lp.n0],
                               x[lp.n0:].reshape(lp.N, lp.n))
            nE = lp.m0E + lp.N * lp.mE
            y = dmap.recover_eq_rows(
                y[:lp.m0E], y[lp.m0E:nE].reshape(lp.N, lp.mE), y[nE:])
            nI = lp.m0I + lp.N * lp.mI
            z = dmap.recover_ineq_rows(
                z[:lp.m0I], z[lp.m0I:nI].reshape(lp.N, lp.mI), z[nI:])
        write_solution(stem, x, y, z, iface.getObjective())
        print(f"solution written to {stem}_solution.npz")

    return 0 if status == TerminationStatus.SUCCESSFUL_TERMINATION else 1


def check_blocks(stem: str, n_blocks=None) -> int:
    """Validate block files for structural consistency (the role of the
    reference's gmspipschk executable): dimension agreement across blocks,
    0/1 indicator masks, ordered bounds, finite data."""
    problems = []

    def err(msg):
        problems.append(msg)

    try:
        meta = np.load(f"{stem}_meta.npz")
    except FileNotFoundError:
        print(f"error: {stem}_meta.npz not found", file=sys.stderr)
        return 2
    N = int(meta["N"]) if n_blocks is None else n_blocks - 1
    mEl = meta["bl"].shape[0]
    mIl = meta["clowl"].shape[0]

    try:
        b0 = np.load(f"{stem}_block0.npz")
    except FileNotFoundError:
        print(f"error: {stem}_block0.npz not found", file=sys.stderr)
        return 2
    n0 = b0["c"].shape[0]
    if b0["A"].shape[1] != n0:
        err(f"block0: A has {b0['A'].shape[1]} cols, expected n0={n0}")
    if b0["F0"].shape != (mEl, n0):
        err(f"block0: F0 shape {b0['F0'].shape} != ({mEl}, {n0})")

    def check_masks(name, tag, f):
        m = np.asarray(f)
        if not np.all((m == 0) | (m == 1)):
            err(f"{tag}: indicator {name} has non-0/1 entries")

    def check_bounds(tag, f):
        il, lo = np.asarray(f["iclow"]), np.asarray(f["clow"])
        iu, up = np.asarray(f["icupp"]), np.asarray(f["cupp"])
        bad = (il > 0) & (iu > 0) & (lo > up)
        if np.any(bad):
            err(f"{tag}: clow > cupp on {int(bad.sum())} rows")
        xl, xlo = np.asarray(f["ixlow"]), np.asarray(f["xlow"])
        xu, xup = np.asarray(f["ixupp"]), np.asarray(f["xupp"])
        badx = (xl > 0) & (xu > 0) & (xlo > xup)
        if np.any(badx):
            err(f"{tag}: xlow > xupp on {int(badx.sum())} vars")

    for name in ("iclow", "icupp", "ixlow", "ixupp"):
        check_masks(name, "block0", b0[name])
    check_bounds("block0", b0)
    for key in ("c", "A", "b", "C", "F0", "G0", "clow", "cupp",
                "xlow", "xupp"):
        if key in b0 and not np.all(np.isfinite(b0[key])):
            err(f"block0: non-finite entries in {key}")

    for i in range(1, N + 1):
        try:
            bf = np.load(f"{stem}_block{i}.npz")
        except FileNotFoundError:
            err(f"block{i}: file missing")
            continue
        ni = bf["c"].shape[0]
        tag = f"block{i}"
        if bf["A"].shape[1] != n0:
            err(f"{tag}: border A cols {bf['A'].shape[1]} != n0 {n0}")
        if bf["B"].shape != (bf["A"].shape[0], ni):
            err(f"{tag}: B shape {bf['B'].shape} inconsistent")
        if bf["F"].shape != (mEl, ni):
            err(f"{tag}: F shape {bf['F'].shape} != ({mEl}, {ni})")
        if bf["G"].shape != (mIl, ni):
            err(f"{tag}: G shape {bf['G'].shape} != ({mIl}, {ni})")
        for name in ("iclow", "icupp", "ixlow", "ixupp"):
            check_masks(name, tag, bf[name])
        check_bounds(tag, bf)
        for key in ("c", "A", "B", "b", "C", "D", "F", "G",
                    "clow", "cupp", "xlow", "xupp"):
            if key in bf and not np.all(np.isfinite(bf[key])):
                err(f"{tag}: non-finite entries in {key}")

    if problems:
        for p in problems:
            print(f"CHECK FAILED: {p}")
        return 1
    print(f"OK: {stem} with {N} blocks is consistent "
          f"(n0={n0}, mEl={mEl}, mIl={mIl})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
