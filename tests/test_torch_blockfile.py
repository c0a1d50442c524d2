"""Block-file I/O and the GAMSsmall golden acceptance through the PyTorch
port: `read_blocks`/`write_blocks` against the JAX package's arrays, and
the 26 instances of `tests/data/gamssmall/` against PIPS-IPM++'s own
recorded objective and iteration count (`manifest.json`), with the
acceptance of `tests/test_golden_reference.py:47-59` (f64, ArrowBackend,
default Options, on the CPU).

Every instance goes through the fused loop (`IPMSolver.solve_fused`) and
the host loop, which must agree bit for bit on the CPU.  The JAX
package's host loop, whose first call per shape compiles for seconds, is
held to the same iteration count on `JAX_SUBSET`: the three instances it
solves quickest.  `PYTHONPATH=. python tests/test_torch_blockfile.py`
prints the full table: all 26 instances through both loops of the port
and the JAX package's host loop."""
import json
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

from pips_ipmpp_tpu_torch.core.options import Options
from pips_ipmpp_tpu_torch.core.status import TerminationStatus
from pips_ipmpp_tpu_torch.io.blockfile import (read_blocks, write_blocks,
                                               write_solution)
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
from torch_parity import jax_fields, np_tree

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "data", "gamssmall")
with open(os.path.join(DATA, "manifest.json")) as f:
    MANIFEST = json.load(f)
BY_NAME = {m["name"]: m for m in MANIFEST}

OBJ_TOL = 1e-4          # reference: t_pips.cpp:27
# the JAX comparison: the three quickest JAX solves of the table (4.0,
# 6.4 and 6.5 s of CPU each, 6.6-10.6 s for the others)
JAX_SUBSET = ("exampleAC_singletonRow2",
              "singletonEqualityColumn_multiple_resulting_noLink",
              "parallelInequalityRows_B0A2")


def iter_budget(entry) -> int:
    """The reference's budget, ceil(recorded * 1.1) (t_pips.cpp:118)."""
    return math.ceil(entry["iterations"] * 1.1)


def load(name):
    return read_blocks(os.path.join(DATA, name),
                       n_blocks=BY_NAME[name]["n_files"])


def accept(name, status, objective, iterations):
    entry = BY_NAME[name]
    assert status == TerminationStatus.SUCCESSFUL_TERMINATION, \
        f"{name}: {status}"
    assert abs(objective - entry["objective"]) < OBJ_TOL, \
        f"{name}: objective {objective} vs recorded {entry['objective']}"
    assert iterations <= iter_budget(entry), \
        f"{name}: {iterations} iterations vs recorded " \
        f"{entry['iterations']} (budget {iter_budget(entry)})"


def solver():
    return IPMSolver(ArrowBackend, Options(), device="cpu")


_RUNS: dict = {}


def run(name, loop):
    """One solve of an instance by one loop ("solve" or "solve_fused"),
    shared by the tests that read it (the CPU runs are deterministic)."""
    if (name, loop) not in _RUNS:
        _RUNS[name, loop] = getattr(solver(), loop)(load(name))
    return _RUNS[name, loop]


@pytest.mark.parametrize("name", ["exampleAC_boundStrength",
                                  "hier_approach_8blocks_2by3"])
def test_read_blocks_matches_jax(name):
    from pips_ipmpp_tpu.io.blockfile import read_blocks as jax_read

    entry = BY_NAME[name]
    want = jax_fields(jax_read(os.path.join(DATA, name),
                               n_blocks=entry["n_files"]))
    got = np_tree(load(name))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["exampleAC_boundStrength",
                                  "hier_approach_8blocks_2by3"])
def test_write_blocks_round_trip(tmp_path, name):
    """The port writes what both packages read back unchanged."""
    from pips_ipmpp_tpu.io.blockfile import read_blocks as jax_read

    lp = load(name)
    stem = str(tmp_path / name)
    write_blocks(lp, stem)
    want = np_tree(lp)
    for got in (np_tree(read_blocks(stem)), jax_fields(jax_read(stem))):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    write_solution(stem, np.arange(3.0), objective=1.5)
    sol = np.load(f"{stem}_solution.npz")
    assert sol["objective"] == 1.5 and list(sol["x"]) == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("name", list(BY_NAME))
def test_golden_fused(name):
    r = run(name, "solve_fused")
    assert r.info["graph"] is False
    accept(name, r.status, r.objective, r.iterations)


@pytest.mark.parametrize("name", list(BY_NAME))
def test_golden_host_loop(name):
    host = run(name, "solve")
    accept(name, host.status, host.objective, host.iterations)
    fused = run(name, "solve_fused")
    assert fused.status == host.status
    assert fused.iterations == host.iterations
    assert fused.objective == host.objective


@pytest.mark.parametrize("name", JAX_SUBSET)
def test_golden_matches_jax(name):
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.io.blockfile import read_blocks as jax_read
    from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import \
        ArrowBackend as JArrowBackend

    host = run(name, "solve")
    jres = JIPMSolver(JArrowBackend, JOptions()).solve(
        jax_read(os.path.join(DATA, name), n_blocks=BY_NAME[name]["n_files"]))
    assert host.status.name == jres.status.name
    assert host.iterations == jres.iterations
    assert abs(host.objective - float(jres.objective)) < OBJ_TOL


def table():
    """All 26 instances: the port's host loop and fused loop and the JAX
    package's host loop; one JSON line each, then a summary line."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.io.blockfile import read_blocks as jax_read
    from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import \
        ArrowBackend as JArrowBackend

    bad = 0
    for entry in MANIFEST:
        name = entry["name"]
        row = dict(name=name, recorded=entry["iterations"],
                   budget=iter_budget(entry))
        for loop in ("host", "fused", "jax"):
            t0 = time.perf_counter()
            if loop == "jax":
                r = JIPMSolver(JArrowBackend, JOptions()).solve(jax_read(
                    os.path.join(DATA, name), n_blocks=entry["n_files"]))
            else:
                r = getattr(solver(), "solve" if loop == "host"
                            else "solve_fused")(load(name))
            row[loop] = dict(status=r.status.name, iterations=r.iterations,
                             objective=float(r.objective),
                             seconds=time.perf_counter() - t0)
        ok = all(row[lp]["status"] == "SUCCESSFUL_TERMINATION"
                 and abs(row[lp]["objective"] - entry["objective"]) < OBJ_TOL
                 and row[lp]["iterations"] <= row["budget"]
                 for lp in ("host", "fused")) and (
            row["host"]["iterations"] == row["fused"]["iterations"]
            == row["jax"]["iterations"])
        row["pass"] = ok
        bad += not ok
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(instances=len(MANIFEST), failed=bad)))
    return bad


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(1 if table() else 0)
