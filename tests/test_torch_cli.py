"""The port's gmspips CLI (`pips_ipmpp_tpu_torch/cli.py`) against the JAX
package's: the same argv through both, the port with `device="cpu"`.
Two JAX solves: the block-file run of tests/test_io.py and the MPS run
with automatic structure discovery on a small energy LP."""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from pips_ipmpp_tpu.cli import main as jmain
from pips_ipmpp_tpu.io.blockfile import write_blocks
from pips_ipmpp_tpu_torch import cli
from pips_ipmpp_tpu_torch.io.energy import (dispatch_blocks, highs_oracle,
                                            to_scipy, write_mps)
from tests.fixtures import two_scenario_linking_lp
from torch_parity import normwise_close

SMALL_ENERGY = dict(T=4, R=3, G=5, L=3, S=1, seed=0)


def tmain(argv):
    return cli.main(argv, device="cpu")


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err


def _line(lines, key):
    return next(ln for ln in lines if ln.startswith(key))


def _solved(lines):
    """(objective, iterations) from the CLI's output lines."""
    obj = float(_line(lines, "optimal objective:").split(":")[1])
    return obj, int(_line(lines, "solve time:").rsplit(":", 1)[1])


@pytest.fixture
def block_stem(tmp_path):
    lp, _ = two_scenario_linking_lp()
    stem = str(tmp_path / "prob")
    write_blocks(lp, stem)
    return stem


def test_cli_block_files_match_jax(block_stem, capsys):
    """tests/test_io.py::test_cli_end_to_end's run through both CLIs."""
    argv = ["3", block_stem, "scaleGeo", "stepLp", "presolve", "printsol"]
    sols = []
    for main in (jmain, tmain):
        rc, lines, _ = _run(main, argv, capsys)
        assert rc == 0
        sols.append((_solved(lines),
                     dict(np.load(f"{block_stem}_solution.npz"))))
    (want, wsol), (got, gsol) = sols
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-9)
    assert set(gsol) == set(wsol) == {"x", "y", "z", "objective"}
    for k in wsol:
        normwise_close(gsol[k], wsol[k], 1e-8)


def test_cli_mps_auto_blocks_matches_jax(tmp_path, capsys):
    """--mps --auto-blocks printsol (tests/test_realworld.py:44) on a small
    energy LP: the JAX CLI's structure, iterations and objective, HiGHS's
    objective, and the solution in the MPS order feasible."""
    blocks, first, leq, liq, _ = dispatch_blocks(**SMALL_ENERGY)
    oracle, _ = highs_oracle(blocks, first, leq, liq)
    path = str(tmp_path / "energy4.mps")
    write_mps(path, blocks, first, leq, liq)
    argv = ["--mps", path, "--auto-blocks", "4", "printsol"]
    outs = []
    for main in (jmain, tmain):
        rc, lines, _ = _run(main, argv, capsys)
        assert rc == 0
        outs.append((_line(lines, "auto-structure:"), _solved(lines)))
    (wrep, want), (grep, got) = outs
    assert grep == wrep
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-9)
    assert got[0] == pytest.approx(oracle, rel=1e-6)

    x = np.load(str(tmp_path / "energy4_solution.npz"))["x"]
    c, A_eq, b_eq, A_ub, lb_ub, ub_ub, lo, hi = to_scipy(blocks, first, leq,
                                                         liq)
    assert x.shape == c.shape
    assert float(c @ x) == pytest.approx(oracle, rel=1e-6)
    assert np.max(np.abs(A_eq @ x - b_eq)) < 1e-5
    act = A_ub @ x
    assert np.all(act <= ub_ub + 1e-5) and np.all(act >= lb_ub - 1e-5)
    assert np.all(x >= lo - 1e-6) and np.all(x <= hi + 1e-6)


def test_cli_check_matches_jax(block_stem, capsys):
    """--check on good block files, then on a block with crossed bounds
    (tests/test_io.py::test_cli_check_blocks): the same lines and return
    codes from both CLIs."""
    for corrupt in (False, True):
        if corrupt:
            f = dict(np.load(f"{block_stem}_block1.npz"))
            f["xlow"] = f["xupp"] + 1.0
            np.savez(f"{block_stem}_block1.npz", **f)
        want = _run(jmain, ["--check", block_stem], capsys)
        got = _run(tmain, ["--check", block_stem], capsys)
        assert got == want
        assert got[0] == (1 if corrupt else 0)


@pytest.mark.parametrize("case", ["missing_block_file", "auto_blocks_no_k",
                                  "hierarchical", "bandedLeaf",
                                  "bandedRoot"])
def test_cli_refusals_return_2(block_stem, tmp_path, capsys, case):
    """Exits with code 2: a block file missing and `--auto-blocks` without
    a count (as the JAX CLI).  The modes once refused are ported:
    `hierarchical`, `bandedLeaf` and `bandedRoot` solve, with the JAX
    CLI's lines (its log, iterations and objective; the time apart) and
    code 0."""
    if case in ("hierarchical", "bandedLeaf", "bandedRoot"):
        argv = ["3", block_stem, case]
        (wrc, want, _), (grc, got, gerr) = (_run(main, argv, capsys)
                                            for main in (jmain, tmain))
        assert grc == wrc == 0 and not gerr
        assert _solved(got)[1] == _solved(want)[1]
        assert _solved(got)[0] == pytest.approx(_solved(want)[0], rel=1e-9)

        def log(lines):
            """The iteration log as numbers: k, objective, mu, residual."""
            return np.array([[float(v) for v in ln.split()[1::2]]
                             for ln in lines if ln.startswith("iter")])
        glog, wlog = log(got), log(want)
        assert glog.shape == wlog.shape and glog.shape[0] > 1
        np.testing.assert_allclose(glog[:, :3], wlog[:, :3], rtol=1e-8)
        # the residual norms reach rounding level (~1e-12)
        np.testing.assert_allclose(glog[:, 3], wlog[:, 3], rtol=1e-8,
                                   atol=1e-10)
        assert [ln for ln in got if not ln.startswith(
            ("iter", "solve time:", "optimal objective:"))] == [
            ln for ln in want if not ln.startswith(
                ("iter", "solve time:", "optimal objective:"))]
        return
    if case == "missing_block_file":
        argv = ["4", block_stem]
    elif case == "auto_blocks_no_k":
        path = str(tmp_path / "e.mps")
        write_mps(path, *dispatch_blocks(**SMALL_ENERGY)[:4])
        argv = ["--mps", path, "--auto-blocks", "printsol"]
    rc, _, err = _run(tmain, argv, capsys)
    assert rc == 2 and err.startswith("error:")
    assert _run(jmain, argv, capsys)[::2] == (rc, err)


def test_cli_solves_on_the_card_by_default(block_stem, monkeypatch):
    """Without `device`, the CLI runs on CUDA and raises where there is
    none; `--check` needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["3", block_stem])
    assert cli.main(["--check", block_stem]) == 0


def test_wide_root_factored_in_f64(block_stem, monkeypatch):
    """With f32 factors the facade factors a root wider than
    `ROOT_F32_MAX` in f64 (the two-level Cholesky) and keeps the leaves in
    f32 (ROADMAP.md §3, R2): on the two-scenario LP of the block files
    (tests/fixtures.py, optimum 7), with the edge lowered below its root,
    the backend gets an f64 root and the solve reaches the optimum; at the
    shipped edge its root stays f32."""
    from pips_ipmpp_tpu_torch import (Options, PIPSIPMppTorchInterface,
                                      interface)
    from pips_ipmpp_tpu_torch.core.options import StepMode
    from pips_ipmpp_tpu_torch.core.status import TerminationStatus
    from pips_ipmpp_tpu_torch.io.blockfile import read_blocks

    lp = read_blocks(block_stem, 3, device="cpu")
    ns = lp.n0 + lp.m0E + lp.m0I + lp.mEl + lp.mIl
    assert ns <= interface.ROOT_F32_MAX
    assert interface.root_factor_dtype(lp, torch.float32) == torch.float32
    assert interface.root_factor_dtype(lp, torch.float64) == torch.float64
    monkeypatch.setattr(interface, "ROOT_F32_MAX", ns - 1)
    assert interface.root_factor_dtype(lp, torch.float32) == torch.float64
    opts = Options(step_mode=StepMode.PRIMAL, factor_dtype="float32")
    iface = PIPSIPMppTorchInterface(lp, opts, device="cpu")
    be = iface._solver.be_ctor(lp)
    assert be.ldl_kernel and not be.root_ldl
    assert be.root_dtype == torch.float64
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert iface.getObjective() == pytest.approx(7.0, rel=1e-6)
