"""The hierarchical k-layer Schur complement of the PyTorch port
(`linalg/hier_backend.py`, the facade's `hierarchical` options, the
generators of `io/synthetic.py`) against the JAX package: the counterpart
of `tests/test_hierarchical.py`.

The host side (generators, locality analysis, layout) is numpy in both
packages and held bit for bit.  `factorize` and `solve_reduced` on one
iterate: f64 to 1e-10, f32 to 1e-4 (the JAX package's LDL kernel in
Pallas interpret mode; the JAX side jitted, as its IPM runs it).  The
facade's host loop at 2 and 3 layers and under outer BiCGStab: the same
status and iterations, mu per iteration and the objective to 1e-10
relative, every gather in user row order to 1e-10.  One JAX facade solve
per case, shared by its asserts.

The reference's two hierarchical golden instances turn on rounding in
both packages (ROADMAP.md §3; `tests/torch_faults.py hiernoise NAME
{jax,port}`: under 1e-16 noise on every Cholesky input the JAX package
takes 5-10 and 6-8 iterations, the port 4-7 and 6-8), so they are held to
the bar the card holds them to: the JAX facade's own iterations (7 and 6,
jitted, no noise) plus one, and the recorded objective to 1e-4."""
import dataclasses
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu.core.options import Options as JOptions
from pips_ipmpp_tpu.core.options import ScalerType as JScalerType
from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
from pips_ipmpp_tpu.io.synthetic import random_hier_arrowhead_lp as jax_lp
from pips_ipmpp_tpu.ipm import formulation as JF
from pips_ipmpp_tpu.linalg import hier_backend as jhier
from pips_ipmpp_tpu_torch import PIPSIPMppTorchInterface, bridge
from pips_ipmpp_tpu_torch.core.options import Options, ScalerType
from pips_ipmpp_tpu_torch.core.status import TerminationStatus
from pips_ipmpp_tpu_torch.io.blockfile import read_blocks
from pips_ipmpp_tpu_torch.io.synthetic import random_hier_arrowhead_lp
from pips_ipmpp_tpu_torch.ipm import formulation as TF
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
from pips_ipmpp_tpu_torch.linalg import hier_backend as thier
from torch_parity import (jax_fields, jspace, normwise_close, np_tree,
                          random_iterate)

RTOL = 1e-10
# (seed, generator arguments, groups, coarse levels): the LP of
# tests/test_hierarchical.py:99 (2 layers) and of :146 (3 layers)
LPS = {
    "two": (7, dict(N=8, n_groups=2), 2, ()),
    "three": (11, dict(N=16, n_groups=4, loc_eq=3, loc_iq=2, glob_eq=2,
                       glob_iq=1), 8, (4,)),
}
# the facade cases: LP and options (tests/test_hierarchical.py:99-113
# without its scaler, whose JAX run took half of the case's time, and
# :146-164; OUTER_SOLVE=2 on the first LP).  Scaling under the hierarchy:
# `test_scaled_gathers_match_the_flat_layout`
FACADE = {
    "two": ("two", dict(hierarchical=True)),
    "three": ("three", dict(hierarchical=True, hierarchical_layers=3,
                            hierarchical_num_groups=8)),
    "bicgstab": ("two", dict(hierarchical=True, outer_bicgstab=True)),
}
ACCESSORS = (
    "gatherPrimalSolution", "gatherDualSolutionEq",
    "gatherDualSolutionIneq", "gatherEqualityConsValues",
    "gatherInequalityConsValues", "gatherSlacksVarsLow",
    "gatherSlacksVarsUp", "gatherSlacksInequalityLow",
    "gatherSlacksInequalityUp", "gatherDualSolutionVarBoundsLow",
    "gatherDualSolutionVarBoundsUpp", "gatherDualSolutionIneqLow",
    "gatherDualSolutionIneqUpp", "gatherPrimalResidsEQ",
    "gatherPrimalResidsIneqLow", "gatherPrimalResidsIneqUp",
    "gatherDualResids")
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "data", "gamssmall")
# the reference's hierarchical golden instances and the JAX package's own
# iteration counts with hierarchical=True (the manifest records 5 and 14)
GOLDEN = {"hier_approach_4blocks_2by2": 7, "hier_approach_8blocks_2by3": 6}


def _pair(case, dtype="float64"):
    seed, kw, _, _ = LPS[case]
    return (jax_lp(seed, dtype=getattr(jnp, dtype), **kw),
            random_hier_arrowhead_lp(seed, dtype=getattr(torch, dtype),
                                     **kw))


def _opts(O, S, kw):
    kw = dict(kw)
    if "scaler" in kw:
        kw["scaler"] = getattr(S, kw["scaler"])
    return O(**kw)


_RUNS: dict = {}


def _facades(key, make_lps, opts):
    """The JAX facade's and the port's runs of one case (memoized)."""
    if key not in _RUNS:
        jlp, tlp = make_lps()
        ji = PIPSIPMppTPUInterface(jlp, _opts(JOptions, JScalerType, opts))
        ti = PIPSIPMppTorchInterface(tlp, _opts(Options, ScalerType, opts),
                                     device="cpu")
        ji.run()
        ti.run()
        _RUNS[key] = (ji, ti)
    return _RUNS[key]


def _gather_close(got, want):
    """max |port - JAX| <= RTOL * max(1, max |JAX|): the residual gathers
    are at rounding level, so the bound is relative to the data's scale."""
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0.0, atol=RTOL * scale)


def _assert_same_solve(ji, ti, rtol=RTOL):
    assert ti.result.status.name == ji.result.status.name \
        == "SUCCESSFUL_TERMINATION"
    assert ti.n_iterations == ji.n_iterations
    np.testing.assert_allclose([h.mu for h in ti.result.history],
                               [h.mu for h in ji.result.history], rtol=rtol)
    np.testing.assert_allclose(ti.getObjective(), ji.getObjective(),
                               rtol=rtol)


# ---- host side: bit for bit ----------------------------------------------
@pytest.mark.parametrize("case", sorted(LPS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generator_is_bit_identical(case, dtype):
    jlp, tlp = _pair(case, dtype)
    want, got = jax_fields(jlp), np_tree(tlp)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_locality_analysis():
    F_ = np.zeros((4, 3, 2))
    F_[0, 0, 0] = 1.0              # row 0: block 0 only -> group 0
    F_[2, 1, 1] = 1.0
    F_[3, 1, 0] = 2.0              # row 1: blocks 2,3 -> group 1
    F_[0, 2, 0] = 1.0
    F_[3, 2, 1] = 1.0              # row 2: blocks 0 and 3 -> global
    owner = thier.analyze_link_locality(F_, 2)
    np.testing.assert_array_equal(owner, [0, 1, -1])
    np.testing.assert_array_equal(owner, jhier.analyze_link_locality(F_, 2))


@pytest.mark.parametrize("case", sorted(LPS))
def test_layout_matches_jax(case):
    _, _, groups, levels = LPS[case]
    jlp, tlp = _pair(case)
    jh, jmeta = jhier.build_hierarchical_lp(jlp, groups,
                                            coarse_levels=levels)
    th, tmeta = thier.build_hierarchical_lp(tlp, groups,
                                            coarse_levels=levels)
    for f in dataclasses.fields(jmeta):
        np.testing.assert_array_equal(getattr(tmeta, f.name),
                                      getattr(jmeta, f.name), f.name)
    assert tmeta.levels == jmeta.levels
    # rows local to a group of the finest level or of the coarse one
    assert tmeta.mElL > 0 or tmeta.levels[0][1] > 0
    want, got = jax_fields(jh), np_tree(th)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the unpermutation inverts the layout
    vec = np.arange(th.mEl, dtype=np.float64)
    np.testing.assert_array_equal(
        thier.unpermute_link_one(tmeta, vec, "E", tlp.mEl),
        jhier.unpermute_link_one(jmeta, vec, "E", jlp.mEl))


# ---- factorize + solve_reduced on one iterate ----------------------------
def _solve(F, be, it, d, sigma_mu, delta, steps):
    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, delta, delta)
    comp = F.comp_rhs_corrector(be, it, d, sigma_mu)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    return fac, be.solve_reduced(fac, rhs, steps)


# (LP, factor dtype, refinement sweeps, rtol): f32 without refinement, so
# the comparison sees the factors' own f32 error
FACTOR_MODES = {"f64_three_layers": ("three", "float64", 1, RTOL),
                "f32_two_layers": ("two", "float32", 0, 1e-4)}


@pytest.mark.parametrize("mode", sorted(FACTOR_MODES))
def test_factorize_and_solve_match_jax(mode):
    case, fd, steps, rtol = FACTOR_MODES[mode]
    _, _, groups, levels = LPS[case]
    jlp, tlp = _pair(case)
    jh, jmeta = jhier.build_hierarchical_lp(jlp, groups,
                                            coarse_levels=levels)
    th, tmeta = thier.build_hierarchical_lp(tlp, groups,
                                            coarse_levels=levels)
    jbe = jhier.HierArrowBackend(jh, jmeta, factor_dtype=getattr(jnp, fd))
    tbe = thier.HierArrowBackend(th, tmeta, factor_dtype=getattr(torch, fd))
    assert tbe.ldl_kernel == jbe.ldl_kernel == (fd == "float32")
    rng = np.random.default_rng(3)
    it, d = random_iterate(rng, jh, True), random_iterate(rng, jh, False)
    jfac, jsol = jax.jit(lambda it_, d_: _solve(
        JF, jbe, it_, d_, jnp.asarray(0.3), 1e-8, steps))(
        JF.Iterate(**{k: jspace(v) for k, v in it.items()}),
        JF.Iterate(**{k: jspace(v) for k, v in d.items()}))
    tfac, tsol = _solve(
        TF, tbe, bridge.iterate_from_numpy(it, device="cpu",
                                           dtype=torch.float64),
        bridge.iterate_from_numpy(d, device="cpu", dtype=torch.float64),
        torch.tensor(0.3, dtype=torch.float64), 1e-8, steps)
    assert bool(tbe.factorization_ok(tfac))
    assert bool(jbe.factorization_ok(jfac))
    for g, w in zip(np_tree(tsol), np_tree(jsol)):
        for part in w:
            normwise_close(g[part], w[part], rtol)
    for name in ("Win", "WoutB", "WoutL", "T"):
        normwise_close(np_tree(getattr(tfac, name)),
                       np_tree(getattr(jfac, name)), rtol)
    assert len(tfac.L2) == len(jfac.L2) == len(levels)


# ---- the IPM -------------------------------------------------------------
@pytest.mark.parametrize("case", ["two", "three"])
def test_facade_matches_jax(case):
    lp_case, opts = FACADE[case]
    ji, ti = _facades(case, partial(_pair, lp_case), opts)
    _assert_same_solve(ji, ti)
    assert ti._hier_meta.levels == ji._hier_meta.levels
    assert len(ti._hier_meta.levels) == (1 if case == "three" else 0)
    lp = ti.lp
    for name in ACCESSORS:
        _gather_close(getattr(ti, name)(), getattr(ji, name)())
    # user row order: the sizes of the original LP
    assert ti.gatherDualSolutionEq().shape == (lp.total_eq(),)
    assert ti.gatherDualSolutionIneq().shape == (lp.total_ineq(),)


@pytest.mark.parametrize("case", ["two", "three"])
def test_fused_equals_host_loop(case):
    """The fused loop, run eagerly on the CPU, is the host loop's
    arithmetic on the hierarchical backend, refinement loop included."""
    _, _, groups, levels = LPS[case]
    th, meta = thier.build_hierarchical_lp(_pair(case)[1], groups,
                                           coarse_levels=levels)
    solver = IPMSolver(partial(thier.HierArrowBackend, meta=meta),
                       Options(), device="cpu")
    host, fused = solver.solve(th), solver.solve_fused(th)
    assert fused.info["graph"] is False
    assert host.status == fused.status \
        == TerminationStatus.SUCCESSFUL_TERMINATION
    assert host.iterations == fused.iterations
    assert [h.mu for h in host.history] == [h.mu for h in fused.history]
    assert host.objective == fused.objective


def test_scaled_gathers_match_the_flat_layout():
    """Geometric-mean scaling, then the hierarchical layout: the gathers
    undo the permutation before the link rows' scale factors, and come
    back as the flat layout's solve of the same LP
    (tests/test_hierarchical.py:99-113's bounds)."""
    lp = _pair("two")[1]
    flat, hier = (PIPSIPMppTorchInterface(lp, Options(
        hierarchical=h, scaler=ScalerType.GEOMETRIC_MEAN), device="cpu")
        for h in (False, True))
    assert flat.run() == hier.run() == \
        TerminationStatus.SUCCESSFUL_TERMINATION
    assert hier._hier_meta is not None and hier._scaler is not None
    assert abs(hier.getObjective() - flat.getObjective()) < 1e-5
    for name in ("gatherDualSolutionEq", "gatherDualSolutionIneq"):
        got, want = getattr(hier, name)(), getattr(flat, name)()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_outer_bicgstab_matches_jax():
    """OUTER_SOLVE=2 under the hierarchy: BiCGStab in the hierarchical
    state layout, one structured solve as its preconditioner."""
    lp_case, opts = FACADE["bicgstab"]
    ji, ti = _facades("bicgstab", partial(_pair, lp_case), opts)
    _assert_same_solve(ji, ti)
    _gather_close(ti.gatherPrimalSolution(), ji.gatherPrimalSolution())


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_instances(name):
    """The facade with `hierarchical=True` (f64, default options) and the
    fused loop on the same layout: the manifest's objective to 1e-4 and at
    most the JAX facade's iterations plus one; the fused loop is the host
    loop's arithmetic."""
    with open(os.path.join(DATA, "manifest.json")) as f:
        entry = next(e for e in json.load(f) if e["name"] == name)
    lp = read_blocks(os.path.join(DATA, name), n_blocks=entry["n_files"])
    ti = PIPSIPMppTorchInterface(lp, Options(hierarchical=True),
                                 device="cpu")
    assert ti.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(ti.getObjective() - entry["objective"]) < 1e-4
    assert ti.n_iterations <= GOLDEN[name] + 1
    hlp, meta = thier.build_hierarchical_lp(lp, ti._hier_meta.n_groups)
    fused = IPMSolver(partial(thier.HierArrowBackend, meta=meta), Options(),
                      device="cpu").solve_fused(hlp)
    assert (fused.status, fused.iterations) == (ti.result.status,
                                                ti.n_iterations)
    assert fused.objective == ti.result.objective


# ---- refusals ------------------------------------------------------------
def test_refusals():
    jlp, tlp = _pair("two")
    for banded in ("banded_leaf", "banded_root"):
        kw = {"hierarchical": True, banded: True}
        with pytest.raises(ValueError, match="exclusive"):
            PIPSIPMppTPUInterface(jlp, JOptions(**kw))
        with pytest.raises(ValueError, match="exclusive"):
            PIPSIPMppTorchInterface(tlp, Options(**kw), device="cpu")
    th, meta = thier.build_hierarchical_lp(tlp, 2)
    with pytest.raises(NotImplementedError, match="Distributed"):
        thier.HierArrowBackend(th, meta, dist_root=True)
    with pytest.raises(NotImplementedError,
                       match="the fused batch under the hierarchy"):
        IPMSolver(partial(thier.HierArrowBackend, meta=meta), Options(),
                  device="cpu").solve_fused_batch_async([th, th])
    with pytest.raises(ValueError, match="hierarchical_layers"):
        PIPSIPMppTorchInterface(tlp, Options(hierarchical=True,
                                             hierarchical_layers=1),
                                device="cpu").run()
