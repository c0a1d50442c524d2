"""The banded leaf and the banded root of the PyTorch port
(`linalg/band_backend.py`, `linalg/band_root.py`, `ArrowBackend(
band_root_plan=)`, the facade's `banded_leaf`/`banded_root`) against the
JAX package: the counterpart of `tests/test_band_backend.py` and
`tests/test_band_root.py`, on their instances.

The host side (generators, both plans) is numpy in both packages and held
element for element.  The block-tridiagonal factor and solve to 1e-12;
`factorize` and one `solve_reduced` on one iterate to 1e-10 (the JAX side
jitted).  The host loop in f64: the same iterations, mu per iteration and
the objective to 1e-10 relative; the fused loop (eager on the CPU) equals
the host loop.  One JAX solve per instance, shared by its asserts."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu.core.options import Options as JOptions
from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
from pips_ipmpp_tpu.io import synthetic as jsyn
from pips_ipmpp_tpu.ipm import formulation as JF
from pips_ipmpp_tpu.ipm.solver import IPMSolver as JSolver
from pips_ipmpp_tpu.linalg import band_backend as jband
from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend as JArrow
from pips_ipmpp_tpu.linalg.band_root import plan_banded_root as jplan_root
from pips_ipmpp_tpu_torch import (Options, PIPSIPMppTorchInterface,
                                  TerminationStatus, bridge)
from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp, stack_lps
from pips_ipmpp_tpu_torch.core.options import PresolverType
from pips_ipmpp_tpu_torch.io import energy
from pips_ipmpp_tpu_torch.io import synthetic as tsyn
from pips_ipmpp_tpu_torch.ipm import formulation as TF
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
from pips_ipmpp_tpu_torch.linalg import band_backend as tband
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu_torch.linalg.band_root import plan_banded_root
from torch_parity import (jax_fields, jspace, normwise_close, np_tree,
                          random_iterate)

RTOL = 1e-10

# the banded-leaf LPs of tests/test_band_backend.py (seed, N, n, mE=mI,
# window), with planted dense rows where `plant`
LEAF = {
    "plan_props": (1, 3, 64, 32, 5),
    "ipm": (0, 4, 96, 48, 6),
    "memory": (2, 2, 128, 64, 4),
    "shared": (4, 8, 64, 32, 5),
    "dense_rows": (5, 3, 128, 64, 4),
}
# (LEAF case, plan_banded arguments, planted rows)
LEAF_PLANS = {
    "plan_props": ("plan_props", {}, False),
    "ipm": ("ipm", {}, False),
    "memory": ("memory", {}, False),
    "shared": ("shared", dict(shared=True), False),
    "peeled": ("dense_rows", {}, True),
    "blown": ("dense_rows", dict(max_dense_frac=0.0), True),
    "plain": ("dense_rows", dict(max_dense_frac=0.0), False),
}
# the banded-root LPs of tests/test_band_root.py (seed, N, n_global)
ROOT = {
    "two_link": (0, 8, 0), "sc_pattern": (3, 6, 0), "ipm": (1, 8, 0),
    "ipm_global": (1, 8, 1), "distributed": (2, 8, 0), "local": (4, 16, 0),
    "global": (4, 16, 3), "ring": (6, 12, 0),
}
ROOT_PLANS = {k: (k, {}) for k in ROOT}
ROOT_PLANS["unpeeled"] = ("global", dict(max_dense_frac=0.0))


def _leaf_pair(case):
    seed, N, n, m, w = LEAF[LEAF_PLANS.get(case, (case,))[0]]
    kw = dict(N=N, n=n, mE=m, mI=m, window=w)
    jlp = jsyn.banded_arrowhead_lp(seed, dtype=jnp.float64, **kw)
    tlp = tsyn.banded_arrowhead_lp(seed, **kw)
    if case in LEAF_PLANS and LEAF_PLANS[case][2]:
        # two planted near-global equality rows per block
        B = np.asarray(jlp.B).copy()
        rng = np.random.default_rng(0)
        B[:, 10, :] = rng.normal(size=(N, n)) * 0.1
        B[:, 40, :] = rng.normal(size=(N, n)) * 0.1
        jlp = dataclasses.replace(jlp, B=jnp.asarray(B))
        tlp = dataclasses.replace(tlp, B=torch.from_numpy(B))
    return jlp, tlp


def _ring(mod, base):
    """tests/test_band_root.py's ring instance: row r couples blocks r//2
    and (r//2 + 1) mod N."""
    N, n = base.N, base.n
    rng = np.random.default_rng(21)
    F = np.zeros((N, base.mEl, n))
    G = np.zeros((N, base.mIl, n))
    for r in range(base.mEl + base.mIl):
        blk = (r // 2) % N
        strip = F if r % 2 == 0 else G
        for i in (blk, (blk + 1) % N):
            strip[i, r // 2] = rng.normal(size=n) * 0.2
    dt = jnp.float64 if mod is jsyn else torch.float64
    return mod.refit_feasible(base, F, G, rng, dtype=dt)


def _root_pair(case):
    seed, N, ng = ROOT[case]
    kw = dict(N=N, links_per_block=2, klink=2, n_global=ng)
    if case == "ring":
        kw = dict(N=N, n=24, links_per_block=2, klink=2)
    jlp = jsyn.klink_arrowhead_lp(seed, dtype=jnp.float64, **kw)
    tlp = tsyn.klink_arrowhead_lp(seed, **kw)
    if case == "ring":
        jlp, tlp = _ring(jsyn, jlp), _ring(tsyn, tlp)
    return jlp, tlp


def _assert_plan_equal(got, want):
    for name in ("perm", "iperm"):
        np.testing.assert_array_equal(got.__dict__[name],
                                      np.asarray(want.__dict__[name]))
    for name in ("half_bandwidth", "panel", "n_panels", "n_dense"):
        assert got.__dict__[name] == want.__dict__[name], name


# ---- host side: element for element --------------------------------------
@pytest.mark.parametrize("gen", ["banded", "klink", "ring"])
def test_generators_are_bit_identical(gen):
    jlp, tlp = (_leaf_pair("ipm") if gen == "banded" else
                _root_pair("ipm_global" if gen == "klink" else "ring"))
    want, got = jax_fields(jlp), np_tree(tlp)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("case", sorted(LEAF_PLANS))
def test_leaf_plan_equals_jax(case):
    jlp, tlp = _leaf_pair(case)
    kw = LEAF_PLANS[case][1]
    got, want = tband.plan_banded(tlp, **kw), jband.plan_banded(jlp, **kw)
    _assert_plan_equal(got, want)
    if case == "shared":
        assert got.perm.ndim == 1
    if case == "peeled":
        assert got.n_dense >= 2
    # the bridge carries a JAX plan over as it is
    _assert_plan_equal(bridge.band_plan_from_numpy(want.__dict__), want)


@pytest.mark.parametrize("case", sorted(ROOT_PLANS))
def test_root_plan_equals_jax(case):
    jlp, tlp = _root_pair(ROOT_PLANS[case][0])
    kw = ROOT_PLANS[case][1]
    got, want = plan_banded_root(tlp, **kw), jplan_root(jlp, **kw)
    _assert_plan_equal(got, want)
    if case == "global":
        assert got.n_dense >= 3
    if case == "ring":
        assert got.n_dense == 0 and got.half_bandwidth <= 8
    _assert_plan_equal(bridge.band_root_plan_from_numpy(want.__dict__),
                       want)


# ---- the block-tridiagonal factor and solve ------------------------------
@pytest.mark.parametrize("c", [1, 3])
def test_block_tridiag_matches_jax(c):
    rng = np.random.default_rng(c)
    nb, N, b = 5, 3, 4
    Adiag = np.zeros((nb, N, b, b))
    Asub = np.zeros((nb, N, b, b))
    for k in range(nb):
        Q = rng.normal(size=(N, b, b))
        Adiag[k] = Q @ Q.transpose(0, 2, 1) + (b + 4) * np.eye(b)
        if k < nb - 1:
            Asub[k] = rng.normal(size=(N, b, b)) * 0.3
    r = rng.normal(size=(nb, N, b, c))
    jG, jC, jok = jax.jit(jband.block_tridiag_factor)(Adiag, Asub)
    jx = jax.jit(jband.block_tridiag_solve)(jG, jC, r)
    tG, tC, tok = tband.block_tridiag_factor(torch.from_numpy(Adiag),
                                             torch.from_numpy(Asub))
    tx = tband.block_tridiag_solve(tG, tC, torch.from_numpy(r))
    assert bool(tok) and bool(jok)
    for g, w in ((tG, jG), (tC, jC), (tx, jx)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


# ---- factorize + solve_reduced on one iterate ----------------------------
def _solve(F, be, it, d, sigma_mu, delta):
    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, delta, delta)
    comp = F.comp_rhs_corrector(be, it, d, sigma_mu)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    return fac, be.solve_reduced(fac, rhs, 1)


def _backends(case):
    """(JAX backend, port backend, LP) of a factorize case: a banded leaf
    (with peeled rows in `leaf_peeled`) or a banded root."""
    if case.startswith("leaf"):
        jlp, tlp = _leaf_pair("ipm" if case == "leaf" else "peeled")
        jplan = jband.plan_banded(jlp)
        return (jband.BandArrowBackend(jlp, jplan,
                                       factor_dtype=jnp.float64),
                tband.BandArrowBackend(tlp, tband.plan_banded(tlp)), jlp)
    jlp, tlp = _root_pair("ipm_global")
    return (JArrow(jlp, factor_dtype=jnp.float64,
                   band_root_plan=jplan_root(jlp)),
            ArrowBackend(tlp, band_root_plan=plan_banded_root(tlp)), jlp)


@pytest.mark.parametrize("case", ["leaf", "leaf_peeled", "root"])
def test_factorize_and_solve_match_jax(case):
    jbe, tbe, jlp = _backends(case)
    rng = np.random.default_rng(3)
    it, d = random_iterate(rng, jlp, True), random_iterate(rng, jlp, False)
    jfac, jsol = jax.jit(lambda it_, d_: _solve(
        JF, jbe, it_, d_, jnp.asarray(0.3), 1e-8))(
        JF.Iterate(**{k: jspace(v) for k, v in it.items()}),
        JF.Iterate(**{k: jspace(v) for k, v in d.items()}))
    tfac, tsol = _solve(
        TF, tbe, bridge.iterate_from_numpy(it, device="cpu",
                                           dtype=torch.float64),
        bridge.iterate_from_numpy(d, device="cpu", dtype=torch.float64),
        torch.tensor(0.3, dtype=torch.float64), 1e-8)
    assert bool(tbe.factorization_ok(tfac))
    assert bool(jbe.factorization_ok(jfac))
    for g, w in zip(np_tree(tsol), np_tree(jsol)):
        for part in w:
            normwise_close(g[part], w[part], RTOL)
    if case == "root":
        normwise_close(tfac.chol1.numpy(), np.asarray(jfac.chol1), RTOL)
        for g, w in zip(tfac.RbG, jfac.RbG):
            normwise_close(g.numpy(), np.asarray(w), RTOL)
    else:
        for g, w in zip(tfac.L, jfac.L):
            normwise_close(g.numpy(), np.asarray(w), RTOL)


# ---- the IPM -------------------------------------------------------------
# (LP pair, plans): the banded leaf, the banded root without and with
# global linking rows
IPM = {"leaf": "leaf", "root": "ipm", "root_global": "ipm_global"}
# mu per iteration: 1e-10 relative, but on the LP with a global row, whose
# last iterations amplify rounding: there the port's banded root parts
# from the JAX package's by 2.3e-10 at its 11th of 12 iterations, and the
# port's dense root (ArrowBackend without a plan) from the JAX package's
# dense root by 1.4e-10 at its 10th
MU_RTOL = {"leaf": RTOL, "root": RTOL, "root_global": 3e-10}
_RUNS: dict = {}


def _ipm(case):
    """(JAX host-loop result, port solver, port LP) of an IPM case
    (memoized: one JAX solve per case)."""
    if case not in _RUNS:
        if case == "leaf":
            jlp, tlp = _leaf_pair("ipm")
            jctor = partial(jband.BandArrowBackend,
                            plan=jband.plan_banded(jlp),
                            factor_dtype=jnp.float64)
            tctor = partial(tband.BandArrowBackend,
                            plan=tband.plan_banded(tlp))
        else:
            jlp, tlp = _root_pair(IPM[case])
            jctor = partial(JArrow, band_root_plan=jplan_root(jlp),
                            factor_dtype=jnp.float64)
            tctor = partial(ArrowBackend,
                            band_root_plan=plan_banded_root(tlp))
        _RUNS[case] = (JSolver(jctor, JOptions()).solve(jlp),
                       IPMSolver(tctor, Options(), device="cpu"), tlp)
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(IPM))
def test_host_loop_matches_jax(case):
    want, solver, lp = _ipm(case)
    got = solver.solve(lp)
    assert got.status.name == want.status.name == "SUCCESSFUL_TERMINATION"
    assert got.iterations == want.iterations
    np.testing.assert_allclose([h.mu for h in got.history],
                               [h.mu for h in want.history],
                               rtol=MU_RTOL[case])
    np.testing.assert_allclose(got.objective, float(want.objective),
                               rtol=RTOL)


@pytest.mark.parametrize("case", sorted(IPM))
def test_fused_equals_host_loop(case):
    """The fused loop, eager on the CPU: the host loop's arithmetic, so
    the same iterations and objective and the mu history bit for bit."""
    want, solver, lp = _ipm(case)
    host = solver.solve(lp)
    fused = solver.solve_fused(lp)
    assert fused.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert fused.iterations == host.iterations == want.iterations
    assert [h.mu for h in fused.history] == [h.mu for h in host.history]
    assert fused.objective == host.objective


def test_facade_with_both_flags_matches_jax():
    """tests/test_interface.py:114's LP with banded_leaf and banded_root
    together, through both facades: the same iterations, mu per
    iteration (to 1e-9: the last, 5.8e-6, parts by 3.6e-15, 6.3e-10
    relative), objective and primal solution."""
    kw = dict(N=4, n=64, mE=32, mI=32, window=5)
    opts = dict(banded_leaf=True, banded_root=True)
    ji = PIPSIPMppTPUInterface(
        jsyn.banded_arrowhead_lp(6, dtype=jnp.float64, **kw),
        JOptions(**opts))
    ti = PIPSIPMppTorchInterface(tsyn.banded_arrowhead_lp(6, **kw),
                                 Options(**opts), device="cpu")
    assert ti.backend_class is tband.BandArrowBackend
    assert ji.run().name == ti.run().name == "SUCCESSFUL_TERMINATION"
    assert ti.n_iterations == ji.n_iterations
    np.testing.assert_allclose([h.mu for h in ti.result.history],
                               [h.mu for h in ji.result.history], rtol=1e-9)
    np.testing.assert_allclose(ti.getObjective(), ji.getObjective(),
                               rtol=RTOL)
    normwise_close(ti.gatherPrimalSolution(), ji.gatherPrimalSolution(),
                   1e-8)
    normwise_close(ti.gatherDualSolutionEq(), ji.gatherDualSolutionEq(),
                   1e-8)


# the JAX facade's run of this case (presolve, banded_root, f64 on the
# CPU): 12 iterations, objective 367.34324942927844; HiGHS 367.3432002995129
PRESOLVED_JAX = (12, 367.34324942927844)


def test_presolve_then_banded_root():
    """The banded root plans on the LP as given and solves the presolved
    one (the facade's order, as the JAX package's): the small energy LP
    in the JAX facade's iterations, its objective to 1e-10 and HiGHS's
    to 1e-6."""
    blocks, first, leq, liq, _ = energy.dispatch_blocks(
        T=6, R=8, G=20, L=10, S=4, seed=4)
    iface = PIPSIPMppTorchInterface(
        make_arrowhead_lp(blocks, first, leq, liq),
        Options(presolve=PresolverType.PRESOLVE, banded_root=True),
        device="cpu")
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert iface.n_iterations == PRESOLVED_JAX[0]
    np.testing.assert_allclose(iface.getObjective(), PRESOLVED_JAX[1],
                               rtol=RTOL)
    oracle, _ = energy.highs_oracle(blocks, first, leq, liq)
    assert abs(iface.getObjective() - oracle) <= 1e-6 * abs(oracle)


def test_band_refusals():
    """What the JAX package refuses, and the batch, which is not ported."""
    _, tlp = _root_pair("ipm")
    plan = plan_banded_root(tlp)
    with pytest.raises(ValueError, match="exclusive"):
        ArrowBackend(tlp, band_root_plan=plan, iterative_root=16)
    with pytest.raises(NotImplementedError, match="banded and bucketed"):
        ArrowBackend(stack_lps([tlp, tlp]), band_root_plan=plan)
    with pytest.raises(NotImplementedError, match="banded and bucketed"):
        tband.BandArrowBackend(stack_lps([tlp, tlp]),
                               plan=tband.plan_banded(tlp))
    with pytest.raises(ValueError, match="panel"):
        tband.plan_banded(tlp, panel=1)
