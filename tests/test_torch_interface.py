"""The PyTorch facade's whole pipeline against the JAX package's, on the
CPU: presolve -> scaling (all four scalers) -> solve -> postsolve -> every
gather accessor, for ArrowheadLP and DenseLP; the three scalers this
package gained (geometric mean, geometric + equilibrium, Curtis-Reid) on
the dense, arrow and ELL views; the DenseLP cases of
`tests/test_ipm_dense.py`; and the T = 24 energy instance of
`tests/test_realworld.py` against HiGHS.  The JAX side is built first and
carried across as numpy (`tests/torch_parity.py`)."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu.core.lp import DenseLP as JDenseLP
from pips_ipmpp_tpu.core.options import Options as JOptions
from pips_ipmpp_tpu.core.options import PresolverType as JPresolverType
from pips_ipmpp_tpu.core.options import ScalerType as JScalerType
from pips_ipmpp_tpu.core.options import StepMode as JStepMode
from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp as jax_arrow_lp
from pips_ipmpp_tpu.io.synthetic import \
    random_sparse_arrowhead_lp as jax_sparse_lp
from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
from pips_ipmpp_tpu.linalg.dense_backend import DenseBackend as JDenseBackend
from pips_ipmpp_tpu.linalg.dense_backend import \
    random_dense_lp as jax_dense_lp
from pips_ipmpp_tpu.scale.scaling import _view as jax_view
from pips_ipmpp_tpu.scale.scaling import make_scaler as jax_make_scaler
from pips_ipmpp_tpu_torch import (DenseLP, Options, PIPSIPMppTorchInterface,
                                  TerminationStatus, bridge)
from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp
from pips_ipmpp_tpu_torch.core.options import (PresolverType, ScalerType,
                                               StepMode)
from pips_ipmpp_tpu_torch.io.energy import dispatch_blocks, highs_oracle
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
from pips_ipmpp_tpu_torch.linalg.dense_backend import (DenseBackend,
                                                       random_dense_lp)
from pips_ipmpp_tpu_torch.presolve.postsolve import Postsolver
from pips_ipmpp_tpu_torch.scale.scaling import _view, make_scaler
from tests.fixtures import two_scenario_linking_lp
from tests.test_interface import _check_kkt_surface
from torch_parity import jax_fields, jax_sparse_fields, np_tree

F64 = torch.float64
_JAX_FACADES: dict = {}
SMALL = dict(N=4, n=6, mE=2, mI=3, n0=3, m0E=1, m0I=2, mEl=2, mIl=2)

ACCESSORS = (
    "gatherPrimalSolution", "gatherDualSolutionEq",
    "gatherDualSolutionIneq", "gatherEqualityConsValues",
    "gatherInequalityConsValues", "gatherSlacksVarsLow",
    "gatherSlacksVarsUp", "gatherSlacksInequalityLow",
    "gatherSlacksInequalityUp", "gatherDualSolutionVarBoundsLow",
    "gatherDualSolutionVarBoundsUpp", "gatherDualSolutionVarBounds",
    "gatherDualSolutionIneqLow", "gatherDualSolutionIneqUpp",
    "gatherPrimalResidsEQ", "gatherPrimalResidsIneqLow",
    "gatherPrimalResidsIneqUp", "gatherDualResids")


def _port_lp(jlp):
    if isinstance(jlp, JDenseLP):
        return bridge.lp_from_numpy(jax_fields(jlp), device="cpu",
                                    dtype=F64, cls=DenseLP)
    return bridge.lp_from_numpy(jax_fields(jlp), device="cpu", dtype=F64)


def _both(jlp, **opts):
    """The JAX facade and the port's, both run with `opts` (names of the
    options' enum members for `scaler` and `presolve`)."""
    def build(O, S, P):
        kw = dict(opts)
        if "scaler" in kw:
            kw["scaler"] = getattr(S, kw["scaler"])
        if "presolve" in kw:
            kw["presolve"] = getattr(P, kw["presolve"])
        return O(**kw)

    jopts = build(JOptions, JScalerType, JPresolverType)
    ji = PIPSIPMppTPUInterface(jlp, jopts)
    # the JAX facade's solver does not depend on the scaler or presolve:
    # one per solver option set and LP shape keeps its compiled steps
    key = (repr(dataclasses.replace(jopts, scaler=JScalerType.NONE,
                                    presolve=JPresolverType.NONE)),
           tuple(np.shape(v) for v in jax_fields(jlp).values()))
    ji._solver = _JAX_FACADES.setdefault(key, ji._solver)
    ti = PIPSIPMppTorchInterface(_port_lp(jlp),
                                 build(Options, ScalerType, PresolverType),
                                 device="cpu")
    assert ji.run().name == ti.run().name == "SUCCESSFUL_TERMINATION"
    assert ti.n_iterations == ji.n_iterations
    return ji, ti


def _assert_gathers_match(ji, ti, rtol=1e-8):
    """Every gather accessor, the objectives and the stage views agree:
    max |port - JAX| <= rtol * max(1, max |JAX|) per accessor."""
    for name in ACCESSORS:
        want = getattr(ji, name)()
        got = getattr(ti, name)()
        assert got.shape == want.shape, name
        scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                                   err_msg=name)
    assert ti.getObjective() == pytest.approx(ji.getObjective(), rel=rtol)
    assert ti.getFirstStageObjective() == pytest.approx(
        ji.getFirstStageObjective(), rel=rtol, abs=rtol)
    np.testing.assert_allclose(ti.getFirstStagePrimalColSolution(),
                               ji.getFirstStagePrimalColSolution(),
                               rtol=rtol, atol=rtol)
    if hasattr(ji.lp, "N"):
        np.testing.assert_allclose(ti.getSecondStagePrimalColSolution(1),
                                   ji.getSecondStagePrimalColSolution(1),
                                   rtol=rtol, atol=rtol)
    tn = ti.printComplementarityResiduals()
    jn = ji.printComplementarityResiduals()
    assert set(tn) == set(jn)


# ----------------------------------------------------------------------
# the facade on the instances of tests/test_interface.py:81-140

def test_gather_surface_plain():
    jlp = jax_arrow_lp(11, **SMALL)
    ji, ti = _both(jlp, scaler="NONE")
    _assert_gathers_match(ji, ti)
    _check_kkt_surface(ti, jlp)


def test_gather_surface_scaled():
    jlp = jax_arrow_lp(12, **SMALL)
    ji, ti = _both(jlp, scaler="EQUILIBRIUM")
    _assert_gathers_match(ji, ti)
    _check_kkt_surface(ti, jlp)


def test_gather_surface_presolved():
    """Presolve on: the gathers postsolve one host copy of the iterate."""
    jlp, obj = two_scenario_linking_lp()
    ji, ti = _both(jlp, presolve="PRESOLVE")
    assert ti.getObjective() == pytest.approx(obj, abs=1e-5)
    _assert_gathers_match(ji, ti)
    _check_kkt_surface(ti, jlp, tol=1e-4)
    # the primal gathers replay the primal reductions alone: the full
    # postsolve's x, bit for bit
    full = ti._postsolve()
    np.testing.assert_array_equal(
        ti.gatherPrimalSolution(),
        np.concatenate([full.x0, full.xN.reshape(-1)]))
    assert set(ti.phase_times) == {"presolve", "solve", "postsolve_primal",
                                   "postsolve"}


def test_gather_objective_consistency():
    jlp = jax_arrow_lp(13, **SMALL)
    ji, ti = _both(jlp)
    x = ti.gatherPrimalSolution()
    c = np.concatenate([np.asarray(jlp.c0), np.asarray(jlp.cN).reshape(-1)])
    assert ti.getObjective() == pytest.approx(float(c @ x), rel=1e-10)
    assert ti.getObjective() == pytest.approx(ji.getObjective(), rel=1e-8)


def test_allgather_blocksizes():
    jlp = jax_arrow_lp(7, N=3, n=10, mE=4, mI=3, n0=5, m0E=2, m0I=2,
                       mEl=2, mIl=1)
    ti = PIPSIPMppTorchInterface(_port_lp(jlp), Options(), device="cpu")
    ji = PIPSIPMppTPUInterface(jlp, JOptions())
    for got, want in zip(ti.allgatherBlocksizes(), ji.allgatherBlocksizes()):
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    cols, eq, ineq = ti.allgatherBlocksizes()
    assert list(cols) == [5, 10, 10, 10]
    assert list(eq) == [2, 4, 4, 4, 2]
    assert list(ineq) == [2, 3, 3, 3, 1]


def test_presolve_infeasible_short_cut():
    """An LP presolve proves infeasible ends there, with no solve."""
    from tests.test_presolve import lp_with_redundancy
    jlp = lp_with_redundancy()
    bad = dataclasses.replace(jlp, A0=jnp.zeros_like(jlp.A0),
                              b0=jnp.ones_like(jlp.b0) * 5.0)
    ti = PIPSIPMppTorchInterface(
        _port_lp(bad), Options(presolve=PresolverType.PRESOLVE),
        device="cpu")
    assert ti.run() == TerminationStatus.INFEASIBLE
    assert set(ti.phase_times) == {"presolve"}
    with pytest.raises(RuntimeError):
        ti.gatherPrimalSolution()


def test_dense_lp_gathers_match_jax():
    """A DenseLP through both facades, scaled: every gather agrees."""
    jlp = jax_dense_lp(jax.random.PRNGKey(4), n=16, mE=5, mI=7)
    ji, ti = _both(jlp, scaler="EQUILIBRIUM")
    _assert_gathers_match(ji, ti)
    with pytest.raises(TypeError):
        ti.allgatherBlocksizes()


def test_dense_lp_happy_path():
    """The verification recipe's DenseLP: x* = (0.5, 1), objective -2.5."""
    f = lambda v: torch.as_tensor(v, dtype=F64)   # noqa: E731
    lp = DenseLP(c=f([-1.0, -2.0]), A=f([[1.0, 1.0]]), b=f([1.5]),
                 C=f(np.zeros((0, 2))), iclow=f([]), clow=f([]),
                 icupp=f([]), cupp=f([]),
                 ixlow=f([1, 1]), xlow=f([0, 0]), ixupp=f([1, 1]),
                 xupp=f([1, 1]))
    iface = PIPSIPMppTorchInterface(lp, Options(), device="cpu")
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(iface.getObjective() - (-2.5)) < 1e-6
    np.testing.assert_allclose(iface.gatherPrimalSolution(), [0.5, 1.0],
                               atol=1e-6)


# ----------------------------------------------------------------------
# the scalers on the three views

# The JAX scalers run op by op, and JAX compiles each operation once per
# shape: the arrow view takes SMALL's shapes, whose equilibrium pass
# (test_gather_surface_scaled) has compiled the maximum statistics by the
# time these run.
_VIEWS = {
    "dense": lambda: jax_dense_lp(jax.random.PRNGKey(3), n=24, mE=7, mI=9),
    "arrow": lambda: jax_arrow_lp(5, **SMALL),
    "ell": lambda: jax_sparse_lp(2, N=3, n=32, mE=12, mI=12,
                                 nnz_per_row=4, n0=4, m0E=2, m0I=2, mEl=2,
                                 mIl=2),
}


@pytest.mark.parametrize("kind", ["GEOMETRIC_MEAN",
                                  "GEOMETRIC_MEAN_EQUILIBRIUM",
                                  "CURTIS_REID"])
@pytest.mark.parametrize("view", list(_VIEWS))
def test_scaler_factors_match_jax(kind, view):
    """Powers of two in both packages: the factors s, rE, rC and the
    scaled LP are equal bit for bit.  Curtis-Reid refuses the ELL view in
    both packages."""
    jlp = _VIEWS[view]()
    if view == "ell":
        tlp = bridge.sparse_lp_from_numpy(jax_sparse_fields(jlp),
                                          device="cpu", dtype=F64)
    else:
        tlp = _port_lp(jlp)
    jsc = jax_make_scaler(getattr(JScalerType, kind))
    tsc = make_scaler(getattr(ScalerType, kind))
    if kind == "CURTIS_REID" and view == "ell":
        with pytest.raises(NotImplementedError):
            jsc.scale(jlp)
        with pytest.raises(NotImplementedError):
            tsc.scale(tlp)
        return
    jscaled = jsc.scale(jlp)
    tscaled = tsc.scale(tlp)
    for name in ("s", "rE", "rC"):
        got = np_tree(getattr(tsc, name))
        want = np_tree(getattr(jsc, name))
        _assert_tree_equal(got, want, name)
        assert not _all_ones(want), f"{name}: the scaler did nothing"
    _assert_tree_equal(np_tree(tscaled), np_tree(jscaled), "scaled LP")


@pytest.mark.parametrize("key", [0, 1])
def test_curtis_reid_log2_sums_match_jax(key, monkeypatch):
    """Curtis-Reid's rounded factors differ from the JAX package's on
    these two LPs (ROADMAP.md, F6): its CG drifts along the null shift
    (rows +c, columns -c) by an amount that turns on rounding.  What the
    least-squares problem determines, rho_i + gamma_j on every nonzero
    a_ij, agrees to 1e-12."""
    jlp = jax_dense_lp(jax.random.PRNGKey(key), n=24, mE=7, mI=9)
    seen = []
    round_ = jnp.round

    def capture(v, *args, **kw):
        seen.append(np.asarray(v))
        return round_(v, *args, **kw)

    monkeypatch.setattr(jnp, "round", capture)
    jax_make_scaler(JScalerType.CURTIS_REID)._compute(jax_view(jlp))
    monkeypatch.undo()
    rho_j, gamma_j = np.concatenate(seen[:2]), seen[2]   # rhoE, rhoC, gamma
    gamma, rhoE, rhoC = make_scaler(ScalerType.CURTIS_REID).log2_factors(
        _view(_port_lp(jlp)))
    rho_t = torch.cat([rhoE, rhoC]).numpy()
    nz = np.concatenate([np.asarray(jlp.A), np.asarray(jlp.C)]) != 0
    np.testing.assert_allclose((rho_t[:, None] + gamma.numpy()[None, :])[nz],
                               (rho_j[:, None] + gamma_j[None, :])[nz],
                               rtol=0, atol=1e-12)


def _assert_tree_equal(got, want, path):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


def _all_ones(tree):
    if isinstance(tree, dict):
        return all(_all_ones(v) for v in tree.values())
    return bool(np.all(np.asarray(tree) == 1.0))


# ----------------------------------------------------------------------
# DenseLP solves: the cases of tests/test_ipm_dense.py

_JAX_SOLVERS: dict = {}


def _jax_solve(jlp, **opts):
    """One JAX solver per option set (its compiled steps are reused for
    every LP of one shape)."""
    key = tuple(sorted(opts.items()))
    if key not in _JAX_SOLVERS:
        _JAX_SOLVERS[key] = JIPMSolver(JDenseBackend, JOptions(**opts))
    return _JAX_SOLVERS[key].solve(jlp)


def _hand_lp(c, A, b, C, iclow, clow, icupp, cupp, ixlow, xlow, ixupp,
             xupp):
    fields = dict(c=c, A=A, b=b, C=C, iclow=iclow, clow=clow, icupp=icupp,
                  cupp=cupp, ixlow=ixlow, xlow=xlow, ixupp=ixupp, xupp=xupp)
    return JDenseLP(**{k: jnp.asarray(np.asarray(v, np.float64))
                       for k, v in fields.items()})


_HAND = {
    "tiny": (lambda: _hand_lp(
        [-1.0, -2.0], [[1.0, 1.0]], [1.5], np.zeros((0, 2)), [], [], [], [],
        [1, 1], [0, 0], [1, 1], [1, 1]), {}),
    "free_variable": (lambda: _hand_lp(
        [1.0, 0.0], [[1.0, 1.0], [1.0, -1.0]], [3.0, 1.0], np.zeros((0, 2)),
        [], [], [], [], [0, 0], [0, 0], [0, 0], [0, 0]),
        dict(primal_regularization=1e-8)),
    "inequality_only": (lambda: _hand_lp(
        [-1.0, -1.0], np.zeros((0, 2)), [],
        [[1.0, 2.0], [4.0, 2.0], [-1.0, 1.0]], [0, 0, 0], [0, 0, 0],
        [1, 1, 1], [4.0, 12.0, 1.0], [1, 1], [0, 0], [0, 0], [0, 0]), {}),
    "centering_retry": (lambda: jax_dense_lp(jax.random.PRNGKey(6), n=20,
                                             mE=6, mI=8),
                        dict(small_step_threshold=2.1, max_iterations=200)),
}


def _port_opts(opts):
    kw = dict(opts)
    if "step_mode" in kw:
        kw["step_mode"] = StepMode[kw["step_mode"].name]
    return Options(**kw)


def _assert_dense_solve_matches(jlp, opts):
    want = _jax_solve(jlp, **opts)
    got = IPMSolver(DenseBackend, _port_opts(opts),
                    device="cpu").solve(_port_lp(jlp))
    assert got.status.name == want.status.name
    assert got.iterations == want.iterations
    assert got.objective == pytest.approx(float(want.objective), rel=1e-10,
                                          abs=1e-10)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", ["PRIMAL", "PRIMAL_DUAL"])
def test_dense_random_lp_matches_jax(seed, mode):
    jlp = jax_dense_lp(jax.random.PRNGKey(seed), n=30, mE=10, mI=15)
    got = _assert_dense_solve_matches(
        jlp, dict(step_mode=getattr(JStepMode, mode)))
    assert got.status == TerminationStatus.SUCCESSFUL_TERMINATION


@pytest.mark.parametrize("case", list(_HAND))
def test_dense_case_matches_jax(case):
    build, opts = _HAND[case]
    _assert_dense_solve_matches(build(), opts)


def test_random_dense_lp_same_as_jax():
    """The port's generator, given the seed the JAX one draws from its
    key, builds the same LP."""
    key = jax.random.PRNGKey(2)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    want = jax_fields(jax_dense_lp(key, n=12, mE=4, mI=5))
    got = np_tree(random_dense_lp(seed, n=12, mE=4, mI=5))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------------------

def test_energy_t24_vs_highs():
    """`tests/test_realworld.py:27-42` through the port's facade: presolve
    and geometric + equilibrium scaling, objective within 1e-6 of HiGHS,
    the gathered primal feasible in the original space."""
    blocks, first, leq, liq, _ = dispatch_blocks(T=24, R=10, G=30, L=15,
                                                 S=2, seed=1)
    obj_h, _ = highs_oracle(blocks, first, leq, liq)
    lp = make_arrowhead_lp(blocks, first, leq, liq)
    iface = PIPSIPMppTorchInterface(lp, Options(
        max_iterations=200, scaler=ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM,
        presolve=PresolverType.PRESOLVE), device="cpu")
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(iface.getObjective() - obj_h) / max(1.0, abs(obj_h)) < 1e-6
    assert np.max(np.abs(iface.gatherPrimalResidsEQ())) < 1e-5
    # the dual gathers run the whole postsolve; its duals are
    # complementary, so the facade does not warn
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        iface.gatherDualSolutionEq()
    assert iface.postsolve_dual_violation is not None


def test_postsolve_warns_on_noncomplementary_duals(monkeypatch):
    """With the dual transfer passes stopped before they move anything,
    the duals left on presolve-tightened bounds give complementarity
    products near 1 on the T = 24 energy instance: the first dual gather
    warns, and the products stay there to be read."""
    blocks, first, leq, liq, _ = dispatch_blocks(T=24, R=10, G=30, L=15,
                                                 S=2, seed=1)
    iface = PIPSIPMppTorchInterface(
        make_arrowhead_lp(blocks, first, leq, liq), Options(
            max_iterations=200,
            scaler=ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM,
            presolve=PresolverType.PRESOLVE), device="cpu")
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    stop = lambda self, sol, *rest: self._recompute_bound_duals(sol)  # noqa
    monkeypatch.setattr(Postsolver, "_directed_bound_dual_transfers", stop)
    monkeypatch.setattr(Postsolver, "_transfer_interior_bound_duals", stop)
    with pytest.warns(RuntimeWarning, match="not complementary"):
        iface.gatherDualSolutionEq()
    assert max(iface.complementarityResiduals().values()) > 0.1
