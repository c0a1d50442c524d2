"""Bucketed heterogeneous blocks in the PyTorch port (`core/bucketed.py`,
`linalg/bucket_backend.py`, the bucketed reductions of `core/spaces.py`,
the scaler's bucketed view, the facade's gathers) against the JAX
package: the counterpart of `tests/test_bucketed.py`, on its instance
(five blocks of three sizes, quantum 16: two buckets).

The host side (bucketing, placement, the buckets' arrays, the scalers'
factors) is held bit for bit; the host loop in f64 through both facades:
the same iterations, mu per iteration and objective to 1e-10 relative,
every gather to 1e-8.  One JAX facade solve, shared by its asserts."""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu.core import bucketed as jbk
from pips_ipmpp_tpu.core.options import Options as JOptions
from pips_ipmpp_tpu.core.options import ScalerType as JScalerType
from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
from pips_ipmpp_tpu.linalg import bucket_backend as jbb
from pips_ipmpp_tpu.scale import scaling as jscaling
from pips_ipmpp_tpu_torch import (Options, PIPSIPMppTorchInterface,
                                  TerminationStatus, bridge)
from pips_ipmpp_tpu_torch.core import bucketed as tbk
from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp
from pips_ipmpp_tpu_torch.core.options import ScalerType
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
from pips_ipmpp_tpu_torch.linalg import bucket_backend as tbb
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu_torch.scale import scaling as tscaling
from tests.test_bucketed import SIZES, _problem
from torch_parity import jax_fields, np_tree

RTOL = 1e-10
QUANTUM = 16
OPTS = dict(max_iterations=80, scaler="NONE")
ACCESSORS = (
    "gatherPrimalSolution", "gatherDualSolutionEq",
    "gatherDualSolutionIneq", "gatherEqualityConsValues",
    "gatherInequalityConsValues", "gatherSlacksVarsLow",
    "gatherSlacksVarsUp", "gatherSlacksInequalityLow",
    "gatherSlacksInequalityUp", "gatherDualSolutionVarBoundsLow",
    "gatherDualSolutionVarBoundsUpp", "gatherDualSolutionIneqLow",
    "gatherDualSolutionIneqUpp", "gatherPrimalResidsEQ",
    "gatherPrimalResidsIneqLow", "gatherPrimalResidsIneqUp",
    "gatherDualResids", "getFirstStagePrimalColSolution")


def _data(seed=2):
    """The blocks of tests/test_bucketed.py's `hetero_pair`."""
    return _problem(np.random.default_rng(seed), SIZES)


def _pair(quantum=QUANTUM):
    data = _data()
    return (jbk.make_bucketed_arrowhead_lp(*data, quantum=quantum),
            tbk.make_bucketed_arrowhead_lp(*data, quantum=quantum))


def _opts(O, S, kw):
    kw = dict(kw)
    kw["scaler"] = getattr(S, kw["scaler"])
    return O(**kw)


@pytest.fixture(scope="module")
def facades():
    """The JAX facade's and the port's unscaled runs of the bucketed LP."""
    jlp, tlp = _pair()
    ji = PIPSIPMppTPUInterface(jlp, _opts(JOptions, JScalerType, OPTS))
    ti = PIPSIPMppTorchInterface(tlp, _opts(Options, ScalerType, OPTS),
                                 device="cpu")
    assert ji.run().name == ti.run().name == "SUCCESSFUL_TERMINATION"
    return ji, ti


# ---- host side: bit for bit ----------------------------------------------
@pytest.mark.parametrize("quantum", [16, 64])
def test_buckets_and_placement_equal_jax(quantum):
    jlp, tlp = _pair(quantum)
    assert tbk.bucket_blocks(SIZES, quantum) \
        == jbk.bucket_blocks(SIZES, quantum)
    assert tlp.placement == jlp.placement
    assert tlp.n_buckets == jlp.n_buckets == (2 if quantum == 16 else 1)
    assert tlp.N == jlp.N and tlp.total_vars() == jlp.total_vars()
    for g, w in zip(tlp.buckets, jlp.buckets):
        want, got = jax_fields(w), np_tree(g)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    # the bridge builds the same LP from the JAX package's arrays
    again = bridge.bucketed_lp_from_numpy(
        [jax_fields(b) for b in jlp.buckets], jlp.placement, device="cpu",
        dtype=torch.float64)
    assert again.placement == tlp.placement


def test_scatter_and_gather_equal_jax():
    jlp, tlp = _pair()
    vals = [np.full((2,), float(i)) for i in range(len(SIZES))]
    got, want = tbb.scatter_to_buckets(tlp, vals), \
        jbb.scatter_to_buckets(jlp, vals)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    back = tbb.gather_from_buckets(tlp, got)
    assert [int(v[0]) for v in back] == list(range(len(SIZES)))
    assert [int(v[0]) for v in jbb.gather_from_buckets(jlp, want)] \
        == [int(v[0]) for v in back]


# each scaler with its passes cut (the bucketed view is what is held; the
# JAX side is jitted, and its compile grows with the passes)
SCALERS = {
    "EQUILIBRIUM": ("EquilibriumScaler", {}),
    "GEOMETRIC_MEAN": ("GeometricMeanScaler",
                       dict(max_iters=2, with_equilibrium=True)),
    "CURTIS_REID": ("CurtisReidScaler", dict(cg_iters=8)),
}


@pytest.mark.parametrize("kind", sorted(SCALERS))
def test_scaler_view_factors_equal_jax(kind):
    """Every scaler the JAX package's bucketed view serves gives the same
    factors (tuples of per-bucket blocks) and the same scaled buckets,
    bit for bit; Curtis-Reid's log2 factors up to its null direction
    (ROADMAP.md §3, F6): rho_i + gamma_j."""
    jlp, tlp = _pair()
    cls, kw = SCALERS[kind]

    def scale(lp):
        sc = getattr(jscaling, cls)(**kw)
        out = sc.scale(lp)
        return (sc.s, sc.rE, sc.rC), out

    (jfac, jout) = jax.jit(scale)(jlp)
    sc = getattr(tscaling, cls)(**kw)
    tout = sc.scale(tlp)
    if kind == "CURTIS_REID":
        gamma, rhoE, _ = sc.log2_factors(tscaling._view(tlp))
        # the first stage's rows x columns: the sums are the solution,
        # and rounding each factor apart moves a sum by at most 1
        got = rhoE.first[:, None] + gamma.first[None, :]
        want = (np.log2(np.asarray(jfac[1].first))[:, None]
                + np.log2(np.asarray(jfac[0].first))[None, :])
        np.testing.assert_allclose(np.round(got.numpy()), want, atol=1.0)
        return
    for g, w in zip((sc.s, sc.rE, sc.rC), jfac):
        gt, wt = np_tree(g), np_tree(w)
        for part in wt:
            for gp, wp in zip(gt[part] if isinstance(gt[part], list)
                              else [gt[part]],
                              wt[part] if isinstance(wt[part], list)
                              else [wt[part]]):
                np.testing.assert_array_equal(gp, wp, err_msg=part)
    for g, w in zip(tout.buckets, jout.buckets):
        want, got = jax_fields(w), np_tree(g)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)


# ---- the IPM -------------------------------------------------------------
def test_host_loop_matches_jax(facades):
    ji, ti = facades
    assert ti.backend_class is tbb.BucketedArrowBackend
    assert ti.n_iterations == ji.n_iterations
    np.testing.assert_allclose([h.mu for h in ti.result.history],
                               [h.mu for h in ji.result.history], rtol=RTOL)
    np.testing.assert_allclose(ti.getObjective(), ji.getObjective(),
                               rtol=RTOL)
    # and the flat padded layout's solve of the same blocks, as the JAX
    # package's test holds its bucketed solve
    flat = IPMSolver(ArrowBackend, Options(max_iterations=80),
                     device="cpu").solve(make_arrowhead_lp(*_data()))
    assert abs(flat.iterations - ti.n_iterations) <= 1
    assert ti.getObjective() == pytest.approx(flat.objective, abs=1e-6,
                                              rel=1e-6)


def test_fused_equals_host_loop(facades):
    _, ti = facades
    _, tlp = _pair()
    solver = IPMSolver(tbb.BucketedArrowBackend, Options(max_iterations=80),
                       device="cpu")
    fused = solver.solve_fused(tlp)
    assert fused.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert fused.iterations == ti.n_iterations
    assert [h.mu for h in fused.history] \
        == [h.mu for h in ti.result.history]
    assert fused.objective == ti.result.objective


def test_outer_bicgstab(facades):
    """OUTER_SOLVE=2 over the buckets: the JAX package's optimum."""
    ji, _ = facades
    _, tlp = _pair()
    r = IPMSolver(tbb.BucketedArrowBackend,
                  Options(max_iterations=80, outer_bicgstab=True),
                  device="cpu").solve(tlp)
    assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert r.objective == pytest.approx(ji.getObjective(), abs=1e-6,
                                        rel=1e-6)


def test_f32_plain_ldl(facades):
    """f32 factors: the LDL kernel's plain version at each bucket's leaf
    shape and at the root, within the reference's f32 tolerances
    (tests/test_pallas.py:28,53): 1e-3 of the f64 solve, and the factored
    inverse 1e-4 of the explicit one."""
    _, ti = facades
    _, tlp = _pair()

    def solve(**kw):
        be = partial(tbb.BucketedArrowBackend, factor_dtype=torch.float32,
                     **kw)
        assert all(s.ldl_kernel for s in be(tlp).subs)
        r = IPMSolver(be, Options(max_iterations=80),
                      device="cpu").solve(tlp)
        assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION
        return r.objective

    explicit = solve()
    assert abs(explicit - ti.getObjective()) < 1e-3
    assert abs(solve(factored_inverse=True) - explicit) < 1e-4


@pytest.mark.parametrize("mode", ["dist_root", "iterative_root",
                                  "band_root_plan", "blockwise_sc"])
def test_refuses_what_jax_refuses(mode):
    _, tlp = _pair()
    with pytest.raises(ValueError, match=mode):
        tbb.BucketedArrowBackend(tlp, **{mode: 16})


def test_facade_refusals():
    _, tlp = _pair()
    for kw in (dict(banded_leaf=True), dict(banded_root=True),
               dict(hierarchical=True)):
        with pytest.raises(ValueError, match="bucketed"):
            PIPSIPMppTorchInterface(tlp, Options(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="banded and bucketed"):
        IPMSolver(tbb.BucketedArrowBackend, Options(),
                  device="cpu").solve_fused_batch_async([tlp, tlp])


@pytest.mark.parametrize("name", ACCESSORS)
def test_gather_matches_jax(facades, name):
    ji, ti = facades
    got, want = getattr(ti, name)(), np.asarray(getattr(ji, name)())
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-8 * scale)


def test_block_accessors_match_jax(facades):
    ji, ti = facades
    assert ti.getFirstStageObjective() == pytest.approx(
        ji.getFirstStageObjective(), rel=1e-8)
    for scen in range(len(SIZES)):
        np.testing.assert_allclose(ti.getSecondStagePrimalColSolution(scen),
                                   ji.getSecondStagePrimalColSolution(scen),
                                   atol=1e-8)
    for g, w in zip(ti.allgatherBlocksizes(), ji.allgatherBlocksizes()):
        np.testing.assert_array_equal(g, w)


def test_scaled_facade_solves_the_original_problem():
    """Under a scaler the gathers unscale the bucket-tuple vectors: the
    original heterogeneous LP's KKT conditions hold (the JAX package's
    `test_bucketed_gather_api` bounds)."""
    _, tlp = _pair()
    iface = PIPSIPMppTorchInterface(
        tlp, Options(max_iterations=80,
                     scaler=ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM),
        device="cpu")
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert np.max(np.abs(iface.gatherPrimalResidsEQ())) < 1e-6
    assert np.max(np.abs(iface.gatherPrimalResidsIneqLow())) < 1e-6
    assert np.max(np.abs(iface.gatherPrimalResidsIneqUp())) < 1e-6
    assert np.max(np.abs(iface.gatherDualResids())) < 1e-5
    assert all(v < 1e-5 for v in
               iface.complementarityResiduals().values())


@pytest.mark.parametrize("fd", ["float64", "float32"])
def test_bucket_of_row_free_blocks(fd):
    """A bucket whose blocks have no rows (a dissected LP has such blocks:
    leaves of edge 0): the bucketed solve reaches the flat padded
    layout's optimum, with f64 factors and with f32 ones (the LDL
    kernel's plain version, which takes an empty leaf)."""
    data = _problem(np.random.default_rng(5), SIZES + [(9, 0, 0)])
    blp = tbk.make_bucketed_arrowhead_lp(*data, quantum=16)
    assert any(b.mE + b.mI == 0 for b in blp.buckets)
    dt = getattr(torch, fd)
    got = IPMSolver(partial(tbb.BucketedArrowBackend, factor_dtype=dt),
                    Options(max_iterations=80), device="cpu").solve(blp)
    flat = IPMSolver(ArrowBackend, Options(max_iterations=80),
                     device="cpu").solve(make_arrowhead_lp(*data))
    assert got.status == flat.status \
        == TerminationStatus.SUCCESSFUL_TERMINATION
    assert got.objective == pytest.approx(
        flat.objective, rel=1e-6 if fd == "float64" else 1e-3)
