"""Presolve, postsolve, the native presolve scans and the energy generator
of the PyTorch package against the JAX package, on the CPU.

The LPs are the JAX package's own presolve instances: those of
`tests/test_presolve.py` and `tests/test_postsolve_stress.py` (each caught
where its test hands it to the presolver, before anything is solved), the
planted stress LPs of every seed there, and three GAMSsmall instances.
Both presolvers are host numpy, so their event logs, stats, flags and
presolved LPs must be equal bit for bit; so must the two postsolvers'
answers on one Solution, the port's native and pure-Python paths, and
each native scan against the JAX package's own library (its committed
build and this package's `-march=native` build agree to the bit here).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import tests.test_postsolve_stress as jax_stress
import tests.test_presolve as jax_presolve
from pips_ipmpp_tpu import native as jax_native
from pips_ipmpp_tpu.core.lp import make_arrowhead_lp as jax_make_lp
from pips_ipmpp_tpu.core.options import PresolverType as JPresolverType
from pips_ipmpp_tpu.core.status import TerminationStatus as JStatus
from pips_ipmpp_tpu.io import energy as jax_energy
from pips_ipmpp_tpu.io.blockfile import read_blocks as jax_read_blocks
from pips_ipmpp_tpu.presolve import Presolver as JPresolver
from pips_ipmpp_tpu.presolve.postsolve import Postsolver as JPostsolver
from pips_ipmpp_tpu.presolve.postsolve import Solution as JSolution
from pips_ipmpp_tpu_torch import bridge, native
from pips_ipmpp_tpu_torch.io import energy
from pips_ipmpp_tpu_torch.presolve import Presolver
from pips_ipmpp_tpu_torch.presolve.postsolve import Postsolver, Solution
from torch_parity import jax_fields

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "gamssmall")
with open(os.path.join(DATA, "manifest.json")) as f:
    MANIFEST = {m["name"]: m for m in json.load(f)}


class _Caught(Exception):
    pass


def _catch(module, test_name, **params):
    """(JAX LP, Presolver kwargs) that `module.test_name(**params)` first
    hands to a presolver, directly or through the facade with presolve
    on; the test stops there, before anything is solved."""
    caught = []

    class Pres:
        def __init__(self, **kw):
            self.kw = kw

        def presolve(self, lp):
            caught.append((lp, self.kw))
            raise _Caught

    class Facade:
        def __init__(self, lp, opts=None):
            if opts is not None and opts.presolve == JPresolverType.PRESOLVE:
                caught.append((lp, dict(max_rounds=opts.presolve_max_rounds)))
                raise _Caught

        def run(self):
            return JStatus.SUCCESSFUL_TERMINATION

    mp = pytest.MonkeyPatch()
    mp.setattr(module, "Presolver", Pres)
    mp.setattr(module, "PIPSIPMppTPUInterface", Facade)
    try:
        getattr(module, test_name)(**params)
    except _Caught:
        pass
    finally:
        mp.undo()
    assert caught, f"{test_name} reached no presolver"
    return caught[0]


def _gams(name):
    entry = MANIFEST[name]
    return jax_read_blocks(os.path.join(DATA, name),
                           n_blocks=entry["n_files"]), {}


CASES = {
    **{name: (lambda n=name: _catch(jax_presolve, n)) for name in (
        "test_passes_fire",
        "test_presolve_preserves_objective_and_postsolves",
        "test_presolve_two_scenario_lp",
        "test_infeasible_empty_row",
        "test_infeasible_crossed_bounds_via_singleton",
        "test_singleton_column",
        "test_nearly_parallel_rows_general",
        "test_nearly_parallel_rows_fix",
        "test_redundant_row_removed",
        "test_bounded_singleton_column_implied_free",
        "test_bounded_singleton_column_with_unbounded_mate_keeps_bound",
        "test_singleton_rows_sharing_variable",
        "test_crossed_bounds_infeasible",
        "test_tiny_entry_on_unbounded_variable_not_dropped",
        "test_large_magnitude_substitution_cancellation_tolerated",
        "test_singleton_column_inequality")},
    **{f"test_presolve_on_random_lp[{s}]":
       (lambda s=s: _catch(jax_presolve, "test_presolve_on_random_lp",
                           seed=s)) for s in (0, 1)},
    **{f"planted_lp[{s}]": (lambda s=s: (jax_stress.planted_lp(s), {}))
       for s in (0, 1, 2, 3)},
    **{name: (lambda n=name: _catch(jax_stress, n)) for name in (
        "test_tightened_bound_dual_transfers_to_implying_row",
        "test_directed_transfer_uses_recorded_provenance")},
    **{name: (lambda n=name: _gams(n)) for name in (
        "exampleAC_boundStrength", "nearlyParallelInequalityRows_B0A2",
        "singletonInequalityColumn_B1")},
}


def _port_lp(jlp):
    return bridge.lp_from_numpy(jax_fields(jlp), device="cpu",
                                dtype=torch.float64)


def _assert_same(got, want, path):
    """Equal values (dict, list, tuple, array or scalar), bit for bit;
    NaNs equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (str, bool, type(None))):
        assert got == want, (path, got, want)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, \
            (path, g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


def _assert_same_result(got, want):
    assert got.infeasible == want.infeasible
    assert got.stats == want.stats
    _assert_same(got.objective_offset, want.objective_offset, "offset")
    assert [e.kind for e in got.events] == [e.kind for e in want.events]
    for i, (g, w) in enumerate(zip(got.events, want.events)):
        _assert_same(g.data, w.data, f"event {i} ({w.kind})")
    if want.lp is None:
        assert got.lp is None
    else:
        _assert_same({k: v.numpy() for k, v in
                      dataclasses.asdict(got.lp).items()},
                     jax_fields(want.lp), "lp")


@pytest.mark.parametrize("case", list(CASES))
def test_presolve_matches_jax(case):
    """Event logs (kinds and data), stats, the infeasible flag, the
    objective offset and the presolved LP, bit for bit."""
    jlp, kw = CASES[case]()
    want = JPresolver(**kw).presolve(jlp)
    got = Presolver(**kw).presolve(_port_lp(jlp))
    assert got.lp is None or got.lp.dtype == torch.float64
    _assert_same_result(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_native_and_python_paths_agree(case, monkeypatch):
    """The port's presolve with its native library and with the library's
    plain version (the JAX package's pure-Python formulation) gives the
    same event log, stats and presolved LP."""
    assert native.available(), native.build_error
    jlp, kw = CASES[case]()
    lp = _port_lp(jlp)
    with_lib = Presolver(**kw).presolve(lp)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = Presolver(**kw).presolve(lp)
    _assert_same_result(plain, with_lib)


def _solution(rng, lp, cls):
    """A Solution of the LP's shapes with random values."""
    def r(*shape):
        return rng.normal(size=shape)
    return cls(x0=r(lp.n0), xN=r(lp.N, lp.n), y0=r(lp.m0E),
               yN=r(lp.N, lp.mE), yl=r(lp.mEl), z0=r(lp.m0I),
               zN=r(lp.N, lp.mI), zl=r(lp.mIl))


@pytest.mark.parametrize("case", [c for c in CASES
                                  if "infeasible" not in c])
def test_postsolve_matches_jax(case):
    """Both postsolvers replay their own event log over the original LP
    from one Solution (random values of the presolved shapes): equal
    arrays."""
    jlp, kw = CASES[case]()
    want_log = JPresolver(**kw).presolve(jlp)
    got_log = Presolver(**kw).presolve(_port_lp(jlp))
    assert not want_log.infeasible and not got_log.infeasible
    want_sol = _solution(np.random.default_rng(0), jlp, JSolution)
    got_sol = _solution(np.random.default_rng(0), jlp, Solution)
    want = JPostsolver(jlp).postsolve(want_log.events, want_sol)
    got = Postsolver(_port_lp(jlp)).postsolve(got_log.events, got_sol)
    _assert_same(dataclasses.asdict(got), dataclasses.asdict(want),
                 "solution")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_scans_match_jax_library(seed):
    """Each scan of this package's library against the JAX package's
    library on one random matrix with planted structure, bit for bit."""
    assert native.available(), native.build_error
    if not jax_native.available():
        pytest.skip("the JAX package's native library does not load here")
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(40, 12))
    M[M < -1.0] = 0.0
    M[3] = 2.5 * M[1]
    M[7] = -M[1]
    M[9, 4] = 1e-14
    M[11] = 0.0
    M[11, 5] = 3.0
    lo = np.where(rng.random(12) < 0.8, -rng.random(12), -np.inf)
    up = np.where(rng.random(12) < 0.8, rng.random(12), np.inf)
    for fn, args in (("row_support_stats", (M, 1e-12)),
                     ("detect_parallel_rows", (M, 1e-12)),
                     ("row_activity_bounds", (M, lo, up))):
        _assert_same(getattr(native, fn)(*args),
                     getattr(jax_native, fn)(*args), fn)
    for fn, args in (("drop_tiny_entries", (1e-12, 1e-10)),
                     ("drop_tiny_impact", (np.abs(up - lo), 1e-6, 1e-12,
                                           1e-10))):
        a, b = M.copy(), M.copy()
        assert getattr(native, fn)(a, *args) == \
            getattr(jax_native, fn)(b, *args), fn
        np.testing.assert_array_equal(a, b, err_msg=fn)


@pytest.mark.parametrize("kw", [
    dict(T=24, R=10, G=30, L=15, S=2, seed=1),
    dict(T=12, R=8, G=20, L=10, S=2, seed=2),
    dict(T=16, R=8, G=20, L=10, S=6, seed=4),
], ids=["T24", "T12", "T16S6"])
def test_dispatch_blocks_bit_identical(kw):
    """`io/energy.dispatch_blocks` equals the JAX package's for the same
    arguments, and `to_scipy` assembles the same flat LP."""
    got = energy.dispatch_blocks(**kw)
    want = jax_energy.dispatch_blocks(**kw)
    _assert_same(list(got), list(want), "dispatch_blocks")
    for g, w in zip(energy.to_scipy(*got[:4]), jax_energy.to_scipy(*want[:4])):
        if hasattr(w, "toarray"):
            g, w = g.toarray(), w.toarray()
        np.testing.assert_array_equal(g, w)
    lp = bridge.lp_from_numpy(jax_fields(jax_make_lp(*want[:4])),
                              device="cpu", dtype=torch.float64)
    assert lp.total_vars() == want[4]["n0"] + kw["T"] * want[4]["n_block"]
