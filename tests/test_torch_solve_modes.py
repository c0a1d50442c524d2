"""ArrowBackend's three remaining solve modes against the JAX package:
outer BiCGStab (OUTER_SOLVE=2), the SC-sparsifier iterative root
(PRECONDITION_SPARSE) and the blockwise Schur complement
(SC_COMPUTE_BLOCKWISE), f64 on the CPU.

    PYTHONPATH=. python tests/test_torch_solve_modes.py energy MODE [T]

runs the JAX package (CPU, f64) through its facade on the energy LP of
`chip_smoke.py` cut to T blocks (default 12) at full width, with the
energy options and one mode: `bicgstab` (outer_bicgstab), `precond`
(iterative_root_panel = 64) or `blockwise` (sc_blockwise = 64), with
its iteration log, and prints one JSON line after the solve (status,
iterations, the solver's objective, the BiCGStab or CG trip counts) and
one more after the gathers (the objective in the original space, the
equality residual), which run the JAX package's whole postsolve.

    PYTHONPATH=. python tests/test_torch_solve_modes.py f32 SEED ...

prints, per seed, the IPM iterations with f32 factors, direct and under
outer BiCGStab, in both packages, on one small random LP
(`f32_bicgstab_counts`).

    PYTHONPATH=. python tests/test_torch_solve_modes.py mu INSTANCE {mode,default}

prints both packages' iterations and their largest relative difference
of mu per iteration on the instance of tests/test_bicgstab.py or
tests/test_sc_precond.py, with its mode or the default path
(`mu_parity`).
"""
import contextlib
import json
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu.core.options import Options as JOptions
from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp as jax_lp
from pips_ipmpp_tpu.ipm import formulation as JF
from pips_ipmpp_tpu.ipm.solver import IPMSolver as JSolver
from pips_ipmpp_tpu.linalg import arrow_backend as jab
from pips_ipmpp_tpu.linalg import sc_precond as jsc
from pips_ipmpp_tpu_torch import (Options, PIPSIPMppTorchInterface,
                                  TerminationStatus, bridge)
from pips_ipmpp_tpu_torch.io.synthetic import (random_arrowhead_lp,
                                               random_sparse_arrowhead_lp)
from pips_ipmpp_tpu_torch.ipm import formulation as TF
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
from pips_ipmpp_tpu_torch.linalg import arrow_backend as tab
from pips_ipmpp_tpu_torch.linalg import sc_precond as tsc
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu_torch.linalg.sparse_backend import SparseArrowBackend
from torch_parity import (jax_fields, jspace, normwise_close, np_tree,
                          random_iterate)

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _stats(st) -> dict:
    return {k: _np(v).item() for k, v in st.items()}


# ---- 1. the Krylov loops on one dense operator ----------------------------
def _skew(n, eps, seed):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(n, n))
    return S - S.T + eps * np.eye(n), rng.normal(size=n)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n), rng.normal(size=n)


ROT = (np.array([[0.0, 1.0], [-1.0, 0.0]]), np.array([1.0, 2.0]))

# name: (solver, (K, b), preconditioner "jacobi" or "none", flag expected).
# The exact rotation makes p'Kp = 0 on the first trip (breakdown, flag 1);
# skew + 1e-6 I makes BiCGStab's first alpha ~1e6 (divergence, flag 2).
KRYLOV = {
    "bicgstab": ("bicgstab", (np.array([[4.0, 1.0, 0.5], [0.2, 3.0, 1.0],
                                        [0.3, 0.1, 5.0]]),
                              np.array([1.0, -2.0, 0.5])), "jacobi", 0),
    "bicgstab_nonsym12": ("bicgstab", _skew(12, 6.0, 1), "jacobi", 0),
    "bicgstab_breakdown": ("bicgstab", ROT, "none", 1),
    "bicgstab_divergence": ("bicgstab", _skew(12, 1e-6, 0), "none", 2),
    "cg": ("cg", _spd(40, 0), "jacobi", 0),
    "cg_breakdown": ("cg", ROT, "none", 1),
}


@pytest.mark.parametrize("case", sorted(KRYLOV))
def test_krylov_matches_jax(case):
    kind, (K, b), pre, flag = KRYLOV[case]
    dinv = 1.0 / np.diag(K) if pre == "jacobi" else np.ones(len(b))
    jfn = dict(bicgstab=jab.preconditioned_bicgstab,
               cg=jab.preconditioned_cg)[kind]
    tfn = dict(bicgstab=tab.preconditioned_bicgstab,
               cg=tab.preconditioned_cg)[kind]
    Kj, dj = jnp.asarray(K), jnp.asarray(dinv)
    ju, jst = jfn(jnp.asarray(b), lambda v: dj * v, lambda v: Kj @ v,
                  jnp.vdot, 50, 1e-12)
    Kt, dt = _t(K), _t(dinv)
    tu, tst = tfn(_t(b), lambda v: dt * v, lambda v: Kt @ v, tab._vdot, 50,
                  1e-12)
    jst, tst = _stats(jst), _stats(tst)
    assert tst["flag"] == jst["flag"] == flag, (tst, jst)
    assert tst["iterations"] == jst["iterations"]
    assert tst["converged"] == jst["converged"] == (flag == 0)
    # a converged residual below the tolerance is rounding, and the
    # divergent case's first step amplifies rounding by its alpha ~1e6
    np.testing.assert_allclose(tst["relres"], jst["relres"], rtol=1e-8,
                               atol=1e-12)
    # divergence: the first step divides by rhat'K p = 1e-6 |p|^2, so the
    # packages' rounding in that dot product (2e-16 apart) comes out
    # amplified 1e6-fold (measured 2.2e-10)
    normwise_close(_np(tu), np.asarray(ju), 1e-9 if flag == 2 else 1e-12)


# ---- 2. solve_reduced_bicgstab from one interior iterate -------------------
# the instance of tests/test_bicgstab.py:19-22 (seeds 0, 1) and the inexact-
# preconditioner one of :42 (f32 factors; the JAX LDL kernel in Pallas
# interpret mode)
BICG_CASES = {
    "seed0": (0, dict(N=3, n=5, mE=2, mI=3, n0=2, m0E=1, m0I=2, mEl=2,
                      mIl=1), "float64", 10, 1e-12),
    "seed1": (1, dict(N=3, n=5, mE=2, mI=3, n0=2, m0E=1, m0I=2, mEl=2,
                      mIl=1), "float64", 10, 1e-12),
    "f32_inexact": (5, dict(N=3), "float32", 20, 1e-11),
}


def _direction_setup(F, be, it):
    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, 0.0, 0.0)
    comp = F.comp_rhs_affine(be, it)
    return fac, F.assemble_reduced_rhs(be, it, res, comp, Ominv)


def _both(jlp, seed):
    """The JAX and port backends' inputs for one numpy iterate."""
    it = random_iterate(np.random.default_rng(seed), jlp, True)
    tlp = bridge.lp_from_numpy(jax_fields(jlp), device="cpu", dtype=F64)
    jit = JF.Iterate(**{k: jspace(v) for k, v in it.items()})
    tit = bridge.iterate_from_numpy(it, device="cpu", dtype=F64)
    return tlp, jit, tit


@pytest.mark.parametrize("case", sorted(BICG_CASES))
def test_solve_reduced_bicgstab_matches_jax(case):
    seed, dims, fd, iters, tol = BICG_CASES[case]
    jlp = jax_lp(seed, **dims)
    tlp, jit, tit = _both(jlp, seed + 3)

    @jax.jit        # one compile instead of one per operation
    def jax_side(lp, it):
        be = jab.ArrowBackend(lp, factor_dtype=jnp.dtype(fd))
        return be.solve_reduced_bicgstab(*_direction_setup(JF, be, it),
                                         max_iters=iters, tol=tol)

    *jd, jst = jax_side(jlp, jit)
    tbe = ArrowBackend(tlp, factor_dtype=getattr(torch, fd))
    *td, tst = tbe.solve_reduced_bicgstab(*_direction_setup(TF, tbe, tit),
                                          max_iters=iters, tol=tol)
    jst, tst = _stats(jst), _stats(tst)
    assert tst["converged"] and jst["converged"], (tst, jst)
    assert (tst["iterations"], tst["flag"]) == (jst["iterations"],
                                                jst["flag"])
    if fd == "float32":
        assert tst["iterations"] >= 1      # the inexact factors iterate
    for g, w in zip(np_tree(td), np_tree(jd)):
        for part in w:
            normwise_close(g[part], w[part], 1e-10)


# ---- 3. sc_precond ---------------------------------------------------------
def _spd_spread(n, seed, decay=0.05):
    """Diag-dominant SPD with a spread of off-diagonal magnitudes (the
    JAX package's tests/test_sc_precond.py::_random_spd), made slightly
    unsymmetric as an assembled Schur complement is."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) * decay
    A = A @ A.T + np.diag(np.abs(rng.normal(size=n)) + n * decay ** 2 + 1)
    return A + 1e-12 * rng.normal(size=(n, n))


@pytest.mark.parametrize("n,pb,t", [(20, 8, 0.01), (24, 8, 0.01),
                                    (76, 16, 0.001)])
def test_sparsified_panels_match_jax(n, pb, t):
    S = _spd_spread(n, n)
    jp, jdrop = jsc.sparsified_panels(jnp.asarray(S), pb, t)
    tp, tdrop = tsc.sparsified_panels(_t(S), pb, t)
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_allclose(_np(tdrop), float(jdrop), rtol=0, atol=1e-15)
    assert 0.0 < float(tdrop) < 1.0


def test_block_jacobi_matches_jax():
    S = _spd_spread(20, 2)
    r = np.random.default_rng(3).normal(size=20)
    jP, _ = jsc.block_jacobi_factors(jnp.asarray(S), 8, 1e-3)
    tP, ok, _ = tsc.block_jacobi_factors(_t(S), 8, 1e-3)
    assert bool(ok) and tP.shape == (3, 8, 8)
    normwise_close(_np(tP), np.asarray(jP), 1e-14)
    normwise_close(_np(tsc.block_jacobi_apply(tP, _t(r))),
                   np.asarray(jsc.block_jacobi_apply(jP, jnp.asarray(r))),
                   1e-13)


def test_sparsifier_ladder_matches_jax():
    j, t = jsc.SCsparsifier(), tsc.SCsparsifier()
    moves = ["increase"] + ["decrease"] * 7 + ["increase"] * 3
    for m in moves:
        name = f"{m}_diag_dom_bound"
        assert getattr(t, name)() == getattr(j, name)()
        assert (t.position, t.diag_dom_bound, t.diag_dom_bound_leaf) == \
            (j.position, j.diag_dom_bound, j.diag_dom_bound_leaf)
    assert tsc.DIAG_DOM_BOUNDS == jsc.DIAG_DOM_BOUNDS
    assert tsc.DIAG_DOM_BOUNDS_LEAF == jsc.DIAG_DOM_BOUNDS_LEAF


# ---- 4. the iterative root --------------------------------------------------
def test_iterative_root_matches_jax():
    """The instance of tests/test_sc_precond.py:96-97 (nD = 76, panel
    16): the factors and one root solve."""
    jlp = jax_lp(3, N=6, n=10, mE=4, mI=4, n0=6, m0E=3, m0I=3, mEl=35,
                 mIl=35)
    tlp, jit, tit = _both(jlp, 11)
    kw = dict(iterative_root=16, it_root_tol=1e-12, it_root_maxiter=300)
    rng = np.random.default_rng(5)
    p, q = rng.normal(size=tlp.n0), rng.normal(size=76)

    @jax.jit
    def jax_side(lp, it, p, q):
        be = jab.ArrowBackend(lp, **kw)
        fac = be.factorize(*JF.kkt_diagonals(be, it), 1e-8, 1e-8)
        return fac, be._root_solve(fac, p, q)

    jfac, (ja, jd) = jax_side(jlp, jit, jnp.asarray(p), jnp.asarray(q))
    tbe = ArrowBackend(tlp, **kw)
    tfac = tbe.factorize(*TF.kkt_diagonals(tbe, tit), 1e-8, 1e-8)
    assert bool(tfac.ok) and bool(jfac.ok)
    assert tfac.chol2 is None and tfac.Sinv is None
    assert tfac.Pchol.shape == (5, 16, 16)
    for name in ("chol1", "T", "Sd", "Pchol"):
        normwise_close(_np(getattr(tfac, name)),
                       np.asarray(getattr(jfac, name)), 1e-12)
    ta, td = tbe._root_solve(tfac, _t(p), _t(q))
    normwise_close(_np(ta), np.asarray(ja), 1e-12)
    normwise_close(_np(td), np.asarray(jd), 1e-12)


# ---- 5. the blockwise Schur complement -------------------------------------
@pytest.mark.parametrize("chunk", [2, 3])
def test_contrib_blockwise_matches_jax_and_cache(chunk):
    """The instance of tests/test_mixed_precision.py:93-94."""
    jlp = jax_lp(6, N=4, n=6, mE=3, mI=4, n0=3, m0E=2, m0I=2, mEl=4,
                 mIl=3)
    tlp, jit, tit = _both(jlp, 7)

    @jax.jit
    def jax_side(lp, it):
        be = jab.ArrowBackend(lp, blockwise_sc=chunk)
        Dx, Om = JF.kkt_diagonals(be, it)
        contrib = be.leaf_factorize(Dx.blocks, Om.blocks, 1e-8, 1e-8)[6]
        return contrib, be.solve_reduced(*_direction_setup(JF, be, it), 2)

    jcontrib, jsol = jax_side(jlp, jit)
    tbe = ArrowBackend(tlp, blockwise_sc=chunk)
    tDx, tOm = TF.kkt_diagonals(tbe, tit)
    tout = tbe.leaf_factorize(tDx.blocks, tOm.blocks, 1e-8, 1e-8)
    assert tout[4] is None and tout[5] is None       # no Ux, no Um
    cached = ArrowBackend(tlp).leaf_factorize(tDx.blocks, tOm.blocks, 1e-8,
                                              1e-8)[6]
    normwise_close(_np(tout[6]), np.asarray(jcontrib), 1e-12)
    normwise_close(_np(tout[6]), _np(cached), 1e-12)
    # the blockwise Ltsolve (one more leaf solve) against the JAX package
    tfac, trhs = _direction_setup(TF, tbe, tit)
    assert tfac.Ux is None and tfac.Um is None
    for g, w in zip(np_tree(tbe.solve_reduced(tfac, trhs, 2)),
                    np_tree(jsol)):
        for part in w:
            normwise_close(g[part], w[part], 1e-10)


# ---- 6. IPM parity, host loop, fused loop and facade ------------------------
# One linking-heavy LP (the instance of tests/test_sc_precond.py:113,
# nD = 28) through each mode, the options read from a reference .opt file
# (the mode's reference name, then the parameters by their field names).
# Both packages run through their facades (no presolve, no scaling: each
# its IPMSolver's host loop over ArrowBackend with the options' backend
# arguments), so that one JAX compile serves the IPM and the facade
# parity.  BiCGStab's tolerance is tightened so that its loop runs trips
# after the direct solve.
IPM_DIMS = dict(N=4, n=8, mE=3, mI=3, n0=4, m0E=2, m0I=2, mEl=12, mIl=12)
IPM_MODES = {
    "bicgstab": "OUTER_SOLVE 2 int\nOUTER_BICG_TOL 1e-14 double\n",
    "precond": ("PRECONDITION_SPARSE 1 bool\nITERATIVE_ROOT_PANEL 16 int\n"
                "IT_ROOT_TOL 1e-12 double\nREFINEMENT_STEPS 2 int\n"),
    "blockwise": "SC_COMPUTE_BLOCKWISE 1 bool\nSC_BLOCKWISE 5 int\n",
}


@contextlib.contextmanager
def _jax_bicgstab_trips():
    """Record the JAX package's BiCGStab trips per solve, by wrapping (not
    editing) its method with a debug callback."""
    trips = []
    orig = jab.ArrowBackend.solve_reduced_bicgstab

    def wrapped(self, *a, **kw):
        out = orig(self, *a, **kw)
        jax.debug.callback(lambda k: trips.append(int(k)),
                           out[3]["iterations"])
        return out

    jab.ArrowBackend.solve_reduced_bicgstab = wrapped
    try:
        yield trips
    finally:
        jab.ArrowBackend.solve_reduced_bicgstab = orig


def _mus(res):
    return np.array([h.mu for h in res.history])


@pytest.fixture(scope="module", params=sorted(IPM_MODES))
def ipm_runs(request, tmp_path_factory):
    from pips_ipmpp_tpu.core.options import Options as JO

    path = tmp_path_factory.mktemp("opt") / f"{request.param}.opt"
    path.write_text(IPM_MODES[request.param]
                    + "GONDZIO_MAX_CORRECTORS 1 int\n")
    jopts, opts = JO.from_opt_file(str(path)), Options.from_opt_file(
        str(path))
    jlp = jax_lp(4, **IPM_DIMS)
    with _jax_bicgstab_trips() as jtrips:
        jface = PIPSIPMppTPUInterface(jlp, jopts)
        jface.run()
    # the port's facade runs its host loop (`IPMSolver.solve`) over the
    # backend it builds from the options; the fused loop runs on the same
    # solver
    tface = PIPSIPMppTorchInterface(
        bridge.lp_from_numpy(jax_fields(jlp), device="cpu", dtype=F64),
        opts, device="cpu")
    tab.SOLVE_RECORD = []
    try:
        tface.run()
        record = tab.SOLVE_RECORD
    finally:
        tab.SOLVE_RECORD = None
    fused = tface._solver.solve_fused(tface.lp)
    return dict(mode=request.param, opts=opts, jopts=jopts,
                jres=jface.result, jface=jface, host=tface.result,
                fused=fused, tface=tface, jtrips=sorted(jtrips),
                record=record)


def test_ipm_mode_matches_jax(ipm_runs):
    r = ipm_runs
    jres, host = r["jres"], r["host"]
    assert host.status.name == jres.status.name == "SUCCESSFUL_TERMINATION"
    assert host.iterations == jres.iterations
    np.testing.assert_allclose(_mus(host), _mus(jres), rtol=1e-10)
    np.testing.assert_allclose(host.objective, jres.objective, rtol=1e-10)
    kinds = {k for k, _ in r["record"]}
    if r["mode"] == "bicgstab":
        trips = sorted(int(v["iterations"]) for k, v in r["record"]
                       if k == "bicgstab")
        assert trips == r["jtrips"] and sum(trips) > 0
    else:
        assert not r["jtrips"] and "bicgstab" not in kinds
    assert ("cg" in kinds and "panels" in kinds) == (r["mode"] == "precond")


def test_ipm_mode_fused_matches_host(ipm_runs):
    host, fused = ipm_runs["host"], ipm_runs["fused"]
    assert fused.info["graph"] is False            # the CPU runs it eagerly
    assert (fused.status, fused.iterations) == (host.status,
                                                host.iterations)
    np.testing.assert_array_equal(_mus(fused), _mus(host))
    assert fused.objective == host.objective


def test_opt_file_mode_matches_jax_facade(ipm_runs):
    """The reference's name reaches the backend in both facades, and the
    port's facade takes the JAX facade's iterations and objective."""
    r = ipm_runs
    opts, jopts = r["opts"], r["jopts"]
    for name in ("outer_bicgstab", "sc_blockwise", "iterative_root_panel",
                 "it_root_tol", "outer_bicg_tol", "refinement_steps"):
        assert getattr(opts, name) == getattr(jopts, name), name
    be = r["tface"]._solver.be_ctor(r["tface"].lp)
    assert (be.blockwise_sc, be.iterative_root) == (
        opts.sc_blockwise, opts.iterative_root_panel)
    assert (opts.outer_bicgstab, opts.iterative_root_panel > 0,
            opts.sc_blockwise > 0) == tuple(
        m == r["mode"] for m in ("bicgstab", "precond", "blockwise"))
    tface, jface = r["tface"], r["jface"]
    assert tface.result.status.name == "SUCCESSFUL_TERMINATION"
    assert tface.n_iterations == jface.n_iterations
    np.testing.assert_allclose(tface.getObjective(), jface.getObjective(),
                               rtol=1e-8)


# ---- 7. troubles_hook -------------------------------------------------------
def test_troubles_hook_contract():
    """tests/test_sc_precond.py:123-170 on the port: a healthy solve with
    the hook installed; a backend whose factorization always fails is
    relaxed by the hook, once the ladder (no retries) is used up."""
    lp = random_arrowhead_lp(5, N=4, n=8, mE=3, mI=3, n0=4, m0E=2, m0I=2,
                             mEl=8, mIl=8)
    sp = tsc.SCsparsifier()
    calls = []

    def hook():
        if not sp.decrease_diag_dom_bound():
            return None
        calls.append(sp.diag_dom_bound)
        return partial(ArrowBackend, iterative_root=16,
                       sc_diag_dom_bound=sp.diag_dom_bound)

    opts = Options(refinement_steps=2, max_regularization_retries=0)
    res = IPMSolver(partial(ArrowBackend, iterative_root=16,
                            sc_diag_dom_bound=sp.diag_dom_bound), opts,
                    device="cpu", troubles_hook=hook).solve(lp)
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert not calls                       # healthy: never consulted

    class Broken(ArrowBackend):
        def factorization_ok(self, fac):
            return torch.zeros((), dtype=torch.bool)

    fixed = []

    def fixing_hook():
        fixed.append(True)
        return partial(ArrowBackend, iterative_root=16)

    s2 = IPMSolver(partial(Broken, iterative_root=16), opts, device="cpu",
                   troubles_hook=fixing_hook)
    res2 = s2.solve(lp)
    assert fixed == [True]
    assert res2.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(res2.objective - res.objective) < 1e-7
    # without a hook the broken backend ends the solve
    res3 = IPMSolver(partial(Broken, iterative_root=16), opts,
                     device="cpu").solve(lp)
    assert res3.status == TerminationStatus.UNKNOWN


# ---- 8. the facade ---------------------------------------------------------
@pytest.mark.parametrize("name", ["hierarchical", "banded_leaf",
                                  "banded_root"])
def test_facade_still_refuses(name):
    """The banded modes are not ported; the hierarchy is, and refuses a
    banded mode beside it with the JAX facade's ValueError."""
    lp = random_arrowhead_lp(0, N=2, n=3, mE=1, mI=1, n0=2, m0E=1, m0I=1,
                             mEl=1, mIl=1)
    if name == "hierarchical":
        with pytest.raises(ValueError, match="exclusive with hierarchical"):
            PIPSIPMppTorchInterface(lp, Options(hierarchical=True,
                                                banded_root=True),
                                    device="cpu")
        return
    with pytest.raises(NotImplementedError, match=name):
        PIPSIPMppTorchInterface(lp, Options(**{name: True}), device="cpu")


MODE_OPTIONS = {"outer_bicgstab": dict(outer_bicgstab=True),
                "sc_blockwise": dict(sc_blockwise=64),
                "iterative_root_panel": dict(iterative_root_panel=64)}


@pytest.mark.parametrize("mode", sorted(MODE_OPTIONS))
def test_batch_and_sparse_backend_refuse_modes(mode):
    """The fused batch and the sparse backend under each mode raise and
    name their ROADMAP.md items."""
    opts = Options(**MODE_OPTIONS[mode])
    lps = [random_arrowhead_lp(s, N=2, n=3, mE=1, mI=1, n0=2, m0E=1, m0I=1,
                               mEl=1, mIl=1) for s in (0, 1)]
    kw = dict(blockwise_sc=opts.sc_blockwise,
              iterative_root=opts.iterative_root_panel)
    with pytest.raises(NotImplementedError, match="the fused batch under the solve modes"):
        IPMSolver(partial(ArrowBackend, **kw), opts,
                  device="cpu").solve_fused_batch_async(lps)
    slp = random_sparse_arrowhead_lp(0, N=2, n=16, mE=8, mI=8,
                                     nnz_per_row=3, n0=2, m0E=1, m0I=1,
                                     mEl=1, mIl=1)
    with pytest.raises(NotImplementedError, match="the sparse backend under the solve modes"):
        PIPSIPMppTorchInterface(slp, opts.replace(sparse_densify_max_mb=0),
                                device="cpu")
    if mode == "outer_bicgstab":
        be = SparseArrowBackend(slp)
        with pytest.raises(NotImplementedError, match="the sparse backend under the solve modes"):
            be.solve_reduced_bicgstab(None, None)
    elif mode == "iterative_root_panel":
        with pytest.raises(NotImplementedError, match="the sparse backend under the solve modes"):
            SparseArrowBackend(slp, iterative_root=64)


def jax_energy_mode(mode: str, T: int = 12) -> dict:
    """The JAX package's facade on the energy LP with one solve mode;
    the trip counts are read by wrapping (not editing) its BiCGStab and
    CG entry points with a debug callback."""
    import time

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pips_ipmpp_tpu.core.lp import make_arrowhead_lp
    from pips_ipmpp_tpu.core.options import PresolverType, ScalerType
    from pips_ipmpp_tpu.io.energy import dispatch_blocks

    trips = dict(bicgstab=[], bicgstab_converged=[], cg=[], dropped=[])

    def record(key):
        def cb(v):
            trips[key].append(v.item())
        return cb

    bicg = jab.ArrowBackend.solve_reduced_bicgstab

    def solve_reduced_bicgstab(self, *a, **kw):
        out = bicg(self, *a, **kw)
        jax.debug.callback(record("bicgstab"), out[3]["iterations"])
        jax.debug.callback(record("bicgstab_converged"),
                           out[3]["converged"])
        return out

    pcg = jab.preconditioned_cg

    def preconditioned_cg(*a, **kw):
        u, stats = pcg(*a, **kw)
        jax.debug.callback(record("cg"), stats["iterations"])
        return u, stats

    bjf = jsc.block_jacobi_factors

    def block_jacobi_factors(*a, **kw):
        P, dropped = bjf(*a, **kw)
        jax.debug.callback(record("dropped"), dropped)
        return P, dropped

    jab.ArrowBackend.solve_reduced_bicgstab = solve_reduced_bicgstab
    jab.preconditioned_cg = preconditioned_cg
    jsc.block_jacobi_factors = block_jacobi_factors

    extra = dict(bicgstab=dict(outer_bicgstab=True),
                 precond=dict(iterative_root_panel=64),
                 blockwise=dict(sc_blockwise=64))[mode]
    blocks, first, leq, liq, _ = dispatch_blocks(T=T, R=150, G=550, L=350,
                                                 S=4, seed=5)
    lp = make_arrowhead_lp(blocks, first, leq, liq)
    opts = JOptions(scaler=ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM,
                    presolve=PresolverType.PRESOLVE, max_iterations=300,
                    max_gondzio_correctors=1, refinement_steps=2,
                    factor_dtype="float64", print_level=10, **extra)
    t0 = time.perf_counter()
    iface = PIPSIPMppTPUInterface(lp, opts)
    status = iface.run()
    out = dict(mode=mode, T=T, status=status.name,
               iterations=iface.n_iterations,
               solver_objective=float(iface.result.objective),
               mu=float(iface.result.mu), solve_s=time.perf_counter() - t0)
    _trip_counts(out, trips)
    # the solve's line first: the JAX package's gathers run its whole
    # postsolve, whose dual transfer takes long at this size
    print(json.dumps(out), flush=True)
    x = iface.gatherPrimalSolution()
    out.update(objective=iface.getObjective(),
               eq_resid=float(np.max(np.abs(iface.gatherPrimalResidsEQ()))),
               finite=bool(np.all(np.isfinite(x))),
               seconds=time.perf_counter() - t0)
    return out


def _trip_counts(out, trips):
    """Sum, maximum and failures of the recorded trips, into `out`."""
    if trips["bicgstab"]:
        b = trips["bicgstab"]
        out.update(bicgstab_solves=len(b), bicgstab_trips=sum(b),
                   bicgstab_max=max(b),
                   bicgstab_unconverged=trips["bicgstab_converged"].count(
                       False))
    if trips["cg"]:
        c = trips["cg"]
        out.update(cg_solves=len(c), cg_trips=sum(c), cg_max=max(c),
                   dropped_min=min(trips["dropped"]),
                   dropped_max=max(trips["dropped"]))


def f32_bicgstab_counts(seeds) -> list:
    """IPM iterations with f32 factors, direct and under outer BiCGStab,
    in both packages (the JAX LDL kernel in Pallas interpret mode), on
    random LPs of one small shape: f32 counts turn on rounding."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    dims = dict(N=4, n=32, mE=16, mI=16, n0=8, m0E=4, m0I=4, mEl=4, mIl=4)
    rows = []
    for seed in seeds:
        jlp = jax_lp(seed, **dims)
        tlp = bridge.lp_from_numpy(jax_fields(jlp), device="cpu", dtype=F64)
        for bicg in (False, True):
            o = dict(outer_bicgstab=bicg, max_gondzio_correctors=1)
            jr = JSolver(partial(jab.ArrowBackend, factor_dtype=jnp.float32),
                         JOptions(**o)).solve(jlp)
            tr = IPMSolver(partial(ArrowBackend, factor_dtype=torch.float32),
                           Options(**o), device="cpu").solve(tlp)
            rows.append(dict(seed=seed, outer_bicgstab=bicg,
                             jax=(jr.status.name, jr.iterations),
                             port=(tr.status.name, tr.iterations)))
            print(json.dumps(rows[-1]), flush=True)
    return rows


# the JAX tests' own instances of two modes: (seed, dims, backend
# arguments of the mode, options of the mode, options of both)
MU_INSTANCES = {
    "test_bicgstab": (0, dict(N=4), {}, dict(outer_bicgstab=True), {}),
    "test_sc_precond": (3, dict(N=6, n=10, mE=4, mI=4, n0=6, m0E=3, m0I=3,
                                mEl=35, mIl=35),
                        dict(iterative_root=16, it_root_tol=1e-12,
                             it_root_maxiter=300), {},
                        dict(refinement_steps=2)),
}


def mu_parity(instance: str, with_mode: bool) -> dict:
    """Both packages' host loops on one of the JAX tests' instances, with
    its mode or with the default path: iterations and the largest
    relative difference of mu per iteration."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    seed, dims, bkw, mode_opts, opts = MU_INSTANCES[instance]
    if with_mode:
        opts = dict(opts, **mode_opts)
    else:
        bkw = {}
    jlp = jax_lp(seed, **dims)
    jres = JSolver(partial(jab.ArrowBackend, **bkw),
                   JOptions(**opts)).solve(jlp)
    tres = IPMSolver(partial(ArrowBackend, **bkw), Options(**opts),
                     device="cpu").solve(bridge.lp_from_numpy(
                         jax_fields(jlp), device="cpu", dtype=F64))
    jm, tm = _mus(jres), _mus(tres)
    n = min(len(jm), len(tm))
    return dict(instance=instance, mode=with_mode,
                iterations=(jres.iterations, tres.iterations),
                mu_max_rel=float(np.max(np.abs(tm[:n] - jm[:n])
                                        / np.abs(jm[:n]))))


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "energy":
        print(json.dumps(jax_energy_mode(
            sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 12)))
    elif len(sys.argv) >= 3 and sys.argv[1] == "f32":
        f32_bicgstab_counts([int(v) for v in sys.argv[2:]])
    elif len(sys.argv) == 4 and sys.argv[1] == "mu":
        print(json.dumps(mu_parity(sys.argv[2], sys.argv[3] == "mode")))
    else:
        sys.exit(__doc__)
