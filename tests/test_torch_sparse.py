"""The PyTorch sparse leaf path — ELL storage and builders, the sparse
generator, the equilibrium scaler on ELL blocks, the CG-leaf
SparseArrowBackend, the facade's densify routing — against the JAX
package's ELL path (tiles None) on the same numpy data."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu.core import csr as jcsr
from pips_ipmpp_tpu.core import sparse as jsparse
from pips_ipmpp_tpu.io.synthetic import \
    random_sparse_arrowhead_lp as jax_sparse_lp
from pips_ipmpp_tpu.ipm import formulation as JF
from pips_ipmpp_tpu_torch import Options, PIPSIPMppTorchInterface, bridge
from pips_ipmpp_tpu_torch.core import csr, sparse
from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP
from pips_ipmpp_tpu_torch.core.options import ScalerType
from pips_ipmpp_tpu_torch.io.synthetic import random_sparse_arrowhead_lp
from pips_ipmpp_tpu_torch.ipm import formulation as TF
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu_torch.linalg.sparse_backend import SparseArrowBackend
from torch_parity import (jax_sparse_fields, jspace, normwise_close, np_tree,
                          random_iterate)

# the slice's LP: 3 blocks of 96 columns at 5 nonzeros per row
SEED = 5
DIMS = dict(N=3, n=96, mE=48, mI=48, nnz_per_row=5, n0=6, m0E=2, m0I=2,
            mEl=2, mIl=2)


def _np_sparse(lp) -> dict:
    """Port SparseArrowheadLP -> {field: array or {val, col}}."""
    out = {}
    for f in dataclasses.fields(lp):
        v = getattr(lp, f.name)
        out[f.name] = ({"val": v.val.numpy(), "col": v.col.numpy()}
                       if isinstance(v, sparse.Ell) else v.numpy())
    return out


def _assert_same_fields(got: dict, want: dict, rtol=None):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        pairs = ([(g["val"], w["val"], name + ".val"),
                  (g["col"], w["col"], name + ".col")]
                 if isinstance(w, dict) else [(g, w, name)])
        for a, b, label in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, label
            if rtol is None or a.dtype == np.int32:
                np.testing.assert_array_equal(a, b, err_msg=label)
            else:
                np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0,
                                           err_msg=label)


@pytest.mark.parametrize("seed,dims", [
    (SEED, DIMS),
    (1, dict(N=2, n=64, mE=40, mI=24, nnz_per_row=7, n0=4, m0E=1, m0I=3,
             mEl=1, mIl=3)),
])
def test_generator_is_bit_identical(seed, dims):
    want = jax_sparse_fields(jax_sparse_lp(seed, **dims))
    got = random_sparse_arrowhead_lp(seed, **dims)
    assert got.B.col.dtype == torch.int32 and got.Dt.col.dtype == torch.int32
    _assert_same_fields(_np_sparse(got), want)


def test_ell_builders_match_jax():
    rng = np.random.default_rng(2)
    N, m, n = 2, 7, 9
    rows = [rng.integers(0, m, 20) for _ in range(N)]
    cols = [rng.integers(0, n, 20) for _ in range(N)]   # duplicates sum
    vals = [rng.normal(size=20) for _ in range(N)]
    je = jsparse.ell_from_triplets(rows, cols, vals, m, n)
    te = sparse.ell_from_triplets(rows, cols, vals, m, n)
    np.testing.assert_array_equal(te.val.numpy(), np.asarray(je.val))
    np.testing.assert_array_equal(te.col.numpy(), np.asarray(je.col))
    jt, tt = jsparse.ell_transpose(je, n), sparse.ell_transpose(te, n)
    np.testing.assert_array_equal(tt.val.numpy(), np.asarray(jt.val))
    np.testing.assert_array_equal(tt.col.numpy(), np.asarray(jt.col))
    dense = sparse.ell_to_dense(te, n).numpy()
    np.testing.assert_allclose(dense, np.asarray(jsparse.ell_to_dense(je, n)),
                               rtol=1e-15)
    back = sparse.ell_from_dense(dense)
    np.testing.assert_array_equal(back.col.numpy(),
                                  np.asarray(jsparse.ell_from_dense(dense).col))
    with pytest.raises(ValueError):
        sparse.ell_from_triplets(rows, cols, vals, m, n - 1)


def test_ell_astype_and_to_keep_int_columns():
    lp = random_sparse_arrowhead_lp(0, N=2, n=16, mE=8, mI=8, nnz_per_row=3,
                                    n0=2, m0E=1, m0I=1, mEl=1, mIl=1)
    s32 = lp.astype(torch.float32).to("cpu")
    assert s32.B.col.dtype == torch.int32 and s32.B.val.dtype == torch.float32
    assert s32.cN.dtype == torch.float32 and s32.Bt.col.dtype == torch.int32
    np.testing.assert_allclose(float(lp.datanorm()),
                               float(jax_sparse_lp(0, N=2, n=16, mE=8, mI=8,
                                                   nnz_per_row=3, n0=2,
                                                   m0E=1, m0I=1, mEl=1,
                                                   mIl=1).datanorm()),
                               rtol=1e-15)


def test_dense_round_trip_matches_jax():
    jlp = jax_sparse_lp(SEED, **DIMS)
    tlp = random_sparse_arrowhead_lp(SEED, **DIMS)
    assert sparse.dense_bytes(tlp) == jsparse.dense_bytes(jlp)
    jd, td = jsparse.dense_from_sparse(jlp), sparse.dense_from_sparse(tlp)
    assert isinstance(td, ArrowheadLP)
    for name in ("B", "D", "A", "F", "cN"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)),
                                      err_msg=name)
    _assert_same_fields(_np_sparse(sparse.sparse_from_dense(td)),
                        jax_sparse_fields(jsparse.sparse_from_dense(jd)))


def _csr_blocks(rng, sizes):
    """Heterogeneous per-block dicts with CSR diagonals (padding runs)."""
    blocks = []
    for n, mE, mI in sizes:
        Bd = rng.normal(size=(mE, n)) * (rng.random((mE, n)) < 0.3)
        Bd[np.arange(mE), np.arange(mE) % n] = 1.0
        Dd = rng.normal(size=(mI, n)) * (rng.random((mI, n)) < 0.3)
        blocks.append(dict(
            c=rng.normal(size=n), A=rng.normal(size=(mE, 2)), B=Bd,
            b=rng.normal(size=mE), C=rng.normal(size=(mI, 2)), D=Dd,
            iclow=np.ones(mI), clow=-np.ones(mI), icupp=np.ones(mI),
            cupp=np.ones(mI), ixlow=np.ones(n), xlow=-np.ones(n),
            ixupp=np.ones(n), xupp=np.ones(n),
            F=rng.normal(size=(1, n)), G=rng.normal(size=(1, n))))
    first = dict(c=rng.normal(size=2), A=rng.normal(size=(1, 2)),
                 b=rng.normal(size=1), C=rng.normal(size=(1, 2)),
                 iclow=np.ones(1), clow=-np.ones(1), icupp=np.zeros(1),
                 cupp=np.zeros(1), ixlow=np.ones(2), xlow=-np.ones(2),
                 ixupp=np.ones(2), xupp=np.ones(2),
                 F0=rng.normal(size=(1, 2)), G0=rng.normal(size=(1, 2)))
    return blocks, first


def test_make_sparse_arrowhead_lp_matches_jax():
    blocks, first = _csr_blocks(np.random.default_rng(3),
                                [(6, 3, 2), (8, 4, 3)])
    link_eq = {"b": np.array([0.5])}
    link_in = {"iclow": np.ones(1), "clow": -np.ones(1),
               "icupp": np.ones(1), "cupp": np.ones(1)}

    def with_csr(mod):
        out = []
        for b in blocks:
            b = dict(b)
            b["B"] = mod.CsrMatrix.from_dense(b["B"])
            b["D"] = mod.CsrMatrix.from_dense(b["D"])
            out.append(b)
        return out

    jlp = jsparse.make_sparse_arrowhead_lp(with_csr(jcsr), first, link_eq,
                                           link_in)
    tlp = sparse.make_sparse_arrowhead_lp(with_csr(csr), first, link_eq,
                                          link_in)
    _assert_same_fields(_np_sparse(tlp), jax_sparse_fields(jlp))
    # the CSR copy itself: triplets and ELL rows as the JAX package's
    M = np.random.default_rng(4).normal(size=(5, 7))
    M[M < 0.3] = 0.0
    jc, tc = jcsr.CsrMatrix.from_dense(M), csr.CsrMatrix.from_dense(M)
    for a, b in zip(tc.to_triplets(), jc.to_triplets()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tc.to_dense(), M)


def test_bridge_round_trip():
    jlp = jax_sparse_lp(SEED, **DIMS)
    tlp = bridge.sparse_lp_from_numpy(jax_sparse_fields(jlp), device="cpu",
                                      dtype=torch.float64)
    _assert_same_fields(_np_sparse(tlp), jax_sparse_fields(jlp))
    with pytest.raises(ValueError):
        bridge.sparse_lp_from_numpy({"c0": np.zeros(1)}, device="cpu",
                                    dtype=torch.float64)


def test_equilibrium_scaler_on_sparse_matches_jax():
    from pips_ipmpp_tpu.core.options import ScalerType as JScalerType
    from pips_ipmpp_tpu.scale import make_scaler as jax_make_scaler

    from pips_ipmpp_tpu_torch.scale import make_scaler

    jlp = jax_sparse_lp(SEED, **DIMS)
    tlp = random_sparse_arrowhead_lp(SEED, **DIMS)
    jsc = jax_make_scaler(JScalerType.EQUILIBRIUM)
    tsc = make_scaler(ScalerType.EQUILIBRIUM)
    js, ts = jsc.scale(jlp), tsc.scale(tlp)
    assert isinstance(ts, sparse.SparseArrowheadLP)
    _assert_same_fields(_np_sparse(ts), jax_sparse_fields(js), rtol=1e-12)
    for name in ("s", "rE", "rC"):
        want = np_tree(getattr(jsc, name))
        got = np_tree(getattr(tsc, name))
        for part in want:
            np.testing.assert_allclose(got[part], want[part], rtol=1e-12)


@pytest.fixture(scope="module")
def backends():
    from pips_ipmpp_tpu.linalg.sparse_backend import \
        SparseArrowBackend as JSparse

    jlp = jax_sparse_lp(SEED, **DIMS)
    tlp = random_sparse_arrowhead_lp(SEED, **DIMS)
    return JSparse(jlp, cg_iters=300), SparseArrowBackend(tlp, cg_iters=300)


def test_products_match_jax(backends):
    jbe, tbe = backends
    rng = np.random.default_rng(6)
    it = random_iterate(rng, jbe.lp, False)
    for op, arg in (("Ax", "x"), ("ATy", "y"), ("Cx", "x"), ("CTz", "z")):
        want = np_tree(getattr(jbe, op)(jspace(it[arg])))
        got = np_tree(getattr(tbe, op)(bridge.space_from_numpy(
            it[arg], device="cpu", dtype=torch.float64)))
        for part in want:
            normwise_close(got[part], want[part], 1e-13)


def _solve(F, be, it, d, sigma_mu, delta, steps):
    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, delta, delta)
    comp = F.comp_rhs_corrector(be, it, d, sigma_mu)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    return fac, be.solve_reduced(fac, rhs, steps)


def test_factorize_and_solve_match_jax(backends):
    jbe, tbe = backends
    rng = np.random.default_rng(7)
    it = random_iterate(rng, jbe.lp, True)
    d = random_iterate(rng, jbe.lp, False)
    # one jitted call: the JAX package runs its steps so, and eager CG
    # would compile op by op
    jfac, jsol = jax.jit(lambda a, b: _solve(JF, jbe, a, b, 0.3, 1e-8, 1))(
        JF.Iterate(**{k: jspace(v) for k, v in it.items()}),
        JF.Iterate(**{k: jspace(v) for k, v in d.items()}))
    tfac, tsol = _solve(TF, tbe,
                        bridge.iterate_from_numpy(it, device="cpu",
                                                  dtype=torch.float64),
                        bridge.iterate_from_numpy(d, device="cpu",
                                                  dtype=torch.float64),
                        torch.tensor(0.3, dtype=torch.float64), 1e-8, 1)
    assert bool(tfac.ok) and bool(jfac.ok)
    for g, w in zip(np_tree(tsol), np_tree(jsol)):
        for part in w:
            normwise_close(g[part], w[part], 1e-9)
    normwise_close(np_tree(tfac.Um), np_tree(jfac.Um), 1e-9)
    normwise_close(np_tree(tfac.Ux), np_tree(jfac.Ux), 1e-9)


def test_blockwise_sc_is_refused():
    lp = random_sparse_arrowhead_lp(0, N=2, n=16, mE=8, mI=8, nnz_per_row=3,
                                    n0=2, m0E=1, m0I=1, mEl=1, mIl=1)
    with pytest.raises(ValueError):
        SparseArrowBackend(lp, blockwise_sc=4)
    assert SparseArrowBackend(lp).cg_tol == 1e-12
    assert SparseArrowBackend(lp, factor_dtype=torch.float32).cg_tol == 1e-7


@pytest.mark.parametrize("max_iters", [3, 200], ids=["capped", "converged"])
def test_batched_pcg_matches_jax(max_iters):
    """The CG alone on a batch of SPD systems with a zero column: the same
    iterate and iteration count as the JAX package's while_loop, one
    read-back per stopping test and the cap counted."""
    from pips_ipmpp_tpu.linalg.sparse_backend import batched_pcg as jpcg
    from pips_ipmpp_tpu_torch.linalg.sparse_backend import batched_pcg

    rng = np.random.default_rng(11)
    M = rng.standard_normal((3, 20, 20))
    A = M @ np.swapaxes(M, 1, 2) / 20 + np.diag(rng.uniform(0.5, 2.0, 20))
    B = rng.standard_normal((3, 20, 4))
    B[1, :, 2] = 0.0
    dinv = 1.0 / np.diagonal(A, axis1=1, axis2=2)
    Xj, kj = jpcg(lambda V: jnp.asarray(A) @ V, jnp.asarray(B),
                  jnp.asarray(dinv), max_iters, 1e-12)
    At = torch.from_numpy(A)
    before = (batched_pcg.readbacks, batched_pcg.calls, batched_pcg.capped)
    Xt, kt = batched_pcg(lambda V: At @ V, torch.from_numpy(B),
                         torch.from_numpy(dinv), max_iters, 1e-12)
    assert kt == int(kj)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0.0,
                               atol=1e-12 * np.abs(np.asarray(Xj)).max())
    assert not Xt[1, :, 2].any()
    capped = kt == max_iters
    assert capped == (max_iters == 3)
    # one test per iteration, plus the final one unless the cap stopped it
    assert (batched_pcg.readbacks - before[0],
            batched_pcg.calls - before[1],
            batched_pcg.capped - before[2]) == (kt + (not capped), 1, capped)


@pytest.fixture(scope="module")
def slice_runs():
    """The slice as a whole: both IPMSolvers over their sparse backends,
    f64, default options."""
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
    from pips_ipmpp_tpu.linalg.sparse_backend import \
        SparseArrowBackend as JSparse

    jres = JIPMSolver(JSparse, JOptions(record_history=True)).solve(
        jax_sparse_lp(SEED, **DIMS))
    tres = IPMSolver(SparseArrowBackend, Options(record_history=True),
                     device="cpu").solve(random_sparse_arrowhead_lp(SEED,
                                                                    **DIMS))
    return jres, tres


def test_slice_matches_jax(slice_runs):
    jres, tres = slice_runs
    assert tres.status.name == jres.status.name == "SUCCESSFUL_TERMINATION"
    assert tres.iterations == jres.iterations
    np.testing.assert_allclose(tres.objective, float(jres.objective),
                               rtol=1e-9)


def test_slice_mu_history_matches_jax(slice_runs):
    jres, tres = slice_runs
    jmu = [h.mu for h in jres.history]
    tmu = [h.mu for h in tres.history]
    assert len(tmu) == len(jmu)
    # CG stopping can move by one CG step at the threshold
    np.testing.assert_allclose(tmu, jmu, rtol=1e-8)


CAPPED_CG_ITERS = 40


def test_capped_cg_slice_matches_jax(slice_runs):
    """The slice with the leaf CG capped at 40 iterations, so that about
    half of its calls stop at the cap (the regime of the 8 x 8192 f64
    solve on a card): both packages still take the same iterations, more
    than uncapped, with the same mu history and objective."""
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
    from pips_ipmpp_tpu.linalg.sparse_backend import \
        SparseArrowBackend as JSparse
    from pips_ipmpp_tpu_torch.linalg.sparse_backend import batched_pcg

    jres = JIPMSolver(partial(JSparse, cg_iters=CAPPED_CG_ITERS),
                      JOptions(record_history=True)).solve(
        jax_sparse_lp(SEED, **DIMS))
    before = (batched_pcg.calls, batched_pcg.capped)
    tres = IPMSolver(partial(SparseArrowBackend, cg_iters=CAPPED_CG_ITERS),
                     Options(record_history=True), device="cpu").solve(
        random_sparse_arrowhead_lp(SEED, **DIMS))
    calls = batched_pcg.calls - before[0]
    capped = batched_pcg.capped - before[1]
    assert 0.25 * calls <= capped < calls
    assert tres.status.name == jres.status.name == "SUCCESSFUL_TERMINATION"
    assert tres.iterations == jres.iterations > slice_runs[1].iterations
    np.testing.assert_allclose([h.mu for h in tres.history],
                               [h.mu for h in jres.history], rtol=1e-8)
    np.testing.assert_allclose(tres.objective, float(jres.objective),
                               rtol=1e-9)


@pytest.mark.parametrize("budget_mb,backend,rtol", [
    (1.0, ArrowBackend, 1e-6), (0.0, SparseArrowBackend, 1e-9)],
    ids=["densified", "ell_leaf"])
def test_facade_routing_matches_jax(slice_runs, budget_mb, backend, rtol):
    """Within the budget (the slice LP's dense twin is 0.21 MB) the facade
    densifies onto ArrowBackend, at 0 it keeps the ELL leaf, as the JAX
    facade does.  The JAX facade's solve with default options is the
    slice's JAX run; the densified route solves the same LP another way
    (tests/test_sparse.py holds the two routes to 1e-6)."""
    from pips_ipmpp_tpu.core.lp import ArrowheadLP as JArrowheadLP
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface

    jres, _ = slice_runs
    jif = PIPSIPMppTPUInterface(jax_sparse_lp(SEED, **DIMS),
                                JOptions(sparse_densify_max_mb=budget_mb))
    tif = PIPSIPMppTorchInterface(random_sparse_arrowhead_lp(SEED, **DIMS),
                                  Options(sparse_densify_max_mb=budget_mb),
                                  device="cpu")
    assert tif.backend_class is backend
    assert isinstance(tif.lp, ArrowheadLP) == isinstance(jif.lp,
                                                         JArrowheadLP)
    assert isinstance(tif.lp, ArrowheadLP) == (backend is ArrowBackend)
    assert tif.run().name == "SUCCESSFUL_TERMINATION"
    np.testing.assert_allclose(tif.getObjective(), float(jres.objective),
                               rtol=rtol)
    x = jres.iterate.x
    want = np.concatenate([np.asarray(x.first),
                           np.asarray(x.blocks).reshape(-1)])
    np.testing.assert_allclose(tif.gatherPrimalSolution(), want, rtol=0.0,
                               atol=1e-5 * np.abs(want).max())


def test_facade_sparse_f32_factors_take_the_cg_in_f32():
    lp = random_sparse_arrowhead_lp(SEED, **DIMS)
    iface = PIPSIPMppTorchInterface(
        lp, Options(sparse_densify_max_mb=0, factor_dtype="float32",
                    scaler=ScalerType.EQUILIBRIUM, reduced_accuracy=True,
                    refinement_steps=2, max_gondzio_correctors=1),
        device="cpu")
    be = iface._solver.be_ctor(lp)
    assert be._M.val.dtype == torch.float32 and be._B.val.dtype == \
        torch.float64
    assert iface.run().name == "SUCCESSFUL_TERMINATION"
    ref = IPMSolver(SparseArrowBackend, Options(), device="cpu").solve(lp)
    np.testing.assert_allclose(iface.getObjective(), ref.objective,
                               rtol=1e-3)
