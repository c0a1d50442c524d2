"""Parity of the port's problem intake with the JAX package's: the MPS
reader (the native tokenizer and the Python parser), `write_mps`, the
structure discovery (`dissect`, `auto_structure`, `refine_blocks`), the
callback tree and the GAMS reader.  The same inputs go through both
packages and every array must come out equal bit for bit; none of these
tests solves an LP."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from pips_ipmpp_tpu.core import dissect as jdissect
from pips_ipmpp_tpu.io import callbacks as jcallbacks
from pips_ipmpp_tpu.io import energy as jenergy
from pips_ipmpp_tpu.io import gams as jgams
from pips_ipmpp_tpu.io import mps as jmps
from pips_ipmpp_tpu_torch import DenseLP, bridge, native
from pips_ipmpp_tpu_torch.core import dissect
from pips_ipmpp_tpu_torch.io import callbacks, energy, gams, mps
from tests.test_dissect import banded_block, banded_sparse_lp
from tests.test_io import MPS_FIXED_SAMPLE, MPS_SAMPLE
from torch_parity import jax_fields, jax_sparse_fields

# ---- MPS --------------------------------------------------------------------
MPS_CASES = {
    "sample": (MPS_SAMPLE, "free"),
    "fixed_spaces_in_names": (MPS_FIXED_SAMPLE, "fixed"),
    "bounds_without_set_name": (MPS_SAMPLE.replace(
        " UP BND       X1           4.0", " UP X1 4.0").replace(
        " LO BND       X2          -1.0", " LO X2 -1.0"), "free"),
    "ranges_on_objective_row": (MPS_SAMPLE.replace(
        "BOUNDS", "RANGES\n    RNG       COST         1.0\nBOUNDS"), "free"),
    "objsense_max": (MPS_SAMPLE.replace(
        "ROWS", "OBJSENSE\n    MAX\nROWS"), "free"),
    # a ranged E row (negative range: [rhs + r, rhs]) and a ranged L row
    "ranged_rows": (MPS_SAMPLE.replace(
        "BOUNDS", "RANGES\n    RNG       MYEQN       -2.5   LIM1   1.5D0\n"
        "BOUNDS"), "free"),
}


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_lp_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = _host(getattr(got, f.name)), _host(getattr(want, f.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


def _read(reader, path, fmt, native_):
    """reader(...) -> (lp, info) and whether it warned of an invalid
    RANGES entry."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = reader(path, format=fmt, native=native_)
    return out, any("invalid" in str(r.message) for r in rec)


@pytest.mark.parametrize("case", list(MPS_CASES))
def test_mps_readers_match_jax(tmp_path, case):
    text, fmt = MPS_CASES[case]
    path = str(tmp_path / f"{case}.mps")
    with open(path, "w") as f:
        f.write(text)
    (want, want_info), want_warned = _read(jmps.read_mps_with_info, path,
                                           fmt, True)
    runs = [_read(mps.read_mps_with_info, path, fmt, True),
            _read(mps.read_mps_with_info, path, fmt, False),
            _read(jmps.read_mps_with_info, path, fmt, False)]
    for (lp, info), warned in runs:
        _assert_lp_equal(lp, want)
        assert dataclasses.asdict(info) == dataclasses.asdict(want_info)
        assert warned == want_warned == (case == "ranges_on_objective_row")
    assert isinstance(runs[0][0][0], DenseLP)
    assert runs[0][0][0].c.device.type == "cpu"


@pytest.mark.parametrize("native_", [True, False])
def test_mps_malformed_raises_in_both(tmp_path, native_):
    path = str(tmp_path / "bad.mps")
    with open(path, "w") as f:
        f.write(MPS_SAMPLE.replace("LIM2         1.0\n    RHS",
                                   "LIM2         1.x\n    RHS"))
    with pytest.raises(ValueError):
        jmps.read_mps(path, native=native_)
    with pytest.raises(ValueError):
        mps.read_mps(path, native=native_)


def test_mps_native_reader_does_not_fall_back(tmp_path, monkeypatch):
    """With the library unavailable, `native=True` raises with the build
    error; only `native=False` runs the Python parser."""
    path = str(tmp_path / "t.mps")
    with open(path, "w") as f:
        f.write(MPS_SAMPLE)
    monkeypatch.setattr(native, "build_error", "g++ failed: forced")
    with pytest.raises(RuntimeError, match="forced"):
        mps.read_mps(path)
    assert mps.read_mps(path, native=False).n == 3


# ---- write_mps --------------------------------------------------------------
def test_write_mps_is_byte_identical(tmp_path):
    kw = dict(T=4, R=3, G=5, L=3, S=1, seed=0)
    jargs = jenergy.dispatch_blocks(**kw)[:4]
    targs = energy.dispatch_blocks(**kw)[:4]
    jpath, tpath = str(tmp_path / "jax.mps"), str(tmp_path / "port.mps")
    jenergy.write_mps(jpath, *jargs)
    energy.write_mps(tpath, *targs)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    lp = mps.read_mps(tpath)
    c, A_eq, b_eq, A_ub, lb_ub, ub_ub, lo, hi = energy.to_scipy(*targs)
    assert np.array_equal(lp.c.numpy(), c)
    assert np.array_equal(lp.A.numpy(), A_eq.toarray())
    assert np.array_equal(lp.b.numpy(), b_eq)
    assert np.array_equal(lp.C.numpy(), A_ub.toarray())
    assert np.array_equal(lp.xlow.numpy()[lp.ixlow.numpy() > 0],
                          lo[np.isfinite(lo)])


# ---- structure discovery ----------------------------------------------------
def _port_dense(jlp) -> DenseLP:
    return bridge.lp_from_numpy(jax_fields(jlp), device="cpu",
                                dtype=torch.float64, cls=DenseLP)


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and np.array_equal(a, b), k


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 8), (2, 6)])
def test_dissect_matches_jax(seed, k):
    jlp = banded_sparse_lp(seed)
    lp = _port_dense(jlp)
    *want, wmap = jdissect.dissect(jlp, k)
    *got, dmap = dissect.dissect(lp, k)
    for g, w in zip(got[0], want[0]):
        _assert_dicts_equal(g, w)
    for g, w in zip(got[1:], want[1:]):
        _assert_dicts_equal(g, w)
    assert dataclasses.asdict(dmap) == dataclasses.asdict(wmap)

    jalp, _ = jdissect.auto_structure(jlp, k)
    alp, _ = dissect.auto_structure(lp, k)
    _assert_lp_equal(alp, bridge.lp_from_numpy(
        jax_fields(jalp), device="cpu", dtype=torch.float64))
    assert dissect.structure_report(dmap, alp) == \
        jdissect.structure_report(wmap, jalp)

    rng = np.random.default_rng(seed)
    x0, xN = rng.normal(size=alp.n0), rng.normal(size=(alp.N, alp.n))
    assert np.array_equal(dmap.recover_x(x0, xN), wmap.recover_x(x0, xN))
    for which, (m0, m, ml) in (("eq", (alp.m0E, alp.mE, alp.mEl)),
                               ("ineq", (alp.m0I, alp.mI, alp.mIl))):
        parts = (rng.normal(size=m0), rng.normal(size=(alp.N, m)),
                 rng.normal(size=ml))
        name = f"recover_{which}_rows"
        assert np.array_equal(getattr(dmap, name)(*parts),
                              getattr(wmap, name)(*parts))


def _refine_instance():
    """The instance of tests/test_dissect.py::test_refine_blocks_matches_
    unrefined: two oversized banded blocks and a first stage."""
    rng = np.random.default_rng(7)
    n0 = 4
    b1, x0s = banded_block(rng, 96, n0=n0)
    b2, _ = banded_block(rng, 120, n0=n0)
    A0 = rng.normal(size=(2, n0))
    first = dict(c=rng.normal(size=n0), A=A0, b=A0 @ x0s,
                 C=np.zeros((0, n0)), iclow=np.zeros(0), clow=np.zeros(0),
                 icupp=np.zeros(0), cupp=np.zeros(0),
                 ixlow=np.ones(n0), xlow=np.zeros(n0),
                 ixupp=np.ones(n0), xupp=np.full(n0, 4.0),
                 F0=np.zeros((0, n0)), G0=np.zeros((0, n0)))
    return [b1, b2], first


def test_refine_blocks_matches_jax():
    blocks, first = _refine_instance()
    wb, wf, wp = jdissect.refine_blocks(blocks, first, max_block_vars=40)
    gb, gf, gp = dissect.refine_blocks(blocks, first, max_block_vars=40)
    assert len(gb) == len(wb) >= 4
    for g, w in zip(gb, wb):
        _assert_dicts_equal(g, w)
    _assert_dicts_equal(gf, wf)
    assert gp == wp


# ---- the callback tree ------------------------------------------------------
def _callback_tree(mod):
    """tests/test_io.py::test_callback_tree_matches_direct's tree, built
    with `mod`'s BlockCallbacks and InputTree."""
    def const(v):
        return lambda _id: np.asarray(v, float)

    root = mod.BlockCallbacks(
        id=0, n_vars=lambda i: 1, n_eq=lambda i: 0, n_ineq=lambda i: 0,
        vec_c=const([1.0]),
        mat_A=None, mat_B=const(np.zeros((0, 1))), vec_b=const([]),
        mat_C=None, mat_D=const(np.zeros((0, 1))),
        vec_clow=const([]), vec_iclow=const([]),
        vec_cupp=const([]), vec_icupp=const([]),
        vec_xlow=const([0.0]), vec_ixlow=const([1.0]),
        vec_xupp=const([3.0]), vec_ixupp=const([1.0]),
        mat_F=const([[1.0]]), mat_G=const([[0.0]]))
    children = [mod.BlockCallbacks(
        id=i, n_vars=lambda i: 2, n_eq=lambda i: 1, n_ineq=lambda i: 1,
        vec_c=const([1.0, 2.0]),
        mat_A=const([[1.0]]),
        mat_B=lambda _id: ([0, 2], [0, 1], [1.0, 1.0]),   # CSR [[1, 1]]
        vec_b=const([4.0]),
        mat_C=const([[0.0]]), mat_D=const([[1.0, -1.0]]),
        vec_clow=const([0.0]), vec_iclow=const([0.0]),
        vec_cupp=const([2.0]), vec_icupp=const([1.0]),
        vec_xlow=const([0.0, 0.0]), vec_ixlow=const([1.0, 1.0]),
        vec_xupp=const([5.0, 5.0]), vec_ixupp=const([1.0, 1.0]),
        mat_F=const([[1.0, 0.0]]), mat_G=const([[0.0, 1.0]]))
        for i in (1, 2)]
    return mod.InputTree(root=root, children=children,
                         n_linking_eq=1, n_linking_ineq=1,
                         vec_bl=lambda: np.array([5.0]),
                         vec_dllow=lambda: np.array([1.0]),
                         vec_idllow=lambda: np.array([1.0]),
                         vec_dlupp=lambda: np.array([6.0]),
                         vec_idlupp=lambda: np.array([1.0]))


def _dict_tree(mod, blocks, first):
    """An InputTree of `mod` whose callbacks hand out the arrays of
    `make_arrowhead_lp`-style dicts (no linking rows)."""
    def cb(i, d, diag):
        get = lambda key: (lambda _id: d[key])  # noqa: E731
        return mod.BlockCallbacks(
            id=i, n_vars=lambda _id: len(d["c"]),
            n_eq=lambda _id: len(d["b"]), n_ineq=lambda _id: len(d["clow"]),
            vec_c=get("c"), mat_A=None if i == 0 else get("A"),
            mat_B=get(diag[0]), vec_b=get("b"),
            mat_C=None if i == 0 else get("C"), mat_D=get(diag[1]),
            **{f"vec_{k}": get(k) for k in ("clow", "iclow", "cupp",
                                            "icupp", "xlow", "ixlow",
                                            "xupp", "ixupp")})
    return mod.InputTree(root=cb(0, first, ("A", "C")),
                         children=[cb(i + 1, b, ("B", "D"))
                                   for i, b in enumerate(blocks)])


@pytest.mark.parametrize("how", ["build", "build_refined", "build_sparse"])
def test_callback_tree_matches_jax(how):
    """The tree of tests/test_io.py::test_callback_tree_matches_direct;
    for `max_block_vars` one over the two oversized banded blocks of the
    refine instance (its 2-variable blocks would lose every column)."""
    if how == "build_refined":
        jtree, tree = (_dict_tree(m, *_refine_instance())
                       for m in (jcallbacks, callbacks))
    else:
        jtree, tree = _callback_tree(jcallbacks), _callback_tree(callbacks)
    if how == "build_sparse":
        want = jax_sparse_fields(jtree.build_sparse())
        got = tree.build_sparse()
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), want[f.name]
            if isinstance(w, dict):
                assert np.array_equal(g.val.numpy(), w["val"]), f.name
                assert np.array_equal(g.col.numpy(), w["col"]), f.name
            else:
                assert np.array_equal(g.numpy(), w), f.name
        return
    kw = dict(max_block_vars=40) if how == "build_refined" else {}
    want = jtree.build(**kw)
    got = tree.build(**kw)
    _assert_lp_equal(got, bridge.lp_from_numpy(
        jax_fields(want), device="cpu", dtype=torch.float64))
    assert tree.refine_placement == jtree.refine_placement
    if how == "build_refined":
        assert got.N >= 4 and got.n0 > 4


def test_callback_tree_refuses_bucketed():
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1: Bucket"):
        _callback_tree(callbacks).build(bucketed=True)


# ---- GAMS -------------------------------------------------------------------
# a two-block model in the GAMSsmall subset: x(j1) first stage, j2-j3 block
# 1, j4-j5 block 2; a starred bounds list; =e=, =l= and =g= rows, a linking
# eq row (i3, stage 4) and a linking ineq row (iii2), and a first-stage
# ineq row (iii1, stage 1)
GMS_TEXT = """\
* two-block test model
$ontext
comment block
$offtext
Set i rows / i1*i3 /
    ii lerows / ii1*ii2 /
    iii gerows / iii1*iii2 /
    j columns / j1*j5 / ;

parameter g(j) obj coefs / j1 1, j2 2, j3 -1, j4 1.5, j5 0.5 /
          b(i) rhs / i1 2, i2 3, i3 4 /
          cupp(ii) upper / ii1 5, ii2 6.5 /
          clow(iii) lower / iii1 -1, iii2 0.25 / ;

Table A(i,j)
        j1      j2      j3      j4      j5
i1       1       1      -1
i2       2                       1       1
i3               1               1              ;

Table C(ii,j)
        j1      j2      j3      j4      j5
ii1              1       2
ii2      1                       3      -1      ;

Table D(iii,j)
        j1      j2      j3      j4      j5
iii1     4
iii2                     1               1      ;

Positive Variables x(j) * / j1.up 3, j2.lo 0.5, j5.fx 1 / ;
Variable z;

Equations e(i), le(ii), ge(iii), defobj;

defobj..  z =e= sum(j, g(j)*x(j));
e(i)..    sum(j, A(i,j)*x(j)) =e= b(i);
le(ii)..  sum(j, C(ii,j)*x(j)) =l= cupp(ii);
ge(iii).. sum(j, D(iii,j)*x(j)) =g= clow(iii);

Model m / all /;

$ifthen %PIPS%==1
x.stage('j1') = 1;
x.stage('j2') = 2;
x.stage('j3') = 2;
x.stage('j4') = 3;
x.stage('j5') = 3;
e.stage('i1') = 2;
e.stage('i2') = 3;
e.stage('i3') = 4;
le.stage('ii1') = 2;
le.stage('ii2') = 3;
ge.stage('iii1') = 1;
ge.stage('iii2') = 4;
$endif
solve m using lp minimizing z;
"""


def test_gams_reader_matches_jax(tmp_path):
    want, got = jgams.parse_gms(GMS_TEXT), gams.parse_gms(GMS_TEXT)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.starred_bounds and len(got.eq_defs) == 3
    wdata = jgams.gms_to_block_data(want, 3)
    gdata = gams.gms_to_block_data(got, 3)
    assert len(gdata[0]) == len(wdata[0]) == 2
    for g, w in zip(gdata[0], wdata[0]):
        _assert_dicts_equal(g, w)
    for g, w in zip(gdata[1:], wdata[1:]):
        _assert_dicts_equal(g, w)
    assert len(gdata[2]["b"]) == 1 and len(gdata[3]["clow"]) == 1
    path = str(tmp_path / "two_block.gms")
    with open(path, "w") as f:
        f.write(GMS_TEXT)
    lp = gams.read_gms(path, 3)
    _assert_lp_equal(lp, bridge.lp_from_numpy(
        jax_fields(jgams.read_gms(path, 3)), device="cpu",
        dtype=torch.float64))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that fails to compile raises from `get_lib()` (so the
    presolve wrappers raise too, instead of moving to their plain
    versions); only a host without a compiler gets None and the reason in
    `build_error`."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "build_error", None)
    native._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.get_lib()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.row_support_stats(np.eye(2))
        assert native.build_error is None
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setattr(native.shutil, "which", lambda _: None)
        assert native.get_lib() is None
        assert "not found" in native.build_error
        nnz, _, _ = native.row_support_stats(np.eye(2))
        assert nnz.tolist() == [1, 1]
    finally:
        native._load.cache_clear()
