"""The PyTorch ELL products (linalg/spmv.py) against the JAX package's ELL
functions and its Pallas lane-gather kernel (interpret mode, its default
off TPU); the CUDA kernel against the plain version on a card.

JAX is imported inside the tests that compare with it, so that on a
machine with a card and no JAX the kernel test runs alone:
`python -m pytest --noconftest -m gpu tests/test_torch_spmv.py`."""
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)

from pips_ipmpp_tpu_torch.core.sparse import Ell, ell_transpose
from pips_ipmpp_tpu_torch.linalg import spmv


def _random_ell(rng, N, m, n, K):
    """Rows of 1..K distinct column ids, zero-padded (val 0, col 0)."""
    col = np.zeros((N, m, K), np.int32)
    val = np.zeros((N, m, K))
    for b in range(N):
        for r in range(m):
            k = rng.integers(1, K + 1)
            col[b, r, :k] = rng.choice(n, size=k, replace=False)
            val[b, r, :k] = rng.standard_normal(k)
    return col, val


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= rtol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("op", ["ell_spmm_ref", "ell_mv", "ell_mv_multi",
                                "ell_sq_diag"])
def test_plain_matches_jax_ell(op):
    import jax.numpy as jnp
    from pips_ipmpp_tpu.core import sparse as jsparse

    rng = np.random.default_rng(0)
    N, m, n, K, c = 3, 40, 56, 6, 5
    col, val = _random_ell(rng, N, m, n, K)
    jell = jsparse.Ell(jnp.asarray(val), jnp.asarray(col))
    tell = Ell(torch.from_numpy(val), torch.from_numpy(col))
    X = rng.standard_normal((N, n, c))
    w = rng.uniform(0.1, 2.0, size=(N, n))
    if op == "ell_spmm_ref":
        got = spmv.ell_spmm_ref(tell.val, tell.col, torch.from_numpy(X))
        want = jsparse.ell_mv_multi(jell, jnp.asarray(X))
    elif op == "ell_mv":
        got = spmv.ell_mv(tell, torch.from_numpy(X[:, :, 0]))
        want = jsparse.ell_mv(jell, jnp.asarray(X[:, :, 0]))
    elif op == "ell_mv_multi":
        got = spmv.ell_mv_multi(tell, torch.from_numpy(X))
        want = jsparse.ell_mv_multi(jell, jnp.asarray(X))
    else:
        got = spmv.ell_sq_diag(tell, torch.from_numpy(w))
        want = jsparse.ell_sq_diag(jell, jnp.asarray(w))
    assert got.dtype == torch.float64
    _close(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["forward", "transposed"])
@pytest.mark.parametrize("m,n,c", [(64, 96, 3), (130, 257, 9)])
def test_matches_tiled_spmv_interpret(m, n, c, transpose):
    import jax.numpy as jnp
    from pips_ipmpp_tpu.linalg.pallas_spmv import (build_tiled, from_tiles,
                                                   tiled_spmv, to_tiles)

    rng = np.random.default_rng(m + n)
    N, K = 3, 5
    col, val = _random_ell(rng, N, m, n, K)
    te = build_tiled(col, val, m, n, transpose=transpose, dtype=np.float64)
    rows, cols = (n, m) if transpose else (m, n)
    x = rng.standard_normal((N, c, cols))              # the TPU layout
    want = from_tiles(tiled_spmv(te, to_tiles(jnp.asarray(x), te.n_pad)),
                      rows, c)
    ell = Ell(torch.from_numpy(val), torch.from_numpy(col))
    if transpose:
        ell = ell_transpose(ell, n)
    got = spmv.ell_mv_multi(ell, torch.from_numpy(x).transpose(1, 2))
    assert got.shape == (N, rows, c)
    _close(got.transpose(1, 2).numpy(), want, 1e-12)


def test_duplicate_and_zero_entries():
    """Duplicate (row, col) slots add up; zero-valued padding contributes
    nothing (the case of tests/test_pallas_spmv.py, held to the same
    numbers)."""
    col = torch.tensor([[[2, 2, 0], [1, 0, 0]]], dtype=torch.int32)
    val = torch.tensor([[[1.5, 2.5, 0.0], [3.0, 0.0, 0.0]]],
                       dtype=torch.float64)
    x = torch.arange(1, 5, dtype=torch.float64).reshape(1, 4)
    y = spmv.ell_mv(Ell(val, col), x)
    np.testing.assert_array_equal(y.numpy(), [[12.0, 6.0]])


def test_kmajor_layout_and_range_check():
    """The sliced layout stores each slice K-major (slot k of its 32 rows
    contiguous), gives the padded ELL's product, and checks column ids
    once at build."""
    rng = np.random.default_rng(4)
    col, val = _random_ell(rng, 2, 33, 20, 4)
    ell = Ell(torch.from_numpy(val), torch.from_numpy(col))
    op = spmv.sell_from_ell(ell, 20)
    assert op.col.dtype == torch.int32 and op.slice_ptr.dtype == torch.int64
    assert op.S == 2 and op.slice_k.shape == (4,)
    for g in range(4):
        p0, k = int(op.slice_ptr[g]), int(op.slice_k[g])
        rows = op.row[32 * g:32 * g + 32].long()
        b = g // 2
        for i in np.flatnonzero(rows.numpy() >= 0)[:5]:
            slots = op.val[p0 + i:p0 + 32 * k:32]
            want = val[b, int(rows[i])]
            np.testing.assert_array_equal(slots.numpy()[slots.numpy() != 0],
                                          want[want != 0])
    X = torch.from_numpy(rng.standard_normal((2, 20, 3)))
    np.testing.assert_array_equal(spmv.ell_mv_multi(op, X).numpy(),
                                  spmv.ell_mv_multi(ell, X).numpy())
    with pytest.raises(ValueError):
        spmv.sell_from_ell(ell, 19)                 # a column id is 19


def test_wrapper_checks_inputs():
    val = torch.zeros(1, 2, 3)
    X = torch.zeros(1, 4, 2)
    i32 = torch.zeros(1, 2, 3, dtype=torch.int32)
    with pytest.raises(TypeError):
        spmv.ell_spmm(Ell(val, torch.zeros(1, 2, 3, dtype=torch.int64)), X)
    with pytest.raises(TypeError):
        spmv.ell_spmm(Ell(val, i32), X.double())
    with pytest.raises(ValueError):
        spmv.ell_spmm(Ell(val, torch.zeros(1, 2, 2, dtype=torch.int32)), X)
    op = spmv.sell_from_ell(Ell(val, i32), 4)
    with pytest.raises(ValueError):                 # X rows != n
        spmv.ell_spmm(op, torch.zeros(1, 5, 2))
    with pytest.raises(ValueError):                 # alpha not [N, m]
        spmv.ell_spmm(op, X, alpha=torch.ones(1, 3))
    with pytest.raises(ValueError):                 # Z not [N, m, c]
        spmv.ell_spmm(op, X, Z=torch.ones(1, 2, 3))
    with pytest.raises(ValueError):                 # beta without Z
        spmv.ell_spmm(op, X, beta=torch.ones(1, 2))
    with pytest.raises(TypeError):                  # alpha's dtype
        spmv.ell_spmm(op, X, alpha=torch.ones(1, 2, dtype=torch.float64))


def test_cpu_tensor_never_counts_a_launch():
    before = spmv.ell_spmm.launches
    rng = np.random.default_rng(5)
    col, val = _random_ell(rng, 2, 8, 8, 3)
    ell = Ell(torch.from_numpy(val), torch.from_numpy(col))
    spmv.ell_mv(ell, torch.ones(2, 8, dtype=torch.float64))
    spmv.ell_sq_diag(ell, torch.ones(2, 8, dtype=torch.float64))
    op = spmv.sell_from_ell(ell.astype(torch.float32), 8, "op")
    spmv.ell_mv_multi(op, torch.ones(2, 8, 4, dtype=torch.float32),
                      alpha=torch.ones(2, 8))
    assert spmv.ell_spmm.launches == before
    assert ("op", 4) not in spmv.ell_spmm.launches_by


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(6)
    col, val = _random_ell(rng, 3, 300, 257, 7)
    ell = Ell(torch.from_numpy(val), torch.from_numpy(col)).to("cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        op = spmv.sell_from_ell(ell.astype(dtype), 257, "t")
        for c in (1, 3, 24, 40):
            X = torch.from_numpy(rng.standard_normal((3, 257, c))).to(
                "cuda", dtype)
            before = spmv.ell_spmm.launches
            Yk = spmv.ell_spmm(op, X)
            torch.cuda.synchronize()
            assert spmv.ell_spmm.launches == before + 1
            Yp = spmv.ell_spmm_ref(op.ell.val, op.ell.col, X)
            err = float((Yk - Yp).abs().max())
            assert err <= tol * float(Yp.abs().max()), (dtype, c, err)


# ---- the sliced layout (SELL-C-sigma) ----------------------------------------
def _ragged_ell(case, rng):
    """[2, m, K] padded ELLs with the raggedness a sliced layout must
    handle; the nonzeros of some rows sit between padded slots, as in a
    transpose stacked from two halves."""
    N, n = 2, 50
    m = {"m_not_multiple": 45}.get(case, 96)
    K = 40 if case == "one_long_row" else 6
    counts = rng.integers(1, 7, size=(N, m))
    if case == "empty_rows":
        counts[:, ::3] = 0
    elif case == "all_padding_slice":
        counts[:, 32:64] = 0                     # one slice's worth of rows
    elif case == "one_long_row":
        counts = rng.integers(1, 4, size=(N, m))
        counts[1, 70] = 40
    elif case == "equal_counts":
        counts[:] = 5
    col = np.zeros((N, m, K), np.int32)
    val = np.zeros((N, m, K))
    for b in range(N):
        for r in range(m):
            k = counts[b, r]
            slots = np.sort(rng.choice(K, size=k, replace=False)) \
                if r % 2 else np.arange(k)
            col[b, r, slots] = rng.choice(n, size=k, replace=False)
            val[b, r, slots] = rng.standard_normal(k)
    return Ell(torch.from_numpy(val), torch.from_numpy(col)), n, counts


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("c", [1, 3, 24])
@pytest.mark.parametrize("case", ["empty_rows", "all_padding_slice",
                                  "one_long_row", "m_not_multiple",
                                  "equal_counts"])
def test_sell_layout_matches_padded_plain(case, c, dtype):
    """The plain version over the slices equals the padded ELL's plain
    version (f64: 1e-12 of max|Y|, f32: 1e-5; summation order only); each
    slice stores its longest row's slots."""
    rng = np.random.default_rng(7)
    ell, n, counts = _ragged_ell(case, rng)
    ell = ell.astype(dtype)
    X = torch.from_numpy(rng.standard_normal((2, n, c))).to(dtype)
    want = spmv.ell_spmm_ref(ell.val, ell.col, X)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    op = spmv.sell_from_ell(ell, n)
    got = spmv.sell_spmm_ref(op, X)
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    assert op.nnz == counts.sum()
    assert op.slots == 32 * int(op.slice_k.sum())
    assert op.slice_ptr[-1] == op.slots
    rows = op.row.view(2, -1)
    for b in range(2):              # a permutation of the block's rows
        r = rows[b][rows[b] >= 0]
        assert sorted(r.tolist()) == list(range(ell.m))
    if case in ("all_padding_slice", "empty_rows"):
        assert int((op.slice_k == 0).sum()) >= 1
    if case == "equal_counts":
        assert torch.equal(rows, torch.arange(96).expand(2, 96))
        assert op.slots == op.nnz
    if case == "one_long_row":
        assert int(op.slice_k.max()) == 40
        assert op.slots < ell.val.numel() / 4


_EPILOGUES = {
    "alpha": lambda a, b, Z: dict(alpha=a),
    "beta_z": lambda a, b, Z: dict(beta=b, Z=Z),
    "z": lambda a, b, Z: dict(Z=Z),
    "alpha_beta_z": lambda a, b, Z: dict(alpha=a, beta=b, Z=Z),
}


@pytest.mark.parametrize("form", list(_EPILOGUES))
def test_plain_epilogue_is_the_separate_expression_bitwise(form):
    """The plain versions' epilogue is alpha * Y + beta * Z computed as
    separate torch operations, to the bit, on both layouts."""
    rng = np.random.default_rng(8)
    ell, n, _ = _ragged_ell("empty_rows", rng)
    ell = ell.astype(torch.float32)
    op = spmv.sell_from_ell(ell, n)
    X = torch.from_numpy(rng.standard_normal((2, n, 5))).float()
    a, b = (torch.from_numpy(rng.uniform(-2, 2, (2, ell.m))).float()
            for _ in range(2))
    Z = torch.from_numpy(rng.standard_normal((2, ell.m, 5))).float()
    kw = _EPILOGUES[form](a, b, Z)
    for plain in (lambda **e: spmv.ell_spmm(op, X, **e),
                  lambda **e: spmv.sell_spmm_ref(op, X, **e)):
        Y = plain()
        want = Y if "alpha" not in kw else a[..., None] * Y
        if "Z" in kw:
            want = want + (Z if "beta" not in kw else b[..., None] * Z)
        assert torch.equal(plain(**kw), want)


def test_backend_folds_its_scalings_bitwise():
    """The sparse backend's epilogue calls give, to the bit, the products
    followed by the separate scalings and subtractions they replace."""
    from pips_ipmpp_tpu_torch.io.synthetic import random_sparse_arrowhead_lp
    from pips_ipmpp_tpu_torch.linalg.sparse_backend import SparseArrowBackend

    lp = random_sparse_arrowhead_lp(5, N=2, n=48, mE=24, mI=24,
                                    nnz_per_row=4, n0=3, m0E=1, m0I=1,
                                    mEl=1, mIl=1)
    be = SparseArrowBackend(lp, factor_dtype=torch.float32)
    rng = np.random.default_rng(9)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s)).float()  # noqa
    Einv, Fd = f32(2, 48).abs(), f32(2, 48).abs()
    V = f32(2, 48, 5)
    t = Einv[:, :, None] * spmv.ell_mv_multi(be._Mt.ell, V)
    assert torch.equal(be._neq_apply(Einv, Fd, V),
                       spmv.ell_mv_multi(be._M.ell, t) + Fd[:, :, None] * V)
    R, E = f32(2, 48, 5), f32(2, 48, 5)
    assert torch.equal(spmv.ell_mv_multi(be._M, E, Z=-R),
                       spmv.ell_mv_multi(be._M.ell, E) - R)
    assert torch.equal(spmv.ell_mv_multi(be._Mt, V, alpha=-Einv, Z=E),
                       E - Einv[:, :, None] * spmv.ell_mv_multi(be._Mt.ell,
                                                                V))
    assert torch.equal(spmv.ell_mv(be._Msq, Einv, z=Fd),
                       spmv.ell_mv(be._Msq.ell, Einv) + Fd)


def test_sliced_transpose_stores_at_most_125_slots_per_nonzero():
    """The merged transpose [Bt | Dt] pads each half to its own longest
    row (K = 30 for 10 nonzeros per row on average); its slices store at
    most 1.25 slots per nonzero."""
    from pips_ipmpp_tpu_torch.io.synthetic import random_sparse_arrowhead_lp
    from pips_ipmpp_tpu_torch.linalg.sparse_backend import _stack_cols

    lp = random_sparse_arrowhead_lp(0, N=2, n=2048, mE=1024, mI=1024,
                                    nnz_per_row=10)
    Mt = _stack_cols(lp.Bt, lp.Dt, lp.mE)
    op = spmv.sell_from_ell(Mt, lp.mE + lp.mI)
    assert op.nnz == int((Mt.val != 0).sum())
    assert Mt.val.numel() >= 2.5 * op.nnz
    assert op.slots <= 1.25 * op.nnz, op.slots / op.nnz


@pytest.mark.gpu
def test_cuda_kernel_epilogue_matches_plain():
    """The kernel's epilogue against the plain version (f32 1e-5, f64
    1e-12 of max|Y|) and, to the bit, against the kernel's own product
    followed by the separate torch operations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(10)
    ell, n, _ = _ragged_ell("one_long_row", rng)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        op = spmv.sell_from_ell(ell.astype(dtype).to("cuda"), n)
        for c in (1, 3, 24):
            g = lambda *s: torch.from_numpy(  # noqa: E731
                rng.standard_normal(s)).to("cuda", dtype)
            X, a, b, Z = g(2, n, c), g(2, ell.m), g(2, ell.m), g(2, ell.m, c)
            for make in _EPILOGUES.values():
                kw = make(a, b, Z)
                Yk = spmv.ell_spmm(op, X, **kw)
                Y0 = spmv.ell_spmm(op, X)
                want = Y0 if "alpha" not in kw else a[..., None] * Y0
                if "Z" in kw:
                    want = want + (Z if "beta" not in kw
                                   else b[..., None] * Z)
                assert torch.equal(Yk, want), (dtype, c, sorted(kw))
                Yp = spmv.ell_spmm_ref(op.ell.val, op.ell.col, X, **kw)
                err = float((Yk - Yp).abs().max())
                assert err <= tol * float(Yp.abs().max()), (dtype, c, err)
