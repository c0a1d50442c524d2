"""The PyTorch ELL products (linalg/spmv.py) against the JAX package's ELL
functions and its Pallas lane-gather kernel (interpret mode, its default
off TPU); the CUDA kernel against the plain version on a card.

JAX is imported inside the tests that compare with it, so that on a
machine with a card and no JAX the kernel test runs alone:
`python -m pytest --noconftest -m gpu tests/test_torch_spmv.py`."""
import numpy as np
import pytest
import torch

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
    rng = np.random.default_rng(4)
    col, val = _random_ell(rng, 2, 33, 20, 4)
    ell = Ell(torch.from_numpy(val), torch.from_numpy(col))
    km = spmv.ell_kmajor(ell, 20)
    assert km.val.transpose(1, 2).is_contiguous()
    assert km.col.dtype == torch.int32
    X = torch.from_numpy(rng.standard_normal((2, 20, 3)))
    np.testing.assert_array_equal(spmv.ell_mv_multi(km, X).numpy(),
                                  spmv.ell_mv_multi(ell, X).numpy())
    with pytest.raises(ValueError):
        spmv.ell_kmajor(ell, 19)                 # a column id is 19


def test_wrapper_checks_inputs():
    val = torch.zeros(1, 2, 3)
    X = torch.zeros(1, 4, 2)
    with pytest.raises(TypeError):
        spmv.ell_spmm(val, torch.zeros(1, 2, 3, dtype=torch.int64), X)
    with pytest.raises(TypeError):
        spmv.ell_spmm(val, torch.zeros(1, 2, 3, dtype=torch.int32),
                      X.double())
    with pytest.raises(ValueError):
        spmv.ell_spmm(val, torch.zeros(1, 2, 2, dtype=torch.int32), X)


def test_cpu_tensor_never_counts_a_launch():
    before = spmv.ell_spmm.launches
    rng = np.random.default_rng(5)
    col, val = _random_ell(rng, 2, 8, 8, 3)
    ell = Ell(torch.from_numpy(val), torch.from_numpy(col))
    spmv.ell_mv(ell, torch.ones(2, 8, dtype=torch.float64))
    spmv.ell_sq_diag(ell, torch.ones(2, 8, dtype=torch.float64))
    spmv.ell_mv_multi(ell.astype(torch.float32),
                      torch.ones(2, 8, 4, dtype=torch.float32))
    assert spmv.ell_spmm.launches == before


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(6)
    col, val = _random_ell(rng, 3, 300, 257, 7)
    ell = Ell(torch.from_numpy(val), torch.from_numpy(col)).to("cuda")
    for layout in (ell, spmv.ell_kmajor(ell, 257)):
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            lay = layout.astype(dtype)
            for c in (1, 24, 40):
                X = torch.from_numpy(rng.standard_normal((3, 257, c))).to(
                    "cuda", dtype)
                before = spmv.ell_spmm.launches
                Yk = spmv.ell_spmm(lay.val, lay.col, X)
                torch.cuda.synchronize()
                assert spmv.ell_spmm.launches == before + 1
                Yp = spmv.ell_spmm_ref(lay.val, lay.col, X)
                err = float((Yk - Yp).abs().max())
                assert err <= tol * float(Yp.abs().max()), (dtype, c, err)
