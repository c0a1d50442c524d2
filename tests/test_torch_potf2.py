"""The f64 root Cholesky in LAPACK's unblocked order
(`pips_ipmpp_tpu_torch/linalg/potf2.py`): its plain version against the
JAX package's `jnp.linalg.cholesky` on the CPU, its failure flags, and
(marked `gpu`, skipped without a card) the CUDA kernel against the plain
version on the card: `python -m pytest --noconftest -m gpu
tests/test_torch_potf2.py`."""
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu_torch.linalg import potf2
from pips_ipmpp_tpu_torch.linalg.arrow_backend import _root_cholesky
import torch_parity  # noqa: F401  (one torch thread)


def _spd(rng, B, n):
    R = rng.standard_normal((B, n, n))
    return R @ np.swapaxes(R, -1, -2) / n + np.eye(n)


@pytest.mark.parametrize("B,n", [(1, 1), (3, 11), (2, 64)])
def test_plain_matches_jax_cholesky(B, n):
    import jax.numpy as jnp
    A = _spd(np.random.default_rng(n), B, n)
    L, ok = potf2.cholesky_potf2(torch.from_numpy(A))
    ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    assert ok.shape == (B,) and bool(ok.all())
    assert np.abs(L.numpy() - ref).max() <= 1e-13 * np.abs(ref).max()
    assert np.allclose(np.triu(L.numpy(), 1), 0.0)


def test_failure_flags_and_first_bad_pivot():
    rng = np.random.default_rng(0)
    A = _spd(rng, 3, 6)
    A[1, 3, 3] = -1.0                       # column 3 of LP 1 fails
    A[2, 0, 0] = np.nan                     # column 0 of LP 2 fails
    L, info = potf2.cholesky_potf2_ref(torch.from_numpy(A))
    assert info.tolist() == [0, 4, 1]
    _, ok = potf2.cholesky_potf2(torch.from_numpy(A))
    assert ok.tolist() == [True, False, False]


def test_singular_root_block_refused_like_lapack():
    """A rank-deficient PSD block (two equal rows): the cancelled pivot is
    refused, as LAPACK refuses it, where cuSOLVER's potrf was seen to keep
    a tiny positive one (ROADMAP.md §3, F3)."""
    v = np.array([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0], [0.5, -1.0, 2.0]])
    A = v @ v.T
    _, ok = potf2.cholesky_potf2(torch.from_numpy(A))
    _, info = torch.linalg.cholesky_ex(torch.from_numpy(A))
    assert not bool(ok) and int(info) != 0


def test_cpu_root_stays_with_torch_linalg():
    A = torch.from_numpy(_spd(np.random.default_rng(1), 2, 5))
    before = potf2.potf2.launches
    L, ok = _root_cholesky(A, 1)
    assert torch.equal(L, torch.linalg.cholesky(A))
    assert ok.shape == (2,) and potf2.potf2.launches == before


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    # n = 300 keeps its running sums in device memory, the rest in shared
    for B, n in ((1, 1), (1, 14), (8, 64), (2, 128), (1, 200), (1, 300)):
        A = torch.from_numpy(_spd(rng, B, n)).cuda()
        before = potf2.potf2.launches
        Lk, ik = potf2.potf2(A)
        torch.cuda.synchronize()
        assert potf2.potf2.launches == before + 1
        Lp, ip = potf2.cholesky_potf2_ref(A)
        assert torch.equal(ik, ip) and bool((ik == 0).all())
        assert float((Lk - Lp).abs().max()) <= 1e-14 * float(Lp.abs().max())
    bad = torch.from_numpy(_spd(rng, 2, 8)).cuda()
    bad[1, 5, 5] = -1.0
    _, info = potf2.potf2(bad)
    assert info.tolist() == [0, 6]


@pytest.mark.gpu
def test_cuda_f32_two_level_root_stays_with_torch_linalg():
    """f32 factors with the two-level root (`ldl_kernel=False`): the root's
    f32 blocks go to torch.linalg on the card, not to the f64-only potf2
    kernel, and the solve ends as its f64 twin does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from functools import partial

    from pips_ipmpp_tpu_torch.core.options import Options
    from pips_ipmpp_tpu_torch.core.status import TerminationStatus
    from pips_ipmpp_tpu_torch.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
    from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
    A = torch.from_numpy(_spd(np.random.default_rng(2), 2, 9)).float().cuda()
    before = potf2.potf2.launches
    L, ok = _root_cholesky(A, 1)
    assert L.dtype == torch.float32 and ok.tolist() == [True, True]
    assert potf2.potf2.launches == before
    lp = random_arrowhead_lp(5, N=4, n=24, mE=10, mI=12, n0=6, m0E=3, m0I=3,
                             mEl=3, mIl=3)
    res = {}
    for fd in (torch.float32, torch.float64):
        be = partial(ArrowBackend, factor_dtype=fd, ldl_kernel=False)
        res[fd] = IPMSolver(be, Options(), device="cuda").solve(lp)
        assert res[fd].status == TerminationStatus.SUCCESSFUL_TERMINATION
    f32, f64 = res[torch.float32].objective, res[torch.float64].objective
    assert abs(f32 - f64) <= 1e-4 * max(1.0, abs(f64))
    assert potf2.potf2.launches > before
