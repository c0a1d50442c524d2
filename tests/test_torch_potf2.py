"""The f64 root Cholesky in LAPACK's unblocked order
(`pips_ipmpp_tpu_torch/linalg/potf2.py`): its plain version against the
JAX package's `jnp.linalg.cholesky` on the CPU, its failure flags, the
CUDA kernel's blocked schedule emulated in torch operations against the
plain version bit for bit, and (marked `gpu`, skipped without a card) the
CUDA kernel against the plain version on the card: `python -m pytest
--noconftest -m gpu tests/test_torch_potf2.py`."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pips_ipmpp_tpu_torch import _build
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


# the kernel's panel width, read from its source
KERNEL_NB = int(re.search(
    r"constexpr int kNb = (\d+);",
    (Path(potf2.__file__).parent.parent / "csrc" / "potf2.cu").read_text())
    .group(1))


def blocked_schedule(A, nb):
    """The CUDA kernel's schedule (`csrc/potf2.cu`) in torch operations,
    one per rounded product or sum, vectorized only where the kernel works
    in parallel: per panel of nb columns (a) the diagonal block,
    right-looking, one lane per row; (b) the rows below it, each a sweep
    over the panel's columns in k order adding l_ik^2 to s_i in turn; (c)
    the strictly lower trailing triangle in nb x nb tiles, each element
    taking the panel's terms in k order.  Y holds the running sums (the
    kernel keeps them in L and reads A where L holds nothing yet).
    Returns (L, info) as `cholesky_potf2_ref` does."""
    n = A.shape[-1]
    Y = A.clone()
    L = torch.zeros_like(A)
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.zeros_like(d)
    inv = torch.zeros_like(d)
    info = torch.zeros(A.shape[:-2], dtype=torch.int32)
    for c0 in range(0, n, nb):
        c1 = min(c0 + nb, n)
        for k in range(c0, c1):                       # (a)
            piv = d[..., k] - s[..., k]
            bad = ~((piv > 0) & torch.isfinite(piv))
            info = torch.where((info == 0) & bad, k + 1, info)
            lkk = torch.sqrt(piv)
            inv[..., k] = 1.0 / lkk
            L[..., k, k] = lkk
            v = Y[..., k + 1:c1, k] * inv[..., k, None]
            L[..., k + 1:c1, k] = v
            s[..., k + 1:c1] = s[..., k + 1:c1] + v * v
            for j in range(k + 1, c1):                # lane j's l_jk
                Y[..., j + 1:c1, j] = (Y[..., j + 1:c1, j]
                                       + (-L[..., j, k, None])
                                       * L[..., j + 1:c1, k])
        if c1 == n:
            break
        y = Y[..., c1:, c0:c1].clone()                # (b), lane t: column
        for k in range(c0, c1):
            lik = y[..., k - c0] * inv[..., k, None]
            L[..., c1:, k] = lik
            s[..., c1:] = s[..., c1:] + lik * lik
            y[..., k - c0 + 1:] = (y[..., k - c0 + 1:]
                                   + (-L[..., None, k + 1:c1, k])
                                   * lik[..., None])
        for r0 in range(c1, n, nb):                   # (c)
            for q0 in range(c1, r0 + 1, nb):
                rs, qs = slice(r0, min(r0 + nb, n)), slice(q0, min(q0 + nb, n))
                ii = torch.arange(r0, rs.stop)[:, None]
                below = torch.arange(q0, qs.stop)[None, :] < ii
                T = Y[..., rs, qs]
                for k in range(c0, c1):
                    T = torch.where(below, T + (-L[..., None, qs, k])
                                    * L[..., rs, k, None], T)
                Y[..., rs, qs] = T
    return L, info


def _same(L, Lr, info, infor):
    """Bit equality, NaNs where the plain version has them."""
    nan = torch.isnan(Lr)
    return (torch.equal(info, infor) and torch.equal(torch.isnan(L), nan)
            and torch.equal(L.masked_fill(nan, 0.0), Lr.masked_fill(nan, 0.0)))


@pytest.mark.parametrize("n", [1, KERNEL_NB - 1, KERNEL_NB, KERNEL_NB + 1,
                               2 * KERNEL_NB + 3])
def test_blocked_schedule_matches_plain_at_kernel_nb(n):
    A = torch.from_numpy(_spd(np.random.default_rng(n), 3, n))
    L, info = blocked_schedule(A, KERNEL_NB)
    Lr, infor = potf2.cholesky_potf2_ref(A)
    assert bool((infor == 0).all()) and torch.equal(info, infor)
    assert torch.equal(L, Lr)


def test_blocked_schedule_matches_plain_every_edge_to_40():
    for n in range(1, 41):
        A = torch.from_numpy(_spd(np.random.default_rng(100 + n), 3, n))
        L, info = blocked_schedule(A, 8)
        Lr, infor = potf2.cholesky_potf2_ref(A)
        assert torch.equal(info, infor) and torch.equal(L, Lr), n


@pytest.mark.parametrize("nb,n,bad", [(8, 37, 3), (8, 37, 29),
                                      (KERNEL_NB, 70, 5),
                                      (KERNEL_NB, 70, 66)])
def test_blocked_schedule_failing_pivot(nb, n, bad):
    """A failing pivot inside the first diagonal block or in a later panel:
    the same info and the same factor, NaNs included, as the plain
    version."""
    A = _spd(np.random.default_rng(n + bad), 3, n)
    A[1, bad, bad] = -1.0                  # a negative pivot
    A[2, bad, bad] = np.inf                # an infinite one
    A = torch.from_numpy(A)
    L, info = blocked_schedule(A, nb)
    Lr, infor = potf2.cholesky_potf2_ref(A)
    assert infor.tolist() == [0, bad + 1, bad + 1]
    assert _same(L, Lr, info, infor)


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
    nb = KERNEL_NB
    # one panel, the edges either side of the panel width, several panels
    # with a ragged tail, and the energy LP's root blocks (550, 385)
    for B, n in ((1, 1), (1, 14), (1, nb - 1), (1, nb), (3, nb + 1),
                 (8, 64), (2, 2 * nb + 3), (2, 128), (2, 193), (1, 300),
                 (1, 385), (1, 550)):
        A = torch.from_numpy(_spd(rng, B, n)).cuda()
        before = potf2.potf2.launches
        Lk, ik = potf2.potf2(A)
        torch.cuda.synchronize()
        assert potf2.potf2.launches == before + 1
        Lp, ip = potf2.cholesky_potf2_ref(A)
        assert torch.equal(ik, ip) and bool((ik == 0).all())
        assert torch.equal(Lk, Lp), (B, n)
    launches = _build.load().potf2_launches
    assert launches(nb) == 1 and launches(550) == 2 * -(-550 // nb) - 1
    bad = torch.from_numpy(_spd(rng, 2, 8)).cuda()
    bad[1, 5, 5] = -1.0
    _, info = potf2.potf2(bad)
    assert info.tolist() == [0, 6]
    bad = torch.from_numpy(_spd(rng, 3, 70)).cuda()
    bad[1, 40, 40] = -1.0                   # in a later panel
    bad[2, 3, 3] = np.inf                   # in the first diagonal block
    Lk, ik = potf2.potf2(bad)
    Lp, ip = potf2.cholesky_potf2_ref(bad)
    assert ik.tolist() == [0, 41, 4] and _same(Lk, Lp, ik, ip)


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
