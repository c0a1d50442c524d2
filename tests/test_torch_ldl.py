"""The PyTorch LDL^T module against the JAX Pallas kernel (interpret mode,
its default off TPU) and against numpy; the blocked plain version (the CUDA
kernel's algorithm) against the column version and the Pallas kernel; the
CUDA kernel against the plain version on a card.

JAX is imported inside the tests that compare with it, so that on a
machine with a card and no JAX the kernel test runs alone:
`python -m pytest --noconftest -m gpu tests/test_torch_ldl.py`."""
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu_torch.linalg import ldl
from torch_parity import normwise_close


def _spd(rng, B, a):
    R = rng.normal(size=(B, a, a))
    return R @ np.swapaxes(R, 1, 2) / a + np.eye(a)


def _quasidefinite(rng, B, a, n_pos):
    """[[SPD, C'], [C, -SPD]] with an n_pos x n_pos positive block."""
    P = _spd(rng, B, n_pos)
    Q = _spd(rng, B, a - n_pos)
    C = rng.normal(size=(B, a - n_pos, n_pos)) * 0.5
    top = np.concatenate([P, np.swapaxes(C, 1, 2)], axis=2)
    bot = np.concatenate([C, -Q], axis=2)
    return np.concatenate([top, bot], axis=1)


CASES = {
    "spd_4x64": lambda rng: (_spd(rng, 4, 64), 64),
    # 40 is not a multiple of the JAX kernel's panel: its padding path runs
    "quasidef_1x40": lambda rng: (_quasidefinite(rng, 1, 40, 24), 24),
}


def _inverse(X, d):
    return np.swapaxes(X, 1, 2) @ (X / d[:, :, None])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_f32_matches_pallas_interpret(case):
    import jax.numpy as jnp
    from pips_ipmpp_tpu.linalg import pallas_ldl

    A, n_pos = CASES[case](np.random.default_rng(0))
    A32 = A.astype(np.float32)
    Xj, dj = pallas_ldl.ldl_inverse_factors(jnp.asarray(A32), interpret=True)
    Xt, dt = ldl.ldl_inverse_factors(torch.from_numpy(A32))
    assert Xt.dtype == torch.float32 and dt.dtype == torch.float32
    Xt, dt = Xt.numpy(), dt.numpy()
    # A^{-1} in f64 from each package's f32 factors, rtol 1e-4: f32
    # elimination in two orders at cond(A) ~ 10
    normwise_close(_inverse(Xt.astype(np.float64), dt.astype(np.float64)),
                   _inverse(np.asarray(Xj, np.float64),
                            np.asarray(dj, np.float64)), 1e-4)
    np.testing.assert_array_equal(np.sign(dt), np.sign(np.asarray(dj)))
    assert (dt[:, :n_pos] > 0).all() and (dt[:, n_pos:] < 0).all()
    # X is unit lower triangular
    assert np.all(np.triu(Xt, 1) == 0.0)
    np.testing.assert_array_equal(np.diagonal(Xt, axis1=1, axis2=2), 1.0)


# (matrix, positive pivots, panel width nb) for the blocked plain version:
# a multiple of nb, a not a multiple of nb, a <= nb, and mixed pivot signs
BLOCKED_CASES = {
    "spd_4x64_nb16": lambda rng: (_spd(rng, 4, 64), 64, 16),
    "spd_2x100_nb32": lambda rng: (_spd(rng, 2, 100), 100, 32),
    "spd_3x12_nb16": lambda rng: (_spd(rng, 3, 12), 12, 16),
    "quasidef_1x40_nb16": lambda rng: (_quasidefinite(rng, 1, 40, 24), 24,
                                       16),
    "quasidef_2x100_nb32": lambda rng: (_quasidefinite(rng, 2, 100, 36), 36,
                                        32),
}


@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_blocked_f64_matches_column_version(case):
    A, n_pos, nb = BLOCKED_CASES[case](np.random.default_rng(4))
    At = torch.from_numpy(A)
    Xb, db = ldl.ldl_inverse_factors_blocked_ref(At, nb)
    Xc, dc = ldl.ldl_inverse_factors_ref(At)
    # the same factors in another order of f64 sums at cond(A) ~ 10
    normwise_close(Xb.numpy(), Xc.numpy(), 1e-12)
    normwise_close(db.numpy(), dc.numpy(), 1e-12)
    assert (db[:, :n_pos] > 0).all() and (db[:, n_pos:] < 0).all()
    assert np.all(np.triu(Xb.numpy(), 1) == 0.0)


@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_blocked_f32_matches_pallas_interpret(case):
    import jax.numpy as jnp
    from pips_ipmpp_tpu.linalg import pallas_ldl

    A, n_pos, nb = BLOCKED_CASES[case](np.random.default_rng(5))
    A32 = A.astype(np.float32)
    Xj, dj = pallas_ldl.ldl_inverse_factors(jnp.asarray(A32), interpret=True)
    Xb, db = ldl.ldl_inverse_factors_blocked_ref(torch.from_numpy(A32), nb)
    assert Xb.dtype == torch.float32
    Xb, db = Xb.numpy(), db.numpy()
    # as test_plain_f32_matches_pallas_interpret: f32 elimination in two
    # orders at cond(A) ~ 10
    normwise_close(_inverse(Xb.astype(np.float64), db.astype(np.float64)),
                   _inverse(np.asarray(Xj, np.float64),
                            np.asarray(dj, np.float64)), 1e-4)
    np.testing.assert_array_equal(np.sign(db), np.sign(np.asarray(dj)))
    assert (db[:, :n_pos] > 0).all() and (db[:, n_pos:] < 0).all()
    np.testing.assert_array_equal(np.diagonal(Xb, axis1=1, axis2=2), 1.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_f64_matches_numpy_inverse(case):
    A, _ = CASES[case](np.random.default_rng(1))
    X, d = ldl.ldl_inverse_factors(torch.from_numpy(A))
    inv = ldl.inverse_from_factors(X, d).numpy()
    # f64 rounding at cond(A) ~ 10
    normwise_close(inv, np.linalg.inv(A), 1e-10)
    normwise_close(ldl.batched_inverse(torch.from_numpy(A)).numpy(),
                   np.linalg.inv(A), 1e-10)


def test_inverse_ok_inertia():
    import jax.numpy as jnp
    from pips_ipmpp_tpu.linalg import pallas_ldl

    rng = np.random.default_rng(2)
    A = torch.from_numpy(_quasidefinite(rng, 2, 12, 5))
    X, d = ldl.ldl_inverse_factors(A)
    assert bool(ldl.inverse_ok(X, d, n_pos=5))
    assert not bool(ldl.inverse_ok(X, d, n_pos=6))    # wrong inertia
    assert not bool(ldl.inverse_ok(X, d))             # not SPD
    Xs, ds = ldl.ldl_inverse_factors(torch.from_numpy(_spd(rng, 2, 12)))
    assert bool(ldl.inverse_ok(Xs, ds))
    bad = Xs.clone()
    bad[0, 3, 1] = float("nan")
    assert not bool(ldl.inverse_ok(bad, ds))
    zero = ds.clone()
    zero[1, 4] = 0.0
    assert not bool(ldl.inverse_ok(Xs, zero))
    # agrees with the JAX health check on the same factors
    assert bool(pallas_ldl.inverse_ok(jnp.asarray(X.numpy()),
                                      jnp.asarray(d.numpy()), 5))


def test_cpu_tensor_never_counts_a_launch():
    before = ldl.ldl_inverse_factors.launches
    ldl.ldl_inverse_factors(torch.eye(3, dtype=torch.float32)[None])
    ldl.batched_inverse(torch.eye(4, dtype=torch.float64).repeat(2, 1, 1))
    assert ldl.ldl_inverse_factors.launches == before


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    # one-launch edges (a <= 64, a <= 128), a = 4 nb, a not a multiple of
    # nb, a quasidefinite B = 1 root, and an edge past the old kernel's
    # shared-memory cap (1760)
    for A, n_pos in (CASES["spd_4x64"](rng), CASES["quasidef_1x40"](rng),
                     (_quasidefinite(rng, 2, 100, 36), 36),
                     (_spd(rng, 8, 256), 256), (_spd(rng, 2, 300), 300),
                     (_quasidefinite(rng, 1, 192, 64), 64),
                     (_spd(rng, 1, 1800), 1800)):
        A32 = torch.from_numpy(A.astype(np.float32)).cuda()
        before = ldl.ldl_inverse_factors.launches
        Xk, dk = ldl.ldl_inverse_factors(A32)
        torch.cuda.synchronize()
        assert ldl.ldl_inverse_factors.launches == before + 1
        Xp, dp = ldl.ldl_inverse_factors_ref(A32)
        ref = np.linalg.inv(A)
        err_k = np.abs(ldl.inverse_from_factors(Xk.double(), dk.double())
                       .cpu().numpy() - ref).max()
        err_p = np.abs(ldl.inverse_from_factors(Xp.double(), dp.double())
                       .cpu().numpy() - ref).max()
        # the kernel's f32 error is of the plain f32 version's size
        assert err_k <= 4 * err_p + 1e-6 * np.abs(ref).max()
        assert torch.equal(torch.sign(dk), torch.sign(dp))
        assert bool(ldl.inverse_ok(Xk, dk, n_pos))
