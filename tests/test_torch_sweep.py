"""The PyTorch sweep inverse (linalg/sweep.py) and the plain mirror of the
CUDA kernel's 64-column algorithm against the JAX Pallas kernel
(interpret mode, its default off TPU), the opt-in
`ArrowBackend(sweep_kernel=True)` solve against the JAX package's, and the
CUDA kernel against the plain version on a card.

JAX is imported inside the tests that compare with it, so that on a
machine with a card and no JAX the kernel test runs alone:
`python -m pytest --noconftest -m gpu tests/test_torch_sweep.py`."""
from functools import partial

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)

from pips_ipmpp_tpu_torch.linalg import sweep


def _spd(rng, B, a):
    M = rng.standard_normal((B, a, a))
    return M @ np.swapaxes(M, 1, 2) / a + 2.0 * np.eye(a)


def _quasidefinite(rng, n=24, m=40):
    """[[E, M'], [M, -F]] with diagonal E, F > 0 (tests/test_sweep.py)."""
    E = np.diag(rng.uniform(0.5, 2.0, n))
    F = np.diag(rng.uniform(0.5, 2.0, m))
    M = rng.standard_normal((m, n))
    return np.block([[E, M.T], [M, -F]])[None], n


CASES = {f"spd_{a}": (lambda rng, a=a: (_spd(rng, 2, a), a))
         for a in (5, 16, 37, 48)}
CASES["quasidef_64"] = _quasidefinite


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    import jax.numpy as jnp
    from pips_ipmpp_tpu.linalg.pallas_sweep import sweep_inverse

    # seed 1 gives the quasidefinite matrix of tests/test_sweep.py
    A, n_pos = CASES[case](np.random.default_rng(1))
    Ij, dj = sweep_inverse(jnp.asarray(A), interpret=True)
    It, dt = sweep.sweep_inverse(torch.from_numpy(A))
    assert It.dtype == torch.float64 and It.shape == A.shape
    assert dt.shape == A.shape[:2]
    Ij, dj, It, dt = map(np.asarray, (Ij, dj, It, dt))
    # f64, the same panel order: rounding only, which the unpivoted
    # sweep amplifies on the quasidefinite case (tests/test_sweep.py holds
    # that case to 1e-9)
    tol = 1e-9 if case.startswith("quasidef") else 1e-10
    assert np.abs(It - Ij).max() <= tol * np.abs(Ij).max()
    np.testing.assert_array_equal(np.sign(dt), np.sign(dj))
    assert (dt[:, :n_pos] > 0).all() and (dt[:, n_pos:] < 0).all()
    eye = np.eye(A.shape[1])
    assert np.abs(It @ A - eye).max() < 1e-9


# (case, panel width): a = 100 at nb = 32 pads to 112, panels 32, 32, 32 and
# a ragged 16; at nb = 64, panels 64 and 48; the quasidefinite 64 x 64 in
# two panels
BLOCKED = {"spd_100_nb32": (lambda rng: (_spd(rng, 2, 100), 100), 32),
           "spd_100_nb64": (lambda rng: (_spd(rng, 2, 100), 100), 64),
           "quasidef_64_nb32": (_quasidefinite, 32)}


@pytest.mark.parametrize("case", sorted(BLOCKED))
def test_blocked_plain_matches_pallas_interpret(case):
    import jax.numpy as jnp
    from pips_ipmpp_tpu.linalg.pallas_sweep import sweep_inverse

    make, nb = BLOCKED[case]
    A, n_pos = make(np.random.default_rng(1))
    Ij, dj = sweep_inverse(jnp.asarray(A), interpret=True)
    Ib, db = sweep.sweep_inverse_blocked_ref(torch.from_numpy(A), nb)
    assert Ib.dtype == torch.float64 and Ib.shape == A.shape
    Ij, dj, Ib, db = map(np.asarray, (Ij, dj, Ib, db))
    # f64, wider panels: the same sweep in exact arithmetic, so rounding
    # only, held to the bounds of the same-order comparison above
    tol = 1e-9 if case.startswith("quasidef") else 1e-10
    assert np.abs(Ib - Ij).max() <= tol * np.abs(Ij).max()
    # the pivots are the same quantities as the 16-column kernel's
    assert (np.abs(db - dj) <= 1e-10 * np.abs(dj)).all()
    np.testing.assert_array_equal(np.sign(db), np.sign(dj))
    assert (db[:, :n_pos] > 0).all() and (db[:, n_pos:] < 0).all()


def test_blocked_plain_at_16_is_the_reference_order():
    A = torch.from_numpy(_spd(np.random.default_rng(4), 2, 40))
    for got, want in zip(sweep.sweep_inverse_blocked_ref(A, 16),
                         sweep.sweep_inverse_ref(A)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        sweep.sweep_inverse_blocked_ref(A, 24)


def test_f32_plain_keeps_dtype_and_inertia():
    rng = np.random.default_rng(3)
    A = _spd(rng, 2, 40)
    Ai, d = sweep.sweep_inverse(torch.from_numpy(A.astype(np.float32)))
    assert Ai.dtype == torch.float32 and d.dtype == torch.float32
    ref = np.linalg.inv(A)
    assert np.abs(Ai.double().numpy() - ref).max() < 1e-5 * np.abs(ref).max()
    assert bool((d > 0).all())
    # quasidefinite: the inertia survives f32 even where the unpivoted
    # sweep loses accuracy
    Q, n_pos = _quasidefinite(rng)
    _, dq = sweep.sweep_inverse(torch.from_numpy(Q.astype(np.float32)))
    assert bool((dq[:, :n_pos] > 0).all() and (dq[:, n_pos:] < 0).all())


def test_sweep_switch_needs_the_ldl_kernel():
    from pips_ipmpp_tpu_torch.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend

    lp = random_arrowhead_lp(0, N=2, n=8, mE=4, mI=4, n0=4, m0E=2, m0I=2,
                             mEl=2, mIl=2)
    f32 = torch.float32
    assert not ArrowBackend(lp, factor_dtype=f32).sweep_kernel  # off
    assert ArrowBackend(lp, factor_dtype=f32, sweep_kernel=True).sweep_kernel
    assert not ArrowBackend(lp, factor_dtype=torch.float64,
                            sweep_kernel=True).sweep_kernel
    assert not ArrowBackend(lp, factor_dtype=f32, sweep_kernel=True,
                            factored_inverse=True).sweep_kernel


@pytest.fixture(scope="module")
def sweep_solves():
    """The JAX package's own sweep acceptance LP (tests/fixtures.py
    two_scenario_linking_lp, optimum 7) in f32 through both packages'
    sweep paths, the port's calls to the sweep counted."""
    import jax.numpy as jnp
    from fixtures import two_scenario_linking_lp
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import \
        ArrowBackend as JArrowBackend
    from torch_parity import jax_fields

    from pips_ipmpp_tpu_torch import Options, bridge
    from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
    from pips_ipmpp_tpu_torch.linalg import arrow_backend

    jlp, obj_star = two_scenario_linking_lp(jnp.float32)
    jres = JIPMSolver(partial(JArrowBackend, factor_dtype=jnp.float32,
                              sweep_kernel=True),
                      JOptions(refinement_steps=2)).solve(jlp)
    lp = bridge.lp_from_numpy(jax_fields(jlp), device="cpu",
                              dtype=torch.float32)
    calls = []
    real = arrow_backend.sweep_inverse

    def counted(A):
        calls.append(tuple(A.shape))
        return real(A)

    arrow_backend.sweep_inverse = counted
    try:
        res = IPMSolver(partial(arrow_backend.ArrowBackend,
                                factor_dtype=torch.float32,
                                sweep_kernel=True),
                        Options(refinement_steps=2), device="cpu").solve(lp)
    finally:
        arrow_backend.sweep_inverse = real
    return jres, res, obj_star, calls


def test_sweep_solve_matches_jax(sweep_solves):
    jres, res, obj_star, _ = sweep_solves
    assert res.status.name == jres.status.name == "SUCCESSFUL_TERMINATION"
    assert abs(res.iterations - jres.iterations) <= 2
    np.testing.assert_allclose(res.objective, float(jres.objective),
                               rtol=1e-3)
    # the JAX package's f32-vs-oracle bound (tests/test_pallas.py:28)
    assert abs(res.objective - obj_star) < 1e-3 * (1.0 + abs(obj_star))


def test_sweep_solve_inverts_leaves_and_root(sweep_solves):
    _, res, _, calls = sweep_solves
    leaves = [s for s in calls if s[0] == 2]        # N = 2 leaf batch
    roots = [s for s in calls if s[0] == 1]
    assert leaves and roots and len(leaves) + len(roots) == len(calls)


def test_cpu_tensor_never_counts_a_launch():
    before = sweep.sweep_inverse.launches
    sweep.sweep_inverse(torch.eye(20, dtype=torch.float32)[None])
    sweep.sweep_inverse(torch.eye(16, dtype=torch.float64).repeat(3, 1, 1))
    assert sweep.sweep_inverse.launches == before


def _root(rng, a, n_pos):
    """[[SPD, M'], [M, -SPD]]: the flagship root's quasidefinite form."""
    A = _spd(rng, 1, a)
    A[:, n_pos:, :n_pos] *= 0.5
    A[:, :n_pos, n_pos:] = np.swapaxes(A[:, n_pos:, :n_pos], 1, 2)
    A[:, n_pos:, n_pos:] *= -1.0
    return A, n_pos


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from pips_ipmpp_tpu_torch import _build

    lib = _build.load()
    rng = np.random.default_rng(8)
    # one launch (a <= 64; a = 37 pads to 38), the first pivot block and
    # two per 64-column panel (a = 256 and the root), ragged last panels
    # (a = 300: 64 x 4 + 44; a = 201 pads to 202, not a multiple of 4, so
    # the 4-byte staging runs), and an edge above the shared-memory cap of
    # 1701 of the kernel before
    for A, n_pos in (CASES["spd_37"](rng), CASES["quasidef_64"](rng),
                     (_spd(rng, 8, 256), 256), _root(rng, 192, 64),
                     (_spd(rng, 2, 300), 300), (_spd(rng, 1, 201), 201),
                     (_spd(rng, 1, 1800), 1800)):
        A32 = torch.from_numpy(A.astype(np.float32)).cuda()
        before = sweep.sweep_inverse.launches
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            Ik, dk = sweep.sweep_inverse(A32)
            torch.cuda.synchronize()
        assert sweep.sweep_inverse.launches == before + 1
        # the CUDA launches of the kernel's parts, as the profiler saw them
        launched = sum(e.count for e in prof.key_averages()
                       if "sweep_" in e.key and e.self_device_time_total > 0)
        assert launched == lib.sweep_inverse_launches(
            sweep.padded_edge(A.shape[1]))
        Ip, dp = sweep.sweep_inverse_ref(A32)
        ref = np.linalg.inv(A)
        err_k = np.abs(Ik.double().cpu().numpy() - ref).max()
        err_p = np.abs(Ip.double().cpu().numpy() - ref).max()
        # the kernel's f32 error is of the plain f32 version's size
        assert err_k <= 4 * err_p + 1e-6 * np.abs(ref).max()
        assert torch.equal(torch.sign(dk), torch.sign(dp))
        assert bool((dk[:, :n_pos] > 0).all() and (dk[:, n_pos:] < 0).all())
