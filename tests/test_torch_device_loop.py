"""The fused on-device IPM loop of the PyTorch port (`ipm/device_loop.py`,
`IPMSolver.solve_fused`), its control flow (`ipm/control.py`), and the
JAX package's `solve_fused` on the same numpy data: the counterpart of
`tests/test_device_loop.py:15-80`.

On the CPU the fused loop runs eagerly, the same arithmetic as the host
loop, so the two are held bit for bit.  Against the JAX package's fused
loop: the same status and iterations, the objective and the per-iteration
mu to 1e-10 relative; on the dense N=2 x 48 LP without residual updates
the mu history is held to 1e-9, since the two packages part there by
1.95e-10 in the last iteration, where mu is near its tolerance, as their
host loops do (each package's fused loop equals its host loop exactly).

JAX is imported inside the tests, so that the `gpu`-marked test runs on a
machine without it (`python -m pytest --noconftest -m gpu
tests/test_torch_device_loop.py`)."""
from functools import partial

import numpy as np
import pytest
import torch

from pips_ipmpp_tpu_torch import bridge
from pips_ipmpp_tpu_torch.core.options import Options
from pips_ipmpp_tpu_torch.core.status import TerminationStatus
from pips_ipmpp_tpu_torch.io.synthetic import (random_arrowhead_lp,
                                               random_sparse_arrowhead_lp)
from pips_ipmpp_tpu_torch.ipm import control
from pips_ipmpp_tpu_torch.ipm.device_loop import decode_status
from pips_ipmpp_tpu_torch.ipm.solver import (IPMSolver, backend_signature,
                                             backend_state)
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu_torch.linalg.sparse_backend import SparseArrowBackend
import torch_parity  # noqa: F401  (one torch thread)

SMALL = dict(N=2, n=48)
SPARSE_SEED = 5
SPARSE = dict(N=3, n=96, mE=48, mI=48, nnz_per_row=5, n0=6, m0E=2, m0I=2,
              mEl=2, mIl=2)
RTOL = 1e-10


def _mus(res):
    return [h.mu for h in res.history]


def _host_and_fused(be_ctor, opts, lp):
    s = IPMSolver(be_ctor, opts, device="cpu")
    return s.solve(lp), s.solve_fused(lp)


def _jax_fused(be_ctor, opts, lp):
    from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
    return JIPMSolver(be_ctor, opts).solve_fused(lp)


def _assert_matches_jax(res, jres, mu_rtol=RTOL):
    assert res.status.name == jres.status.name
    assert res.iterations == jres.iterations
    assert len(res.history) == res.iterations
    np.testing.assert_allclose(_mus(res), _mus(jres), rtol=mu_rtol)
    np.testing.assert_allclose(res.objective, float(jres.objective),
                               rtol=RTOL)


def _assert_same_run(fused, host):
    """The eager fused loop is the host loop's arithmetic."""
    assert fused.info["graph"] is False
    assert fused.status == host.status
    assert fused.iterations == host.iterations
    assert _mus(fused) == _mus(host)
    assert fused.objective == host.objective


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_matches_host_loop_arrow(seed):
    host, fused = _host_and_fused(ArrowBackend, Options(record_history=True),
                                  random_arrowhead_lp(seed, N=4))
    assert fused.status == TerminationStatus.SUCCESSFUL_TERMINATION
    _assert_same_run(fused, host)
    # retry and terminal turns write no history row
    assert fused.info["turns"] >= fused.iterations + 1
    assert fused.history[0].mu > fused.history[-1].mu


@pytest.mark.parametrize("upd,mu_rtol", [(0, 1e-9), (4, RTOL)],
                         ids=["exact", "update_every_4"])
def test_fused_matches_jax_fused(upd, mu_rtol):
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp as jax_lp
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend as JArrow

    opts = dict(record_history=True, residual_update_every=upd)
    res = IPMSolver(ArrowBackend, Options(**opts),
                    device="cpu").solve_fused(random_arrowhead_lp(0, **SMALL))
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION
    _assert_matches_jax(res, _jax_fused(JArrow, JOptions(**opts),
                                        jax_lp(0, **SMALL)), mu_rtol)


def test_fused_two_scenario():
    import jax.numpy as jnp

    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend as JArrow
    from tests.fixtures import two_scenario_linking_lp
    from torch_parity import jax_fields

    jlp, opt = two_scenario_linking_lp(jnp.float64)
    lp = bridge.lp_from_numpy(jax_fields(jlp), device="cpu",
                              dtype=torch.float64)
    res = IPMSolver(ArrowBackend, Options(record_history=True),
                    device="cpu").solve_fused(lp)
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(res.objective - opt) < 1e-6
    _assert_matches_jax(res, _jax_fused(JArrow,
                                        JOptions(record_history=True), jlp))


def test_fused_max_iterations():
    lp = random_arrowhead_lp(2, N=3)
    host, fused = _host_and_fused(ArrowBackend,
                                  Options(max_iterations=2,
                                          record_history=True), lp)
    assert fused.status == TerminationStatus.MAX_ITS_EXCEEDED
    assert fused.iterations == 2
    _assert_same_run(fused, host)


def test_fused_sparse_matches_jax():
    """The CG leaf (`sparse_densify_max_mb=0` keeps it), its stopping test
    a `dev_while`: the JAX package's fused sparse solve on the same LP."""
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.io.synthetic import \
        random_sparse_arrowhead_lp as jax_sparse_lp
    from pips_ipmpp_tpu.linalg.sparse_backend import \
        SparseArrowBackend as JSparse

    opts = dict(record_history=True, sparse_densify_max_mb=0.0)
    host, fused = _host_and_fused(
        SparseArrowBackend, Options(**opts),
        random_sparse_arrowhead_lp(SPARSE_SEED, **SPARSE))
    assert fused.status == TerminationStatus.SUCCESSFUL_TERMINATION
    _assert_same_run(fused, host)
    _assert_matches_jax(fused, _jax_fused(
        JSparse, JOptions(**opts), jax_sparse_lp(SPARSE_SEED, **SPARSE)))


def test_sparse_factorize_matches_jax_with_capped_cg():
    """F2 (ROADMAP.md §3): the factorization of the 8 x 2048 instance with
    its leaf CG capped (20 trips), so that the Schur complements built from
    its inexact solves are not symmetric.  The JAX package's
    `jnp.linalg.cholesky` factors (S + S')/2; the port factored the lower
    triangle of S (root factors 1.5e-3 and T 1.8e-2 apart), which at
    8 x 8192 took the f64 solve from 14 iterations to 29."""
    import jax
    import jax.numpy as jnp

    from pips_ipmpp_tpu.core.spaces import RVec as JRVec
    from pips_ipmpp_tpu.core.spaces import XVec as JXVec
    from pips_ipmpp_tpu.io.synthetic import \
        random_sparse_arrowhead_lp as jax_sparse_lp
    from pips_ipmpp_tpu.linalg.sparse_backend import \
        SparseArrowBackend as JSparse
    from pips_ipmpp_tpu_torch.core.spaces import RVec, XVec

    dims = dict(N=8, n=2048, mE=1024, mI=1024, nnz_per_row=10, n0=16,
                m0E=4, m0I=4, mEl=4, mIl=4)
    rng = np.random.default_rng(0)

    def spread(*shape):
        return 10.0 ** rng.uniform(-6, 6, shape)
    Dx = (spread(16), spread(8, 2048))
    Ominv = (spread(4), spread(8, 1024), spread(4))
    fac = SparseArrowBackend(random_sparse_arrowhead_lp(0, **dims),
                             cg_iters=20).factorize(
        XVec(*map(torch.from_numpy, Dx)),
        RVec(*map(torch.from_numpy, Ominv)), 1e-10, 1e-10)
    # the JAX side jitted, as its IPM runs it (eagerly: 17 s of CPU)
    jbe = JSparse(jax_sparse_lp(0, **dims), cg_iters=20)
    jfac = jax.jit(lambda Dx_, Om_: jbe.factorize(Dx_, Om_, 1e-10, 1e-10))(
        JXVec(*map(jnp.asarray, Dx)), JRVec(*map(jnp.asarray, Ominv)))
    assert bool(fac.ok) and bool(jfac.ok)
    for name in ("Um", "chol1", "chol2", "T"):
        got, want = getattr(fac, name).numpy(), np.asarray(getattr(jfac,
                                                                   name))
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max(), name


def test_leaf_cg_matches_jax_operation_by_operation():
    """F2 (ROADMAP.md §3): one leaf CG call on the 8 x 2048 instance that
    the JAX package's Tier-1 sparse test solves, with a factor diagonal
    spread over twelve decades as late in a solve.  The CG's inputs (F_d
    and the Jacobi diagonal, through the port's squared-value operator),
    one application of its operator (the port's stacked transpose and
    fused epilogues) and its first 10 trips agree with the JAX package's
    to rounding.  Past that a capped CG amplifies rounding, in both
    packages alike (`tests/torch_faults.py f2cg`)."""
    import jax.numpy as jnp

    from pips_ipmpp_tpu.core.sparse import ell_sq_diag
    from pips_ipmpp_tpu.io.synthetic import \
        random_sparse_arrowhead_lp as jax_sparse_lp
    from pips_ipmpp_tpu.linalg import sparse_backend as jsb
    from pips_ipmpp_tpu_torch.linalg import sparse_backend as tsb
    from pips_ipmpp_tpu_torch.linalg.spmv import ell_mv

    dims = dict(N=8, n=2048, mE=1024, mI=1024, nnz_per_row=10, n0=16,
                m0E=4, m0I=4, mEl=4, mIl=4)
    tbe = tsb.SparseArrowBackend(random_sparse_arrowhead_lp(0, **dims))
    jbe = jsb.SparseArrowBackend(jax_sparse_lp(0, **dims))
    rng = np.random.default_rng(0)
    Einv = 10.0 ** rng.uniform(-6, 6, (8, 2048))
    Om = 10.0 ** rng.uniform(-6, 6, (8, 1024))
    B = rng.standard_normal((8, 2048, 24))
    tE, tB = torch.from_numpy(Einv), torch.from_numpy(B)
    jE, jB = jnp.asarray(Einv), jnp.asarray(B)
    tFd = tbe._Fd(torch.from_numpy(Om), 1e-10)
    jFd = jbe._Fd(jnp.asarray(Om), 1e-10)
    np.testing.assert_array_equal(tFd.numpy(), np.asarray(jFd))
    tdinv = 1.0 / ell_mv(tbe._Msq, tE, z=tFd)
    jdinv = 1.0 / (jnp.concatenate([ell_sq_diag(jbe.lp.B, jE),
                                    ell_sq_diag(jbe.lp.D, jE)], axis=1)
                   + jFd)
    np.testing.assert_allclose(tdinv.numpy(), np.asarray(jdinv),
                               rtol=1e-15)

    def close(t, j, tol):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= tol * np.abs(j).max()
    close(tbe._neq_apply(tE, tFd, tB), jbe._neq_apply(jE, jFd, jB), 1e-15)
    X, k = tsb.batched_pcg(lambda V: tbe._neq_apply(tE, tFd, V), tB, tdinv,
                           10, 1e-12)
    jX, jk = jsb.batched_pcg(lambda V: jbe._neq_apply(jE, jFd, V), jB,
                             jdinv, 10, 1e-12)
    assert k == int(jk) == 10
    close(X, jX, 1e-13)


def test_dev_while_and_dev_cond_eager():
    x = torch.zeros(3, dtype=torch.float64)
    calls = []

    def cond(c):
        calls.append(1)
        return c[0].sum() < 10.0

    out = control.dev_while(cond, lambda c: (c[0] + 1.0, c[1] + 1), (x, 0),
                            max_trips=100)
    # 4 trips (sums 0, 3, 6, 9), 5 tests; the carry passes as it is
    assert out[1] == 4 and len(calls) == 5
    assert torch.equal(out[0], torch.full((3,), 4.0, dtype=torch.float64))
    # max_trips bounds the loop before its test runs again
    calls.clear()
    out = control.dev_while(cond, lambda c: (c[0] + 1.0, c[1] + 1), (x, 0),
                            max_trips=2)
    assert out[1] == 2 and len(calls) == 2
    # a false predicate runs no trip and returns the carry itself
    carry = (x, 7)
    assert control.dev_while(lambda c: torch.tensor(False), None, carry,
                             5) is carry
    t, f = torch.tensor(True), torch.tensor(False)
    ops = (x, torch.ones(2))
    assert control.dev_cond(f, None, None, ops) is ops
    got = control.dev_cond(t, lambda a, b: (a + 1, b * 2), None, ops)
    assert torch.equal(got[1], torch.full((2,), 2.0))
    got = control.dev_cond(f, None, lambda a, b: (a, b - 1), ops)
    assert torch.equal(got[1], torch.zeros(2))
    assert not control.capturing(x)


def test_assign_writes_in_place_without_clobbering():
    """The captured loops write each new carry into the old one's
    buffers: a swap must read both values before writing either."""
    a, b = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])
    pa = a.data_ptr()
    control._assign((a, b, 3, None), (b, a, 3, None))
    assert a.data_ptr() == pa
    assert a.tolist() == [3.0, 4.0] and b.tolist() == [1.0, 2.0]
    control._assign((a,), (5.0,))
    assert a.tolist() == [5.0, 5.0]
    with pytest.raises(ValueError):
        control._assign((a, 3), (a, 4))          # a plain leaf changed
    with pytest.raises(ValueError):
        control._assign((a,), (torch.zeros(3),))  # a shape changed


def test_backend_signature_keys_the_capture():
    """A captured solve replays for any LP whose backend has the same
    shapes and plain values; its tensors are what the replay copies."""
    sig = backend_signature(ArrowBackend(random_arrowhead_lp(0, **SMALL)))
    assert sig == backend_signature(
        ArrowBackend(random_arrowhead_lp(1, **SMALL)))
    assert sig != backend_signature(
        ArrowBackend(random_arrowhead_lp(0, N=3, n=48)))
    be = SparseArrowBackend(random_sparse_arrowhead_lp(SPARSE_SEED,
                                                       **SPARSE))
    paths = [p for p, v in backend_state(be) if isinstance(v, torch.Tensor)]
    assert "be._M.val" in paths and "be.lp.c0" in paths
    assert decode_status(0) == TerminationStatus.MAX_ITS_EXCEEDED


@pytest.mark.gpu
def test_cuda_captured_matches_eager_flagship():
    """The flagship (64 blocks of 256 columns, f32 factors through the LDL
    kernel) as one captured graph against the host loop on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured loop has no CPU mode")
    from pips_ipmpp_tpu_torch.core.options import ScalerType
    from pips_ipmpp_tpu_torch.linalg import ldl
    from pips_ipmpp_tpu_torch.scale import make_scaler

    lp = make_scaler(ScalerType.EQUILIBRIUM).scale(random_arrowhead_lp(
        0, N=64, n=256, mE=128, mI=128, n0=64, m0E=32, m0I=32, mEl=32,
        mIl=32, dtype=torch.float32, device="cuda"))
    solver = IPMSolver(partial(ArrowBackend, factor_dtype=torch.float32),
                       Options(max_gondzio_correctors=1), device="cuda")
    host = solver.solve(lp)
    before = ldl.ldl_inverse_factors.launches
    fused = solver.solve_fused(lp)
    assert fused.info["graph"] is True
    assert ldl.ldl_inverse_factors.launches > before
    assert fused.status == host.status
    assert fused.iterations == host.iterations
    assert abs(fused.objective - host.objective) <= \
        1e-6 * max(abs(host.objective), 1.0)
    again = solver.solve_fused(lp)          # a replay of the same graph
    assert again.iterations == fused.iterations
    assert again.objective == fused.objective


@pytest.mark.gpu
def test_cuda_captured_control_flow():
    """Nested WHILE nodes and a two-branch IF captured into one graph,
    replayed: the values of the eager loops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: conditional nodes have no CPU mode")
    dev = torch.device("cuda")
    control.prepare(dev)
    y, x = torch.zeros(4, device=dev), torch.zeros((), device=dev)

    def inner(c):
        return control.dev_while(lambda d: d[1] < 3,
                                 lambda d: (d[0] + 1.0, d[1] + 1), c, 10)

    def run():
        out = control.dev_while(
            lambda c: c[0].sum() < 40.0,
            lambda c: (inner((c[0], torch.zeros((), dtype=torch.int32,
                                                device=dev)))[0], c[1] + 1),
            (y, x.clone()), 100)
        branch = control.dev_cond(out[1] > 2, lambda a: (a * 2,),
                                  lambda a: (a - 1,), (out[1],))
        return out, branch

    (want_y, want_x), want_b = run()              # eager
    torch.cuda.synchronize()
    with control.capture(dev) as graph:
        (got_y, got_x), got_b = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got_y, want_y) and torch.equal(got_x, want_x)
    assert torch.equal(got_b[0], want_b[0])
    assert got_y.tolist() == [12.0] * 4 and got_b[0].item() == 8.0
