"""Checkpoint/resume (`ipm/checkpoint.py`, `IPMSolver.solve(checkpoint_path=,
checkpoint_every=, resume=)`) and the resource monitor (`utils/monitor.py`)
of the PyTorch port, against the JAX package: the counterpart of
`tests/test_checkpoint.py`.

Both packages write one file format, so a checkpoint crosses between them:
each package loads the other's file to the same leaves, bit for bit, and a
solve resumed from one file takes the same iterations in both, with
objectives 1e-10 apart in f64.  One JAX solver runs both of its solves (an
interrupted one that writes its own file, then the resume of the port's
file): one JAX compile."""
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu_torch.core.options import Options
from pips_ipmpp_tpu_torch.core.spaces import leaves
from pips_ipmpp_tpu_torch.core.status import TerminationStatus
from pips_ipmpp_tpu_torch.io.synthetic import random_arrowhead_lp
from pips_ipmpp_tpu_torch.ipm.checkpoint import (_flatten_iterate,
                                                 load_checkpoint,
                                                 save_checkpoint)
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu_torch.linalg.dense_backend import (DenseBackend,
                                                       random_dense_lp)
from pips_ipmpp_tpu_torch.utils.monitor import (ResourceMonitor, Statistics,
                                                profiler_trace)
import torch_parity  # noqa: F401  (one torch thread)

# the LP of tests/test_checkpoint.py::test_resume_reaches_same_solution,
# stopped after 6 iterations with a checkpoint every 2
SEED, N, STOP, EVERY = 1, 4, 6, 2


class _Stop(Exception):
    pass


def _solver(**opts):
    return IPMSolver(ArrowBackend, Options(**opts), device="cpu")


def _assert_same_leaves(la, lb):
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's uninterrupted, interrupted and resumed solves, and the
    JAX package's interrupted solve (its own file) and its resume of the
    port's file."""
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp as jax_lp
    from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend as JArrow

    d = tmp_path_factory.mktemp("ckpt")
    port_file, jax_file = str(d / "port.npz"), str(d / "jax.npz")
    lp = random_arrowhead_lp(SEED, N=N)
    full = _solver().solve(lp)
    stopped = _solver(max_iterations=STOP).solve(
        lp, checkpoint_path=port_file, checkpoint_every=EVERY)
    resumed = _solver().solve(lp, checkpoint_path=port_file, resume=True)

    def stop(k, it, info):
        if k + 1 == STOP:
            raise _Stop

    jsolver = JIPMSolver(JArrow, JOptions())
    jlp = jax_lp(SEED, N=N)
    with pytest.raises(_Stop):
        jsolver.solve(jlp, callback=stop, checkpoint_path=jax_file,
                      checkpoint_every=EVERY)
    jresumed = jsolver.solve(jlp, checkpoint_path=port_file, resume=True)
    return dict(full=full, stopped=stopped, resumed=resumed,
                jresumed=jresumed, port_file=port_file, jax_file=jax_file)


def test_checkpoint_roundtrip_arrow(tmp_path):
    res = _solver(max_iterations=5).solve(random_arrowhead_lp(0, N=3))
    p = str(tmp_path / "ck.npz")
    # a shift as the host loop passes it (a 0-dim tensor) or as a number
    dp = torch.tensor(1e-9, dtype=torch.float64)
    save_checkpoint(p, res.iterate, 5, dp, 1e-9, extra={"note": "t"})
    it2, k, dp, dd, extra = load_checkpoint(p)
    assert k == 5 and dp == dd == 1e-9 and extra["note"] == "t"
    for a, b in zip(leaves(res.iterate), leaves(it2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_dense(tmp_path):
    res = IPMSolver(DenseBackend, Options(max_iterations=4),
                    device="cpu").solve(random_dense_lp(2, n=15, mE=5, mI=8))
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, res.iterate, 4, 1e-10, 1e-10)
    it2, k, _, _, _ = load_checkpoint(p, dtype=torch.float32)
    assert k == 4 and it2.x.dtype == torch.float32
    assert torch.equal(it2.x, res.iterate.x.to(torch.float32))
    assert torch.equal(load_checkpoint(p)[0].x, res.iterate.x)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(runs, writer):
    """Either package's file loads in the other to the same leaves, the
    same iteration and the same shifts."""
    from pips_ipmpp_tpu.ipm import checkpoint as jax_ckpt

    path = runs[f"{writer}_file"]
    it, k, dp, dd, extra = load_checkpoint(path)
    jit, jk, jdp, jdd, jextra = jax_ckpt.load_checkpoint(path)
    assert (k, dp, dd, extra) == (jk, jdp, jdd, jextra)
    assert k == STOP and dp > 0.0 and dd > 0.0
    _assert_same_leaves([t.numpy() for t in _flatten_iterate(it)[0]],
                        [np.asarray(x) for x in
                         jax_ckpt._flatten_iterate(jit)[0]])


def test_resumed_solve_matches_jax_resume(runs):
    """The port's and the JAX package's resumes of one file."""
    res, jres = runs["resumed"], runs["jresumed"]
    assert res.status.name == jres.status.name == "SUCCESSFUL_TERMINATION"
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(res.objective, float(jres.objective),
                               rtol=1e-10)


def test_resume_reaches_same_solution(runs):
    """tests/test_checkpoint.py:39-45's bounds, and the interrupted solve
    stopped where it was told."""
    full, stopped, resumed = runs["full"], runs["stopped"], runs["resumed"]
    assert full.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert stopped.status == TerminationStatus.MAX_ITS_EXCEEDED
    assert stopped.iterations == STOP
    assert resumed.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(resumed.objective - full.objective) < 1e-6
    # the resumed run starts at iteration 6, so the count is comparable
    assert resumed.iterations >= STOP


def test_monitor(tmp_path):
    mon = ResourceMonitor()
    with mon.phase("factorize"):
        pass
    with mon.phase("factorize"):
        pass
    with mon.phase("solve"):
        pass
    rep = mon.report()
    assert rep["factorize"]["count"] == 2
    assert rep["solve"]["count"] == 1
    assert "factorize" in mon.pretty()

    st = Statistics()
    st.record(0, 1.0, 1e-2, 1e-3, 1e-2, 0.9, 0.8, 1)
    st.record(1, 0.9, 1e-4, 1e-5, 1e-4, 0.99, 0.95, 0)
    s = st.summary()
    assert s["iterations"] == 2 and s["final_mu"] == 1e-4

    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(3) + 1.0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
