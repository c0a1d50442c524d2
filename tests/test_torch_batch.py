"""The fused batch solve of the PyTorch port
(`IPMSolver.solve_fused_batch_async`: B same-shape LPs as one solve over a
leading batch axis) against the JAX package's `solve_fused_batch_async`
(`jax.vmap` of its device loop) and against the port's own single
`solve_fused`, LP by LP: the counterpart of
`tests/test_device_loop.py::test_solve_fused_batch_matches_singles`.

Per LP the batch must give the status and the iteration count of that
LP's single solve and its objective within 1e-8 (relative to max(1,
|objective|)), the bound the JAX package's test sets between its batch
and its singles (1e-6 with f32 factors, below); the mu history is held to
1e-8 relative (the batch with `residual_update_every=4` parts from its
singles by 2.2e-9 in its last mu, near the tolerance).  Batched and
single solves differ only in the rounding of their reductions and
products.

On the CPU the loop runs eagerly; the `gpu`-marked test captures the
batch as one CUDA graph (`python -m pytest --noconftest -m gpu
tests/test_torch_batch.py`)."""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

from pips_ipmpp_tpu_torch import bridge
from pips_ipmpp_tpu_torch.core.lp import stack_lps
from pips_ipmpp_tpu_torch.core.options import Options
from pips_ipmpp_tpu_torch.core.status import TerminationStatus
from pips_ipmpp_tpu_torch.io.synthetic import (random_arrowhead_lp,
                                               random_sparse_arrowhead_lp)
from pips_ipmpp_tpu_torch.ipm.device_loop import decode_status
from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
from pips_ipmpp_tpu_torch.linalg import arrow_backend as ab
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend
from torch_parity import jax_fields

# the JAX package's batch test instance (tests/test_device_loop.py:52-76)
SHAPE = dict(N=4, n=24, mE=10, mI=12, n0=6, m0E=3, m0I=3, mEl=3, mIl=3)
SEED = 5
OBJ_TOL = 1e-8
# f32 factors: an f32 solve's objective is good to ~1e-7 relative here
# (seed 6 of the f32 case: batch and single 1.4e-7 apart at equal counts);
# the JAX package holds its f32 solves to 1e-4 of f64
# (tests/test_pallas.py:53)
OBJ_TOL_F32 = 1e-6


def _scaled(lp, i):
    """The JAX test's batch member i: costs times 1 + 1e-4 i."""
    return dataclasses.replace(lp, c0=lp.c0 * (1 + 1e-4 * i),
                               cN=lp.cN * (1 + 1e-4 * i))


def _assert_lp(info, i, status, iterations, objective, tol=OBJ_TOL):
    assert decode_status(int(info["status"][i])) == status
    assert int(info["iterations"][i]) == iterations
    obj = float(info["objective"][i])
    assert abs(obj - objective) <= tol * max(1.0, abs(objective))


def _batch_vs_singles(be_ctor, opts, lps):
    """Each LP's single fused solve, then the batch; per LP the same
    status, iterations, objective and, with f64 factors, mu history.  In
    f32 factors two runs of equal counts part at the factors' rounding
    late in the solve: their mu histories are not compared, and their
    objectives are held to OBJ_TOL_F32."""
    solver = IPMSolver(be_ctor, opts.replace(record_history=True),
                       device="cpu")
    singles = [solver.solve_fused(lp) for lp in lps]
    it, info = solver.solve_fused_batch_async(lps)
    assert info["graph"] is False
    assert tuple(it.x.blocks.shape) == (len(lps),) + tuple(
        lps[0].cN.shape)
    assert tuple(info["history"].mu.shape) == (len(lps), opts.max_iterations)
    f64 = solver.be_ctor(lps[0]).factor_dtype == torch.float64
    for i, s in enumerate(singles):
        _assert_lp(info, i, s.status, s.iterations, s.objective,
                   OBJ_TOL if f64 else OBJ_TOL_F32)
        if f64:
            np.testing.assert_allclose(
                info["history"].mu[i, :s.iterations].numpy(),
                [h.mu for h in s.history], rtol=1e-8)
        assert bool(torch.isnan(info["history"].mu[i, s.iterations:]).all())
    return singles, info


def test_batch_matches_jax_batch():
    """(a) The same three LPs through the JAX package's vmapped batch (one
    JAX compile) and the port's batch."""
    from pips_ipmpp_tpu.core.options import Options as JOptions
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp as jax_lp
    from pips_ipmpp_tpu.ipm.solver import IPMSolver as JIPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend as JArrow

    jlps = [_scaled(jax_lp(SEED, **SHAPE), i) for i in range(3)]
    _, jinfo = JIPMSolver(JArrow, JOptions()).solve_fused_batch_async(jlps)
    lp = bridge.lps_from_numpy([jax_fields(j) for j in jlps], device="cpu",
                               dtype=torch.float64)
    assert lp.batch_shape == (3,)
    lps = [ab.ArrowheadLP(**{f.name: getattr(lp, f.name)[i] for f in
                             dataclasses.fields(lp)}) for i in range(3)]
    _, info = IPMSolver(ArrowBackend, Options(),
                        device="cpu").solve_fused_batch_async(lps)
    for i in range(3):
        assert int(jinfo["status"][i]) == 1
        _assert_lp(info, i, TerminationStatus.SUCCESSFUL_TERMINATION,
                   int(jinfo["iterations"][i]), float(jinfo["objective"][i]))


def _root_escalations(run):
    """`run()`'s result and, per LP of the batched solves in it, whether
    the f32 root's in-factorize shift escalation fired (the LDL kernel's
    root, `extra_root` > 0; single solves' 0-dim shifts are not
    counted)."""
    fired = []
    plain = ArrowBackend._assemble_root

    def record(self, *a, **k):
        fac = plain(self, *a, **k)
        if isinstance(fac.extra_root, torch.Tensor) \
                and fac.extra_root.ndim == 1:
            fired.append(fac.extra_root > 0)
        return fac
    ArrowBackend._assemble_root = record
    try:
        out = run()
    finally:
        ArrowBackend._assemble_root = plain
    return out, (torch.stack(fired).any(0).tolist() if fired else None)


# (b) each batched LP against its own single solve.  In f64 on the
# shape above, seed 0 takes 10 iterations and seeds 2 and 3 take 11.  In
# f32 factors the iteration count of these small LPs turns on rounding
# (`tests/torch_faults.py f32batch`, ROADMAP.md §3, R1):
# `random_arrowhead_lp(6, N=2, n=48)` alone takes 13, 22 or 14 iterations
# with its costs times 1 + 1e-15 N(0, 1), and on the shape above no seed
# of 0-14 takes its single solve's count in a batch.  The f32 case takes
# the N=2, n=48 seeds 0, 6 and 5 (10, 13 and 9 iterations; the root
# escalation fires in seed 6 and not in 0 and 5), on which batch and
# singles agree; `test_batch_factorize_f32_root_escalation_per_lp` holds
# the per-LP escalation itself, operation by operation.
CASES = {
    # LPs that stop at different iterations, f64 factors: the two-level
    # root (Cholesky of S11 and of the dual Schur complement)
    "stop_apart_f64_two_level": (ArrowBackend, Options(), SHAPE, (0, 2, 3)),
    # f32 factors: leaves and root in the LDL path, the root escalation
    # per LP
    "f32_ldl_root_escalation": (
        partial(ArrowBackend, factor_dtype=torch.float32), Options(),
        dict(N=2, n=48), (0, 6, 5)),
    "residual_update_every_4": (ArrowBackend,
                                Options(residual_update_every=4), SHAPE,
                                None),
    "max_iterations_2": (ArrowBackend, Options(max_iterations=2), SHAPE,
                         None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_matches_singles(case):
    be_ctor, opts, shape, seeds = CASES[case]
    if seeds is None:
        lps = [_scaled(random_arrowhead_lp(SEED, **shape), i)
               for i in range(3)]
    else:
        lps = [random_arrowhead_lp(s, **shape) for s in seeds]
    (singles, _), fired = _root_escalations(
        lambda: _batch_vs_singles(be_ctor, opts, lps))
    if case == "stop_apart_f64_two_level":
        assert [s.iterations for s in singles] == [10, 11, 11]
    if case == "f32_ldl_root_escalation":
        assert [s.iterations for s in singles] == [10, 13, 9]
        assert fired == [False, True, False]
    if case == "max_iterations_2":
        assert all(s.status == TerminationStatus.MAX_ITS_EXCEEDED
                   and s.iterations == 2 for s in singles)


# f32 factors on the JAX test's own batch (seed 5, costs times 1 + 1e-4
# i): alone 15, 15 and 13 iterations, in the batch 16, 13 and 14.  The JAX
# package's own f32 batch parts from its singles on these LPs as well
# (singles 16, 12, 13; batch 13, 15, 14) and on seeds 0, 1, 2 and 11, by up
# to 11 iterations and 2.2e-5 relative in the objective (`PYTHONPATH=.
# python tests/torch_faults.py f32triple 5 0 1 2 11`, ROADMAP.md §3, R1),
# so the counts are not held here.  What a batching fault would break is:
# each batched LP follows its own single solve to rounding (mu to
# F32_TRAJECTORY_RTOL over the first F32_TRAJECTORY_ITERS iterations; the
# two part later, at about iteration 9, and a batch that solved another
# LP's data or merged LPs would part in the first: the costs differ by
# 1e-4), ends nearer its own single's objective than any other's, and
# gets the same answer, bit for bit, with the LPs in reverse order.
F32_TRAJECTORY_ITERS = 6
F32_TRAJECTORY_RTOL = 1e-8


def test_batch_f32_follows_its_singles_on_the_jax_batch():
    f32 = partial(ArrowBackend, factor_dtype=torch.float32)
    lps = [_scaled(random_arrowhead_lp(SEED, **SHAPE), i) for i in range(3)]
    solver = IPMSolver(f32, Options(record_history=True), device="cpu")
    singles = [solver.solve_fused(lp) for lp in lps]
    _, info = solver.solve_fused_batch_async(lps)
    _, rev = solver.solve_fused_batch_async(lps[::-1])
    for k in ("status", "iterations", "objective"):
        assert torch.equal(rev[k].flip(0), info[k])
    objs = [s.objective for s in singles]
    k = F32_TRAJECTORY_ITERS
    for i, s in enumerate(singles):
        assert s.status == TerminationStatus.SUCCESSFUL_TERMINATION
        assert decode_status(int(info["status"][i])) == s.status
        mu = torch.tensor([h.mu for h in s.history[:k]], dtype=torch.float64)
        assert len(mu) == k
        assert bool(((info["history"].mu[i, :k] - mu).abs()
                     <= F32_TRAJECTORY_RTOL * mu.abs()).all())
        obj = float(info["objective"][i])
        assert min(range(3), key=lambda j: abs(obj - objs[j])) == i


def test_batch_factorize_f32_root_escalation_per_lp():
    """One f32 factorization of three LPs' iterates in a batch, against
    each LP's own: the root shift escalation fires per LP (to 10 at the
    iterates of seeds 2 and 3 after 9 steps of their host loops, not at
    seed 0's), and every factor and flag is the single factorization's,
    bit for bit on the CPU."""
    from pips_ipmpp_tpu_torch.core.spaces import leaves, tmap
    from pips_ipmpp_tpu_torch.ipm import formulation as F

    f32 = partial(ArrowBackend, factor_dtype=torch.float32)
    lps = [random_arrowhead_lp(s, **SHAPE) for s in (0, 2, 3)]
    its = [IPMSolver(f32, Options(max_iterations=9),
                     device="cpu").solve(lp).iterate for lp in lps]
    singles = []
    for lp, it in zip(lps, its):
        be = f32(lp)
        singles.append(be.factorize(*F.kkt_diagonals(be, it), 1e-10, 1e-10))
    be = f32(stack_lps(lps))
    it = tmap(lambda *xs: torch.stack(xs), *its)
    fac = be.factorize(*F.kkt_diagonals(be, it), 1e-10, 1e-10)
    assert fac.extra_root.tolist() == [0.0, 10.0, 10.0]
    for i, single in enumerate(singles):
        for a, b in zip(leaves(fac), leaves(single)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a[i], b)


def test_stack_lps_refuses_mixed_shapes_and_sparse_batch_raises():
    """(c) stack_lps names the field whose shape differs; a batch of
    sparse LPs is not ported and raises."""
    a = random_arrowhead_lp(0, **SHAPE)
    b = random_arrowhead_lp(0, **dict(SHAPE, N=3))
    with pytest.raises(ValueError, match="field cN of LP 1"):
        stack_lps([a, b])
    with pytest.raises(ValueError, match="float32"):
        stack_lps([a, a.astype(torch.float32)])
    with pytest.raises(ValueError, match="already a stack"):
        stack_lps([stack_lps([a, a])])
    s = random_sparse_arrowhead_lp(5, N=3, n=96, mE=48, mI=48,
                                   nnz_per_row=5, n0=6, m0E=2, m0I=2, mEl=2,
                                   mIl=2)
    with pytest.raises(NotImplementedError, match="sparse batch"):
        IPMSolver(ArrowBackend, Options(),
                  device="cpu").solve_fused_batch_async([s, s])


@pytest.mark.gpu
def test_cuda_batch_graph_matches_singles():
    """On the card: the batch is one captured graph per (shape, B), replayed
    for a second batch, each LP as its own captured single solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph has no CPU mode")
    lps = [_scaled(random_arrowhead_lp(SEED, **SHAPE), i) for i in range(3)]
    solver = IPMSolver(ArrowBackend, Options(), device="cuda")
    singles = [solver.solve_fused(lp) for lp in lps]
    for order in ((0, 1, 2), (2, 1, 0)):
        _, info = solver.solve_fused_batch_async([lps[j] for j in order])
        assert info["graph"] is True
        host = {k: v.cpu() for k, v in info.items()
                if isinstance(v, torch.Tensor)}
        for i, j in enumerate(order):
            s = singles[j]
            _assert_lp(host, i, s.status, s.iterations, s.objective)
    assert len(solver._graphs) == 2        # the single shape and B = 3
