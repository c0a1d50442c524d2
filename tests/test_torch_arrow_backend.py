"""`factorize` + `solve_reduced` of the PyTorch ArrowBackend against the
JAX ArrowBackend on one iterate: the f64 Cholesky path, with and without
explicit inverses (rtol 1e-10), and the
f32 LDL^T path with explicit and with factored leaf inverses (rtol 1e-4;
the JAX LDL kernel runs in Pallas interpret mode).  The JAX side runs
under `jax.jit`, as its IPM runs it: eagerly it took most of this
file's time (22 s for the f32 case)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
from pips_ipmpp_tpu.ipm import formulation as JF
from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend as JArrow
from pips_ipmpp_tpu_torch import bridge
from pips_ipmpp_tpu_torch.ipm import formulation as TF
from pips_ipmpp_tpu_torch.linalg import ldl
from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend as TArrow
from torch_parity import (jax_fields, jspace, normwise_close, np_tree,
                          random_iterate)

DIMS = dict(N=2, n=24, mE=10, mI=8, n0=4, m0E=2, m0I=2, mEl=3, mIl=2)

# (factor dtype, backend kwargs, refinement sweeps, rtol).  The f32 modes
# run without refinement so the comparison sees the factors' own f32
# error (cond ~1e3 systems: 1e-4 normwise).
MODES = {
    "f64_cholesky": (np.float64, {}, 1, 1e-10),
    "f64_cholesky_explicit": (np.float64, {"explicit_inverse": True}, 1,
                              1e-10),
    "f32_ldl_explicit": (np.float32, {}, 0, 1e-4),
    "f32_ldl_factored": (np.float32, {"factored_inverse": True}, 0, 1e-4),
}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(9)
    jlp = random_arrowhead_lp(4, **DIMS)
    it = random_iterate(rng, jlp, True)
    d = random_iterate(rng, jlp, False)
    return jlp, it, d


def _solve(F, be, it, d, sigma_mu, delta, steps):
    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, delta, delta)
    comp = F.comp_rhs_corrector(be, it, d, sigma_mu)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    return fac, be.solve_reduced(fac, rhs, steps)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_factorize_and_solve_match_jax(problem, mode):
    fd, kw, steps, rtol = MODES[mode]
    jlp, it, d = problem
    jbe = JArrow(jlp, factor_dtype=jnp.dtype(fd), **kw)
    tbe = TArrow(bridge.lp_from_numpy(jax_fields(jlp), device="cpu",
                                      dtype=torch.float64),
                 factor_dtype=getattr(torch, np.dtype(fd).name), **kw)
    assert tbe.ldl_kernel == jbe.ldl_kernel
    assert tbe.factored_inverse == jbe.factored_inverse
    jfac, jsol = jax.jit(lambda it_, d_: _solve(
        JF, jbe, it_, d_, jnp.asarray(0.3), 1e-8, steps))(
        JF.Iterate(**{k: jspace(v) for k, v in it.items()}),
        JF.Iterate(**{k: jspace(v) for k, v in d.items()}))
    before = ldl.ldl_inverse_factors.launches
    tfac, tsol = _solve(TF, tbe,
                        bridge.iterate_from_numpy(it, device="cpu",
                                                  dtype=torch.float64),
                        bridge.iterate_from_numpy(d, device="cpu",
                                                  dtype=torch.float64),
                        torch.tensor(0.3, dtype=torch.float64), 1e-8, steps)
    assert ldl.ldl_inverse_factors.launches == before   # CPU: plain version
    assert bool(tfac.ok) and bool(jfac.ok)
    got, want = np_tree(tsol), np_tree(jsol)
    for g, w in zip(got, want):
        for part in w:
            normwise_close(g[part], w[part], rtol)
    # the factors' solve agrees on the Schur caches too
    normwise_close(np_tree(tfac.Um), np_tree(jfac.Um), rtol)
    normwise_close(np_tree(tfac.Ux), np_tree(jfac.Ux), rtol)
    if tbe.ldl_kernel:
        normwise_close(np_tree(tfac.Sinv), np_tree(jfac.Sinv), rtol)


def test_root_escalation_recovers_wrong_inertia(problem):
    """A root made indefinite in its primal block fails the inertia check
    at zero shift; the in-place escalation finds a shift that passes, and
    the JAX backend lands on the same shift."""
    jlp, it, d = problem
    tlp = bridge.lp_from_numpy(jax_fields(jlp), device="cpu",
                               dtype=torch.float64)
    tbe = TArrow(tlp, factor_dtype=torch.float32)
    jbe = JArrow(jlp, factor_dtype=jnp.float32)
    tit = bridge.iterate_from_numpy(it, device="cpu", dtype=torch.float64)
    jit = JF.Iterate(**{k: jspace(v) for k, v in it.items()})
    Dx, Ominv = TF.kkt_diagonals(tbe, tit)
    jDx, jOminv = JF.kkt_diagonals(jbe, jit)
    # a strongly negative first-stage diagonal breaks the S11 inertia
    Dx.first = Dx.first - 50.0
    jDx.first = jDx.first - 50.0
    tfac = tbe.factorize(Dx, Ominv, 1e-8, 1e-8)
    jfac = jax.jit(lambda a, b: jbe.factorize(a, b, 1e-8, 1e-8))(jDx,
                                                                 jOminv)
    assert float(tfac.extra_root) > 0.0
    np.testing.assert_allclose(float(tfac.extra_root),
                               float(jfac.extra_root), rtol=1e-6)
    assert bool(tfac.ok) == bool(jfac.ok)
