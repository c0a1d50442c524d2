"""The whole PyTorch main path — facade, equilibrium scaler, Mehrotra/
Gondzio IPM, ArrowBackend — against the JAX package on one small LP.

One JAX run, the f64 facade, is the reference of every test here: the
port's f32 LDL^T path is held to it with the bounds its f32 parity test
held against the JAX package's own f32 run (which ran its LDL kernel
through the Pallas interpreter, most of this file's time): the same
status, iterations within 2, the objective within 1e-4.  The f32 kernel
path's parity with the JAX package's f32 path is held by
tests/test_torch_arrow_backend.py (factorize and solve) and
tests/test_torch_ldl.py (the kernel against the Pallas interpreter)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_ipmpp_tpu import PIPSIPMppTPUInterface
from pips_ipmpp_tpu.core.options import Options as JOptions
from pips_ipmpp_tpu.core.options import ScalerType as JScalerType
from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp as jax_lp
from pips_ipmpp_tpu_torch import (Options, PIPSIPMppTorchInterface,
                                  TerminationStatus)
from pips_ipmpp_tpu_torch.core.options import ScalerType
from pips_ipmpp_tpu_torch.io.synthetic import random_arrowhead_lp
from torch_parity import jax_fields, np_tree

DIMS = dict(N=2, n=48, mE=32, mI=32, n0=4, m0E=2, m0I=2, mEl=2, mIl=2)


def _jax_run(dtype, factor_dtype):
    iface = PIPSIPMppTPUInterface(
        jax_lp(0, dtype=dtype, **DIMS),
        JOptions(scaler=JScalerType.EQUILIBRIUM, max_gondzio_correctors=1,
                 factor_dtype=factor_dtype))
    status = iface.run()
    return dict(status=status.name, iterations=iface.n_iterations,
                objective=iface.getObjective(),
                mu=[h.mu for h in iface.result.history])


def _torch_run(dtype, factor_dtype):
    iface = PIPSIPMppTorchInterface(
        random_arrowhead_lp(0, dtype=dtype, **DIMS),
        Options(scaler=ScalerType.EQUILIBRIUM, max_gondzio_correctors=1,
                factor_dtype=factor_dtype), device="cpu")
    status = iface.run()
    return dict(status=status.name, iterations=iface.n_iterations,
                objective=iface.getObjective(),
                mu=[h.mu for h in iface.result.history],
                x=iface.gatherPrimalSolution(), iface=iface)


@pytest.fixture(scope="module")
def jax_f64():
    return _jax_run(jnp.float64, "float64")


@pytest.fixture(scope="module")
def torch_f64():
    return _torch_run(torch.float64, "auto")       # CPU: f64 factors


@pytest.fixture(scope="module")
def torch_f32():
    return _torch_run(torch.float32, "float32")    # the LDL^T path


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generator_is_bit_identical(dtype):
    want = jax_fields(jax_lp(0, dtype=getattr(jnp, dtype), **DIMS))
    got = np_tree(random_arrowhead_lp(0, dtype=getattr(torch, dtype),
                                      **DIMS))
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_f64_matches_jax(torch_f64, jax_f64):
    assert torch_f64["status"] == jax_f64["status"] == \
        "SUCCESSFUL_TERMINATION"
    assert torch_f64["iterations"] == jax_f64["iterations"]
    np.testing.assert_allclose(torch_f64["objective"], jax_f64["objective"],
                               rtol=1e-9)


def test_f64_mu_history_matches_jax(torch_f64, jax_f64):
    assert len(torch_f64["mu"]) == len(jax_f64["mu"])
    np.testing.assert_allclose(torch_f64["mu"], jax_f64["mu"], rtol=1e-8)


def test_f32_ldl_path_matches_jax_f32(torch_f32, jax_f64):
    """The f32 LDL^T path against the JAX package's f64 run, with the bounds
    this test held against its f32 run."""
    assert torch_f32["status"] == jax_f64["status"] == \
        "SUCCESSFUL_TERMINATION"
    assert abs(torch_f32["iterations"] - jax_f64["iterations"]) <= 2
    np.testing.assert_allclose(torch_f32["objective"], jax_f64["objective"],
                               rtol=1e-4)


def test_f32_ldl_path_matches_f64(torch_f32, jax_f64):
    # the JAX package's own f32-vs-f64 bound (tests/test_pallas.py:28)
    np.testing.assert_allclose(torch_f32["objective"], jax_f64["objective"],
                               rtol=1e-3)


def test_facade_surface(torch_f64):
    iface = torch_f64["iface"]
    assert iface.result.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert set(iface.phase_times) == {"scale", "solve"}
    x = torch_f64["x"]
    lp = iface.lp
    assert x.shape == (lp.n0 + lp.N * lp.n,) and np.all(np.isfinite(x))
    c = np.concatenate([lp.c0.numpy(), lp.cN.numpy().reshape(-1)])
    np.testing.assert_allclose(float(c @ x), torch_f64["objective"],
                               rtol=1e-12)


def test_facade_rejects_unported_input():
    lp = random_arrowhead_lp(0, N=2, n=3, mE=1, mI=1, n0=2, m0E=1, m0I=1,
                             mEl=1, mIl=1)
    with pytest.raises(TypeError):
        PIPSIPMppTorchInterface(object(), device="cpu")
    # the hierarchy is ported: the facade builds (and runs it in run())
    hier = PIPSIPMppTorchInterface(lp, Options(hierarchical=True),
                                   device="cpu")
    with pytest.raises(RuntimeError):
        hier.getObjective()                  # before run()
    # so are the banded modes: the facade plans and routes them
    from pips_ipmpp_tpu_torch.linalg.band_backend import BandArrowBackend
    band = PIPSIPMppTorchInterface(lp, Options(banded_leaf=True),
                                   device="cpu")
    assert band.backend_class is BandArrowBackend
    if not torch.cuda.is_available():
        # the default device is the card: nothing falls back to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            PIPSIPMppTorchInterface(lp)
    iface = PIPSIPMppTorchInterface(lp, device="cpu")
    with pytest.raises(RuntimeError):
        iface.getObjective()                 # before run()
