"""The PyTorch package stands alone: importing every one of its modules,
`chip_smoke.py` and `profile_port.py` pulls in neither JAX nor the JAX
package."""
import os
import subprocess
import sys

import torch_parity  # noqa: F401  (pins torch to one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = ("import importlib, pkgutil, sys\n"
            "import pips_ipmpp_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names + ['chip_smoke', 'profile_port']:\n"
            "    importlib.import_module(name)\n"
            "needed = {'pips_ipmpp_tpu_torch.core.sparse',\n"
            "          'pips_ipmpp_tpu_torch.core.csr',\n"
            "          'pips_ipmpp_tpu_torch.linalg.spmv',\n"
            "          'pips_ipmpp_tpu_torch.linalg.sweep',\n"
            "          'pips_ipmpp_tpu_torch.linalg.sparse_backend',\n"
            "          'pips_ipmpp_tpu_torch.ipm.control',\n"
            "          'pips_ipmpp_tpu_torch.ipm.device_loop',\n"
            "          'pips_ipmpp_tpu_torch.io.blockfile',\n"
            "          'pips_ipmpp_tpu_torch.io.energy',\n"
            "          'pips_ipmpp_tpu_torch.native',\n"
            "          'pips_ipmpp_tpu_torch.presolve.data',\n"
            "          'pips_ipmpp_tpu_torch.presolve.vectorized',\n"
            "          'pips_ipmpp_tpu_torch.presolve.passes',\n"
            "          'pips_ipmpp_tpu_torch.presolve.postsolve',\n"
            "          'pips_ipmpp_tpu_torch.presolve.presolver',\n"
            "          'pips_ipmpp_tpu_torch.linalg.dense_backend',\n"
            "          'pips_ipmpp_tpu_torch.io.mps',\n"
            "          'pips_ipmpp_tpu_torch.io.callbacks',\n"
            "          'pips_ipmpp_tpu_torch.io.gams',\n"
            "          'pips_ipmpp_tpu_torch.core.dissect',\n"
            "          'pips_ipmpp_tpu_torch.cli',\n"
            "          'pips_ipmpp_tpu_torch.ipm.checkpoint',\n"
            "          'pips_ipmpp_tpu_torch.utils.monitor',\n"
            "          'pips_ipmpp_tpu_torch.linalg.hier_backend'}\n"
            "assert needed <= set(names), needed - set(names)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pips_ipmpp_tpu' or "
            "m.startswith('pips_ipmpp_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
