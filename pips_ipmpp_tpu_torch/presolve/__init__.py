"""Presolve and postsolve: host numpy, as in `pips_ipmpp_tpu/presolve`."""
from pips_ipmpp_tpu_torch.presolve.presolver import Presolver, PresolveResult

__all__ = ["Presolver", "PresolveResult"]
