"""Problem scaling: equilibrium, geometric mean (with and without an
equilibrium pass) and Curtis-Reid."""
from pips_ipmpp_tpu_torch.scale.scaling import (CurtisReidScaler,
                                                EquilibriumScaler,
                                                GeometricMeanScaler,
                                                make_scaler)

__all__ = ["CurtisReidScaler", "EquilibriumScaler", "GeometricMeanScaler",
           "make_scaler"]
