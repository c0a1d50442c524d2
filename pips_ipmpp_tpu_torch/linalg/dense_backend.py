"""Dense (unstructured) backend for a flat DenseLP.

Counterpart of `pips_ipmpp_tpu/linalg/dense_backend.py`.  Solves the
augmented system by condensing to SPD normal equations (the (1,1) block is
diagonal for an LP):

    K = [ E   M' ]    E = Dx + dp   (diagonal)      M = [A; C]
        [ M  -F  ]    F = diag(dd*1_mE, Om + dd)    Om = 1/Ominv

    (M E^{-1} M' + F) d = M E^{-1} rho_x - rho_m    (Cholesky)
    dx = E^{-1} (rho_x - M' d)

The Cholesky runs in `factor_dtype` through `torch.linalg` (cuSOLVER on
the card, LAPACK on the CPU), as the JAX package's runs through
`jnp.linalg`: no hand-written kernel serves this path.  Refinement of the
augmented residual runs in the LP's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import DenseLP, _maxabs
from pips_ipmpp_tpu_torch.ipm.control import dev_while
from pips_ipmpp_tpu_torch.ipm.formulation import Bounds, ReducedRhs
from pips_ipmpp_tpu_torch.linalg.arrow_backend import _cholesky, scalar


@dataclass
class DenseFactors:
    chol: torch.Tensor      # [mE+mI, mE+mI] Cholesky factor of the normal matrix
    ok: torch.Tensor        # the factorization's health flag
    Einv: torch.Tensor      # [n] 1/(Dx+dp)
    Om: torch.Tensor        # [mI]
    delta_p: torch.Tensor
    delta_d: torch.Tensor


class DenseBackend:
    """Backend over an unstructured DenseLP (one LP, no batch axis)."""

    batch_shape = ()

    def __init__(self, lp: DenseLP, factor_dtype=torch.float64):
        self.lp = lp
        self.factor_dtype = factor_dtype
        self.M = torch.cat([lp.A, lp.C], dim=0)
        self.bounds = Bounds(
            c=lp.c, b=lp.b,
            ixlow=lp.ixlow, xlow=lp.xlow, ixupp=lp.ixupp, xupp=lp.xupp,
            iclow=lp.iclow, clow=lp.clow, icupp=lp.icupp, cupp=lp.cupp,
        )
        self.num_bound_pairs = torch.clamp(
            lp.ixlow.sum() + lp.ixupp.sum() + lp.iclow.sum()
            + lp.icupp.sum(), min=1.0)

    # ---- matvecs ----
    def Ax(self, x):
        return self.lp.A @ x

    def ATy(self, y):
        return self.lp.A.T @ y

    def Cx(self, x):
        return self.lp.C @ x

    def CTz(self, z):
        return self.lp.C.T @ z

    def objective(self, x):
        return self.lp.objective(x)

    def datanorm(self):
        return self.lp.datanorm()

    def _Fd(self, Om, delta_d):
        return torch.cat([delta_d.expand(self.lp.mE), Om + delta_d])

    # ---- factorization ----
    def factorize(self, Dx, Ominv, delta_p, delta_d) -> DenseFactors:
        fd = self.factor_dtype
        delta_p = scalar(delta_p, Dx)
        delta_d = scalar(delta_d, Dx)
        E = Dx + delta_p
        Einv = 1.0 / E
        Om = 1.0 / Ominv
        Fd = self._Fd(Om, delta_d)
        Mf = self.M.to(fd)
        N = (Mf * Einv.to(fd)[None, :]) @ Mf.T + torch.diag(Fd.to(fd))
        chol, ok = _cholesky(N)
        return DenseFactors(chol=chol, ok=ok, Einv=Einv, Om=Om,
                            delta_p=delta_p, delta_d=delta_d)

    def factorization_ok(self, fac: DenseFactors) -> torch.Tensor:
        return fac.ok

    # ---- solves ----
    def _solve_once(self, fac: DenseFactors, rho_x, rho_m):
        fd = self.factor_dtype
        rhs = (self.M @ (fac.Einv * rho_x) - rho_m).to(fd)
        u = torch.linalg.solve_triangular(fac.chol, rhs[:, None], upper=False)
        d = torch.linalg.solve_triangular(fac.chol.T, u, upper=True)
        d = d[:, 0].to(rho_x.dtype)
        dx = fac.Einv * (rho_x - self.M.T @ d)
        return dx, d

    def _apply_K(self, fac: DenseFactors, dx, d):
        """Augmented-system matvec for refinement: K (dx; d)."""
        E = 1.0 / fac.Einv
        Fd = self._Fd(fac.Om, fac.delta_d)
        top = E * dx + self.M.T @ d
        bot = self.M @ dx - Fd * d
        return top, bot

    def solve_reduced(self, fac: DenseFactors, rhs: ReducedRhs,
                      refinement_steps: int = 1):
        """Solve the augmented system; returns (dx, dy, dz)."""
        lp = self.lp
        rho_x = -rhs.rhat_x
        rho_m = torch.cat([-rhs.rA, -rhs.rhat_z])
        dx, d = self._solve_once(fac, rho_x, rho_m)
        if refinement_steps > 0:
            rhs_norm = torch.clamp(torch.maximum(_maxabs(rho_x),
                                                 _maxabs(rho_m)), min=1e-30)

            def resid(dx, d):
                top, bot = self._apply_K(fac, dx, d)
                ex, em = rho_x - top, rho_m - bot
                return ex, em, torch.maximum(_maxabs(ex), _maxabs(em))

            def body(carry):
                dx, d, ex, em, _ = carry
                cx, cd = self._solve_once(fac, ex, em)
                dx, d = dx + cx, d + cd
                return (dx, d) + resid(dx, d)

            dx, d, _, _, _ = dev_while(
                lambda c: c[4] > 1e-11 * rhs_norm, body,
                (dx, d) + resid(dx, d), refinement_steps)
        return dx, -d[:lp.mE], -d[lp.mE:]


def random_dense_lp(seed: int, n=20, mE=8, mI=12, dtype=torch.float64,
                    bound_prob=0.7, device="cpu") -> DenseLP:
    """Random feasible-by-construction LP for tests (interior x* exists).
    The JAX package's `random_dense_lp` draws `seed` from its key and then
    builds the same LP from it."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(mE, n))
    C = rng.normal(size=(mI, n))
    x_feas = rng.normal(size=(n,)) * 0.5
    b = A @ x_feas
    Cx = C @ x_feas
    iclow = (rng.random(mI) < bound_prob).astype(float)
    icupp = np.where(iclow > 0, (rng.random(mI) < 0.5).astype(float), 1.0)
    clow = np.where(iclow > 0, Cx - 0.5 - rng.random(mI), 0.0)
    cupp = np.where(icupp > 0, Cx + 0.5 + rng.random(mI), 0.0)
    ixlow = (rng.random(n) < bound_prob).astype(float)
    ixupp = (rng.random(n) < bound_prob).astype(float)
    # every variable gets at least one bound
    ixlow = np.where((ixlow == 0) & (ixupp == 0), 1.0, ixlow)
    xlow = np.where(ixlow > 0, x_feas - 0.5 - rng.random(n), 0.0)
    xupp = np.where(ixupp > 0, x_feas + 0.5 + rng.random(n), 0.0)
    c = rng.normal(size=(n,))

    def arr(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return DenseLP(c=arr(c), A=arr(A), b=arr(b), C=arr(C),
                   iclow=arr(iclow), clow=arr(clow),
                   icupp=arr(icupp), cupp=arr(cupp),
                   ixlow=arr(ixlow), xlow=arr(xlow),
                   ixupp=arr(ixupp), xupp=arr(xupp))
