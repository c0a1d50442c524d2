r"""Arrowhead backend: batched block KKT condensation + Schur complement.

Counterpart of `pips_ipmpp_tpu/linalg/arrow_backend.py` (see its docstring
for the derivation).  Per IPM iteration, for every block i (all N at once):

  block augmented KKT (quasidefinite; x-block diagonal for LPs):

      K_i = [ E_i    M_i' ]   E_i = Dx_i + dp (diag)   M_i = [B_i; D_i]
            [ M_i   -F_i  ]   F_i = diag(dd, Om_i + dd)

  condensation: Neq_i = M_i E_i^{-1} M_i' + F_i (SPD), factored in one
  batch — by the LDL^T kernel (linalg/ldl.py) with f32 factors, by
  Cholesky with f64 factors, or inverted by the sweep kernel
  (linalg/sweep.py) when asked; border solves U_i = K_i^{-1} R_i and the
  Schur contribution -R_i' K_i^{-1} R_i are batched matmuls.

The root system over s0full = [x0; y0; z0; yl; zl]

      S = K_0 - sum_i R_i' K_i^{-1} R_i

is quasidefinite with an SPD x0-block.  It is either factored whole by the
LDL^T kernel (explicit root inverse, inertia check, in-place shift
escalation) or by a two-level condensation (Cholesky of S11, then of the
dual Schur complement).

Solves run Lsolve -> Dsolve -> Ltsolve with adaptive iterative refinement
on the augmented residual in the working dtype.

Three other modes of the reference (single LP): the blockwise Schur
complement (`blockwise_sc`: the contribution streamed in column chunks, no
K^{-1}R caches, one more leaf solve in Ltsolve), the iterative root
(`iterative_root`: S11 and sparsified block-Jacobi panels of the dual
Schur complement factored, the Dsolve by preconditioned CG,
`linalg/sc_precond.py`) and outer BiCGStab on the whole system with one
structured solve as its preconditioner (`solve_reduced_bicgstab`).

Over a stack of B LPs (`core/lp.py::stack_lps`; `batch_shape == (B,)`)
every tensor carries the leading batch axis, the shifts and health flags
are one per LP, all B·N leaves go to the leaf kernel in one call (the
batch folded into its block axis), the roots in one [B, ns, ns] call, and
the root escalation and the refinement loop per LP (`control`'s batched
semantics).  A single LP keeps its shapes and arithmetic.

Factorization and solves are capture-clean: no read-back, no tensor made
from host data.  The root shift escalation and the refinement are
`control.dev_while` loops, conditional nodes when the fused loop is
captured, and the regularization shifts may be Python numbers or device
tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP, _maxabs
from pips_ipmpp_tpu_torch.core.spaces import (RVec, XVec, _vdot, bcast,
                                              reduce_all, select, tmap)
from pips_ipmpp_tpu_torch.ipm.control import capturing, dev_while
from pips_ipmpp_tpu_torch.ipm.formulation import Bounds, ReducedRhs
from pips_ipmpp_tpu_torch.linalg.ldl import (inverse_from_factors,
                                             ldl_inverse_factors)
from pips_ipmpp_tpu_torch.linalg.potf2 import cholesky_potf2
from pips_ipmpp_tpu_torch.linalg.sc_precond import (block_jacobi_apply,
                                                    block_jacobi_factors)
from pips_ipmpp_tpu_torch.linalg.sweep import sweep_inverse


@dataclass
class ArrowFactors:
    """One factorization of the arrowhead KKT system.  Fields a mode does
    not use are None."""
    L: object           # Cholesky of Neq [N, a, a] | (X, 1/d) factored
                        # inverse | None
    Ninv: Optional[torch.Tensor]     # [N, a, a] explicit Neq^{-1}
    Einv: torch.Tensor               # [N, n]
    Om: torch.Tensor                 # [N, mI]
    Ux: Optional[torch.Tensor]       # [N, n, nS]      K^{-1}R rows x
    Um: Optional[torch.Tensor]       # [N, mE+mI, nS]  K^{-1}R rows (y,z)
                                     # (None with blockwise_sc)
    chol1: Optional[torch.Tensor]    # [n0, n0] Cholesky of S11
    S11inv: Optional[torch.Tensor]   # [n0, n0] explicit inverse
    T: Optional[torch.Tensor]        # [n0, nD] S11^{-1} S12
    chol2: Optional[torch.Tensor]    # [nD, nD] Cholesky of the dual Schur
    Sdinv: Optional[torch.Tensor]    # [nD, nD] explicit inverse
    Einv0: torch.Tensor              # [n0]
    Om0: torch.Tensor                # [m0I]
    Oml: torch.Tensor                # [mIl]
    delta_p: torch.Tensor
    delta_d: torch.Tensor
    Sinv: Optional[torch.Tensor]     # [ns, ns] explicit root inverse (LDL)
    ok: torch.Tensor                 # factorization-health flag (per LP)
    extra_root: object = 0.0         # extra root-only shift applied by the
                                     # in-factorize escalation (per LP)
    Sd: Optional[torch.Tensor] = None     # [nD, nD] dense dual Schur
                                     # complement (iterative root: the CG's
                                     # matvec)
    Pchol: Optional[torch.Tensor] = None  # [k, pb, pb] sparsified block-
                                     # Jacobi panels' Cholesky (sc_precond)
    RbG: Optional[tuple] = None      # banded root (linalg/band_root.py):
                                     # the permuted SDD's panel factors
                                     # (Ginv, C[, U, W, Sinv of the peeled
                                     # rows]); chol1 is then S11x's factor


def _mv(A, x):
    """A x for a matrix A [..., m, k] and a vector x [..., k], batched or
    not.  A single LP's matvec stays a matrix-vector product (a product is
    not exact: as a one-column matrix product it would round otherwise)."""
    if x.ndim == 1 and A.ndim == 2:
        return A @ x
    return (A @ x[..., None])[..., 0]


def _tri_solve(L, b, transpose=False):
    """L x = b (or L' x = b) for lower-triangular L, batched or not."""
    if transpose:
        return torch.linalg.solve_triangular(L.mT, b, upper=True)
    return torch.linalg.solve_triangular(L, b, upper=False)


def _bchol_solve(L, b):
    """SPD solve via a cached Cholesky factor: L L' x = b (b may be one
    vector per matrix)."""
    if b.ndim < L.ndim:
        return _bchol_solve(L, b[..., None])[..., 0]
    return _tri_solve(L, _tri_solve(L, b), transpose=True)


def _cholesky(S, nb: int = 0):
    """Cholesky factor of (S + S')/2 and a health flag (per LP over the
    `nb` leading batch axes); a failed factorization does not raise (the
    IPM escalates its regularization instead).  The JAX package's
    `jnp.linalg.cholesky` symmetrizes its input the same way: a Schur
    complement built from inexact leaf solves (the sparse backend's capped
    CG) is not symmetric, and the lower triangle alone is another
    matrix."""
    L, info = torch.linalg.cholesky_ex((S + S.mT) / 2)
    return L, (reduce_all(torch.all, info == 0, nb)
               & reduce_all(torch.all, torch.isfinite(L), nb))


def _root_cholesky(S, nb: int = 0):
    """`_cholesky` for the two-level root's blocks: in f64 on the card the
    potf2 kernel, LAPACK's unblocked order (cuSOLVER's potrf accepts root
    blocks singular to working precision that LAPACK refuses: ROADMAP.md
    §3, F3); on the CPU, and in f32, torch.linalg (on the CPU, LAPACK)."""
    if S.device.type == "cuda" and S.dtype == torch.float64:
        return cholesky_potf2(S)
    return _cholesky(S, nb)


# Opt-in record of the iterative solves: a list to append to, or None.
# Each outer BiCGStab solve appends ("bicgstab", stats), each root CG solve
# ("cg", stats), each iterative-root factorization ("panels",
# dict(count=k, dropped=share)) and each refinement of the hierarchical
# backend ("refinement", dict(iterations=, residual=)), every value a
# device tensor (no read-back).  Inside a graph capture the entry is (kind, None): the loop
# became a WHILE node, whose values exist only at replay.  `chip_smoke.py`
# reads it.
SOLVE_RECORD: Optional[list] = None


def _record(kind: str, stats: dict, like: torch.Tensor):
    if SOLVE_RECORD is not None:
        SOLVE_RECORD.append((kind, None if capturing(like) else stats))


def preconditioned_bicgstab(b, precond, applyK, dot, max_iters: int, tol):
    """Preconditioned BiCGStab on K u = b over a tensor or a tuple of
    tensors (the
    reference's BiCGStabSolver with its breakdown and divergence flags,
    BiCGStabSolver.h:14-39; the JAX package's `preconditioned_bicgstab`).

    `precond(v)` and `applyK(v)` map such a value to another; `dot(a, b)`
    is the inner product (a 0-dim tensor).  The loop is a `control.dev_while`
    (a WHILE node inside a capture) of at most `max_iters` trips; `tol`
    may be a device tensor.  Returns (u, stats): `iterations`, `relres`,
    `converged` and `flag` (0, 1 breakdown, 2 divergence), all device
    tensors."""
    bnorm = torch.sqrt(torch.clamp(dot(b, b), min=1e-300))
    u0 = precond(b)
    r0 = tmap(torch.sub, b, applyK(u0))
    rhat = r0
    rho0 = dot(rhat, r0)
    rnorm0 = torch.sqrt(torch.clamp(dot(r0, r0), min=0.0))
    tol_b = tol * bnorm

    def cond(c):
        _, _, _, _, _, _, _, k, rnorm, flag = c
        return (k < max_iters) & (rnorm > tol_b) & (flag == 0)

    def body(c):
        u, r, p, v, rho_prev, alpha, omega, k, _, _ = c
        rho = dot(rhat, r)
        breakdown = torch.abs(rho) < 1e-300
        beta = (rho / torch.where(breakdown, 1.0, rho_prev)) \
            * (alpha / torch.where(torch.abs(omega) < 1e-300, 1.0, omega))
        p = tmap(lambda rr, pp, vv: rr + beta * (pp - omega * vv), r, p, v)
        ph = precond(p)
        v2 = applyK(ph)
        denom = dot(rhat, v2)
        alpha2 = rho / torch.where(torch.abs(denom) < 1e-300, 1.0, denom)
        s = tmap(lambda a, bb: a - alpha2 * bb, r, v2)
        sh = precond(s)
        t = applyK(sh)
        omega2 = dot(t, s) / torch.clamp(dot(t, t), min=1e-300)
        u2 = tmap(lambda a, x, y: (a + alpha2 * x) + omega2 * y, u, ph, sh)
        r2 = tmap(lambda a, bb: a - omega2 * bb, s, t)
        rnorm2 = torch.sqrt(torch.clamp(dot(r2, r2), min=0.0))
        flag2 = torch.where(breakdown | (torch.abs(denom) < 1e-300), 1,
                            torch.where(rnorm2 > 1e4 * rnorm0, 2, 0)
                            ).to(torch.int32)
        return (u2, r2, p, v2, rho, alpha2, omega2, k + 1, rnorm2, flag2)

    zero = tmap(torch.zeros_like, b)
    one = torch.ones_like(bnorm)
    k0 = torch.zeros((), dtype=torch.int32, device=bnorm.device)
    u, _, _, _, _, _, _, k, rnorm, flag = dev_while(
        cond, body, (u0, r0, zero, zero, rho0, one, one.clone(), k0, rnorm0,
                     k0.clone()), max_iters)
    stats = dict(iterations=k, relres=rnorm / bnorm,
                 converged=rnorm <= tol_b, flag=flag)
    _record("bicgstab", stats, bnorm)
    return u, stats


def preconditioned_cg(b, precond, applyK, dot, max_iters: int, tol):
    """Preconditioned conjugate gradients for an SPD operator (the
    reference's CGSolver/PCGSolver family; the JAX package's
    `preconditioned_cg`), with the contract of `preconditioned_bicgstab`:
    a `dev_while` of at most `max_iters` trips, flag 1 on breakdown.
    Returns (u, stats)."""
    bb = dot(b, b)
    bnorm = torch.sqrt(torch.clamp(bb, min=1e-300))
    z0 = precond(b)
    rn0 = torch.sqrt(torch.clamp(bb, min=0.0))
    tol_b = tol * bnorm

    def cond(c):
        _, _, _, _, _, k, rn, flag = c
        return (k < max_iters) & (rn > tol_b) & (flag == 0)

    def body(c):
        u, r, _, p, rz, k, _, _ = c
        Kp = applyK(p)
        denom = dot(p, Kp)
        breakdown = torch.abs(denom) < 1e-300
        alpha = rz / torch.where(breakdown, 1.0, denom)
        u2 = tmap(lambda a, bb: a + alpha * bb, u, p)
        r2 = tmap(lambda a, bb: a - alpha * bb, r, Kp)
        z2 = precond(r2)
        rz2 = dot(r2, z2)
        beta = rz2 / torch.where(torch.abs(rz) < 1e-300, 1.0, rz)
        p2 = tmap(lambda a, bb: a + beta * bb, z2, p)
        rn2 = torch.sqrt(torch.clamp(dot(r2, r2), min=0.0))
        return (u2, r2, z2, p2, rz2, k + 1, rn2, breakdown.to(torch.int32))

    k0 = torch.zeros((), dtype=torch.int32, device=bnorm.device)
    u, _, _, _, _, k, rn, flag = dev_while(
        cond, body, (tmap(torch.zeros_like, b), b, z0, z0, dot(b, z0), k0,
                     rn0, k0.clone()), max_iters)
    stats = dict(iterations=k, relres=rn / bnorm, converged=rn <= tol_b,
                 flag=flag)
    _record("cg", stats, bnorm)
    return u, stats


def scalar(v, like: torch.Tensor, shape=()) -> torch.Tensor:
    """A shift as a tensor of `like`'s dtype and device and of `shape`
    (the batch shape: one shift per LP): a tensor is converted (and
    broadcast to `shape`), a Python number filled in on the device (no
    copy from the host, which a graph capture refuses).  The shape does
    not depend on how the shift was given, so that the branches of a
    captured `dev_cond` that factor with a number and with per-LP tensors
    return the same shapes."""
    shape = tuple(shape)
    if isinstance(v, torch.Tensor):
        v = v.to(dtype=like.dtype, device=like.device)
        return v if tuple(v.shape) == shape else v.expand(shape).clone()
    return torch.full(shape, v, dtype=like.dtype, device=like.device)


class ArrowBackend:
    """Backend over an ArrowheadLP on one device.

    With f32 factors the leaves and the root go through the LDL^T kernel
    (`ldl_kernel`), keeping either explicit inverses or, with
    `factored_inverse`, the (X, 1/d) factors of the leaves; with f64
    factors they go through Cholesky.  `sweep_kernel=True` (with the LDL
    kernel's explicit inverses only) inverts leaves and root with the sweep
    kernel instead: opt-in, since the sweep is unstable on IPM-conditioned
    systems.

    Three solve modes of the reference (single LP; a stack of LPs raises):
    `blockwise_sc > 0` streams the Schur contribution in column chunks of
    that size and keeps no K^{-1}R caches (SC_COMPUTE_BLOCKWISE);
    `iterative_root > 0` factors only S11 and the sparsified block-Jacobi
    panels of that size of the dual Schur complement, whose solve becomes
    preconditioned CG (PRECONDITION_SPARSE, `linalg/sc_precond.py`); and
    `solve_reduced_bicgstab`, outer BiCGStab on the whole KKT system
    preconditioned by one structured solve (OUTER_SOLVE=2), which
    `ipm_step` runs under `Options.outer_bicgstab`."""

    def __init__(self, lp: ArrowheadLP, factor_dtype=torch.float64,
                 explicit_inverse: Optional[bool] = None,
                 ldl_kernel: Optional[bool] = None,
                 factored_inverse: bool = False,
                 root_escalation: bool = True,
                 root_escalation_base: float = 1e-4,
                 root_escalation_growth: float = 100.0,
                 root_escalation_max: float = 10.0,
                 blockwise_sc: int = 0,
                 dist_root: bool = False,
                 iterative_root: int = 0,
                 sc_diag_dom_bound: float = 0.001,
                 it_root_tol: float = 1e-9,
                 it_root_maxiter: int = 200,
                 band_root_plan=None,
                 sweep_kernel: Optional[bool] = None,
                 root_factor_dtype: Optional[torch.dtype] = None):
        if dist_root:
            raise NotImplementedError(
                "ArrowBackend(dist_root=...) is not ported yet (ROADMAP.md "
                "§1: Distributed)")
        if band_root_plan is not None and iterative_root:
            raise ValueError("band_root_plan is exclusive with "
                             "dist_root/iterative_root")
        if lp.batch_shape and (blockwise_sc or iterative_root):
            raise NotImplementedError(
                "blockwise_sc and iterative_root over a stack of LPs are "
                "not ported yet (ROADMAP.md §1: the fused batch under the "
                "solve modes)")
        if lp.batch_shape and band_root_plan is not None:
            raise NotImplementedError(
                "band_root_plan over a stack of LPs is not ported yet "
                "(ROADMAP.md §1: the fused batch under the banded and "
                "bucketed modes)")
        self.lp = lp
        self.batch_shape = lp.batch_shape
        self.factor_dtype = factor_dtype
        if explicit_inverse is None:
            explicit_inverse = factor_dtype == torch.float32
        self.explicit_inverse = explicit_inverse
        if ldl_kernel is None:
            ldl_kernel = factor_dtype == torch.float32 and explicit_inverse
        self.ldl_kernel = ldl_kernel
        self.factored_inverse = factored_inverse and ldl_kernel
        # the sweep (linalg/sweep.py) replaces the LDL kernel's explicit
        # inverses only; off unless asked
        self.sweep_kernel = bool(sweep_kernel) and ldl_kernel \
            and not factored_inverse
        self.root_escalation = root_escalation
        self.root_escalation_base = root_escalation_base
        self.root_escalation_growth = root_escalation_growth
        self.root_escalation_max = root_escalation_max
        # blockwise Schur computation (reference SC_COMPUTE_BLOCKWISE,
        # DistributedLinearSystem.h:77-99): factorize memory
        # O(N k blockwise_sc) instead of O(N k nS); 0 keeps the caches
        self.blockwise_sc = int(blockwise_sc)
        # iterative root (reference PRECONDITION_SPARSE + SCsparsifier):
        # O(nD pb^2 + its nD^2) per iteration instead of O(nD^3)
        self.iterative_root = int(iterative_root)
        self.sc_diag_dom_bound = float(sc_diag_dom_bound)
        self.it_root_tol = float(it_root_tol)
        self.it_root_maxiter = int(it_root_maxiter)
        if self.iterative_root:
            # the LDL kernel owns the whole root; the iterative root
            # replaces the dual Schur factorization of the two-level path
            self.ldl_kernel = False
        # the root's factor dtype: the leaves' unless given.  A root in
        # another dtype than the leaves takes the two-level Cholesky path
        # (potf2 in f64 on the card) without explicit inverses
        self.root_dtype = (factor_dtype if root_factor_dtype is None
                           else root_factor_dtype)
        same = self.root_dtype == factor_dtype
        self.root_ldl = self.ldl_kernel and same
        self.root_explicit_inverse = self.explicit_inverse and same
        # banded root (linalg/band_root.py): the 2-link linking structure
        # makes the dual Schur complement banded after the plan's
        # permutation; it takes the place of every other root mode
        self.band_root_plan = band_root_plan
        if band_root_plan is not None:
            self._rb_perm = torch.as_tensor(band_root_plan.perm,
                                            dtype=torch.int64,
                                            device=lp.device)
            self._rb_iperm = torch.as_tensor(band_root_plan.iperm,
                                             dtype=torch.int64,
                                             device=lp.device)
        self.bounds = Bounds(
            c=XVec(lp.c0, lp.cN),
            b=RVec(lp.b0, lp.bN, lp.bl),
            ixlow=XVec(lp.ixlow0, lp.ixlowN), xlow=XVec(lp.xlow0, lp.xlowN),
            ixupp=XVec(lp.ixupp0, lp.ixuppN), xupp=XVec(lp.xupp0, lp.xuppN),
            iclow=RVec(lp.iclow0, lp.iclowN, lp.iclowl),
            clow=RVec(lp.clow0, lp.clowN, lp.clowl),
            icupp=RVec(lp.icupp0, lp.icuppN, lp.icuppl),
            cupp=RVec(lp.cupp0, lp.cuppN, lp.cuppl),
        )
        nb = len(self.batch_shape)

        def tot(t):
            return reduce_all(torch.sum, t, nb)

        local = (tot(lp.ixlowN) + tot(lp.ixuppN) + tot(lp.iclowN)
                 + tot(lp.icuppN))
        rep = (tot(lp.ixlow0) + tot(lp.ixupp0) + tot(lp.iclow0)
               + tot(lp.icupp0) + tot(lp.iclowl) + tot(lp.icuppl))
        self.num_bound_pairs = torch.clamp(local + rep, min=1.0)
        self._init_leaves()

    def _init_leaves(self):
        """Leaf operators: the dense merged M = [B; D] and its factor-dtype
        copy (the sparse backend keeps ELL operators instead)."""
        self.M = torch.cat([self.lp.B, self.lp.D], dim=-2)     # [N, a, n]
        self.Mf = self.M.to(self.factor_dtype)

    # ---- matvecs (recursive tree mult of the reference, collapsed to
    #      batched einsum) ----
    def Ax(self, x: XVec) -> RVec:
        lp = self.lp
        first = _mv(lp.A0, x.first)
        blocks = (torch.einsum("...imk,...k->...im", lp.A, x.first)
                  + torch.einsum("...imn,...in->...im", lp.B, x.blocks))
        link = (_mv(lp.F0, x.first)
                + torch.einsum("...iln,...in->...l", lp.F, x.blocks))
        return RVec(first, blocks, link)

    def ATy(self, y: RVec) -> XVec:
        lp = self.lp
        first = (_mv(lp.A0.mT, y.first) + _mv(lp.F0.mT, y.link)
                 + torch.einsum("...imk,...im->...k", lp.A, y.blocks))
        blocks = (torch.einsum("...imn,...im->...in", lp.B, y.blocks)
                  + torch.einsum("...iln,...l->...in", lp.F, y.link))
        return XVec(first, blocks)

    def Cx(self, x: XVec) -> RVec:
        lp = self.lp
        first = _mv(lp.C0, x.first)
        blocks = (torch.einsum("...imk,...k->...im", lp.C, x.first)
                  + torch.einsum("...imn,...in->...im", lp.D, x.blocks))
        link = (_mv(lp.G0, x.first)
                + torch.einsum("...iln,...in->...l", lp.G, x.blocks))
        return RVec(first, blocks, link)

    def CTz(self, z: RVec) -> XVec:
        lp = self.lp
        first = (_mv(lp.C0.mT, z.first) + _mv(lp.G0.mT, z.link)
                 + torch.einsum("...imk,...im->...k", lp.C, z.blocks))
        blocks = (torch.einsum("...imn,...im->...in", lp.D, z.blocks)
                  + torch.einsum("...iln,...l->...in", lp.G, z.link))
        return XVec(first, blocks)

    def objective(self, x: XVec) -> torch.Tensor:
        if not self.batch_shape:
            return _vdot(self.lp.c0, x.first) + _vdot(self.lp.cN, x.blocks)
        return ((self.lp.c0 * x.first).sum(-1)
                + (self.lp.cN * x.blocks).flatten(-2).sum(-1))

    def datanorm(self) -> torch.Tensor:
        return self.lp.datanorm()

    # ---- leaf factorization ----
    def _all(self, t):
        """`t.all()`, per LP over a stack of LPs."""
        return reduce_all(torch.all, t, len(self.batch_shape))

    def _leaf_factor(self, M, MEi, Fd):
        """Factor the condensed leaf systems Neq_i = MEi M' + diag(Fd).
        Over a stack of LPs the kernels take all B·N leaves in one call.

        Returns (L, Ninv, leaf_ok) as `_apply_Ninv_multi` consumes them."""
        fd = self.factor_dtype
        Neq = (torch.einsum("...iak,...ibk->...iab", MEi.to(fd), self.Mf)
               + torch.diag_embed(Fd.to(fd)))
        a = Neq.shape[-1]
        flat = Neq.flatten(0, -3)     # [B·N, a, a]; a bucket may have a = 0

        def unfold(t):
            return t.reshape(Neq.shape[:-2] + t.shape[1:])

        if self.sweep_kernel:
            Ninv, df = map(unfold, sweep_inverse(flat))
            leaf_ok = self._all(torch.isfinite(Ninv)) & self._all(df > 0.0)
            return None, Ninv, leaf_ok
        if self.ldl_kernel:
            Xf, df = ldl_inverse_factors(flat)
            if self.factored_inverse:
                Xf, df = unfold(Xf), unfold(df)
                leaf_ok = self._all(torch.isfinite(Xf)) & self._all(df > 0.0)
                return (Xf, 1.0 / df), None, leaf_ok
            Ninv, df = unfold(inverse_from_factors(Xf, df)), unfold(df)
            leaf_ok = self._all(torch.isfinite(Ninv)) & self._all(df > 0.0)
            return None, Ninv, leaf_ok
        L, leaf_ok = _cholesky(Neq, len(self.batch_shape))
        if not self.explicit_inverse:
            return L, None, leaf_ok
        eye = torch.eye(a, dtype=fd, device=Neq.device).expand(Neq.shape)
        Ninv = _bchol_solve(L, eye)
        return L, Ninv, leaf_ok & self._all(torch.isfinite(Ninv))

    def _apply_Ninv_multi(self, L, Ninv, t):
        """Neq^{-1} t for multi-RHS t [N, a, c] via the stored leaf factor:
        factored (X, 1/d) pair, explicit Ninv, or Cholesky L."""
        if self.factored_inverse:
            Xf, dinv = L
            return Xf.mT @ (dinv[..., None] * (Xf @ t))
        if Ninv is not None:
            return Ninv @ t
        return _bchol_solve(L, t)

    def leaf_factorize(self, Dx_blocks, Ominv_blocks, delta_p, delta_d):
        """Batched condensation, border solves, and the blocks' Schur
        contribution.  Returns (L, Ninv, Einv, Om, Ux, Um, contrib,
        leaf_ok)."""
        lp = self.lp
        fd = self.factor_dtype
        n0, mEl, mIl = lp.n0, lp.mEl, lp.mIl
        mE, mI = lp.mE, lp.mI

        Einv = 1.0 / (Dx_blocks + bcast(delta_p, Dx_blocks))   # [N, n]
        Om = 1.0 / Ominv_blocks                                # [N, mI]
        dt = Einv.dtype
        M = self.M
        dd = bcast(scalar(delta_d, Einv, self.batch_shape), Om)
        lead = Om.shape[:-1]                                   # [*batch, N]
        Fd = torch.cat([dd.expand(lead + (mE,)), Om + dd],
                       dim=-1)                                 # [N, mE+mI]
        MEi = M * Einv[..., None, :]
        L, Ninv, leaf_ok = self._leaf_factor(M, MEi, Fd)
        if self.blockwise_sc > 0:
            contrib = self._contrib_blockwise(L, Ninv, Einv).to(dt)
            return L, Ninv, Einv, Om, None, None, contrib, leaf_ok

        # ---- border solves U = K^{-1} R (structure-exploiting) ----
        # E^{-1} R_x = [0 | Einv*F' | Einv*G']
        EiRx = torch.cat([
            torch.zeros(lead + (lp.n, n0), dtype=dt, device=Einv.device),
            lp.F.mT * Einv[..., None],
            lp.G.mT * Einv[..., None]], dim=-1)                # [N, n, nS]
        Rm = torch.cat([
            torch.cat([lp.A, lp.C], dim=-2),
            torch.zeros(lead + (mE + mI, mEl + mIl), dtype=dt,
                        device=Einv.device)], dim=-1)          # [N, a, nS]
        Mf = self.Mf
        EiRxf = EiRx.to(fd)
        rhsU = Mf @ EiRxf - Rm.to(fd)
        Um = self._apply_Ninv_multi(L, Ninv, rhsU)
        Ux = EiRxf - Einv.to(fd)[..., None] * (Mf.mT @ Um)

        # ---- Schur contribution  R'U: rows [A'U_my + C'U_mz ; F U_x ; G U_x]
        contrib_x0 = (torch.einsum("...imk,...imS->...kS", lp.A.to(fd),
                                   Um[..., :mE, :])
                      + torch.einsum("...imk,...imS->...kS", lp.C.to(fd),
                                     Um[..., mE:, :]))
        contrib_yl = torch.einsum("...ilm,...imS->...lS", lp.F.to(fd), Ux)
        contrib_zl = torch.einsum("...ilm,...imS->...lS", lp.G.to(fd), Ux)
        contrib = torch.cat([contrib_x0, contrib_yl, contrib_zl],
                            dim=-2).to(dt)
        return L, Ninv, Einv, Om, Ux.to(dt), Um.to(dt), contrib, leaf_ok

    def factorize(self, Dx: XVec, Ominv: RVec, delta_p, delta_d
                  ) -> ArrowFactors:
        L, Ninv, Einv, Om, Ux, Um, contrib, leaf_ok = self.leaf_factorize(
            Dx.blocks, Ominv.blocks, delta_p, delta_d)
        return self._assemble_root(Dx, Ominv, delta_p, delta_d, L, Ninv,
                                   Einv, Om, Ux, Um, contrib, leaf_ok)

    def _assemble_root(self, Dx, Ominv, delta_p, delta_d, L, Ninv, Einv,
                       Om, Ux, Um, contrib, leaf_ok):
        lp = self.lp
        fd = self.root_dtype
        n0, m0E, m0I = lp.n0, lp.m0E, lp.m0I
        mEl, mIl = lp.mEl, lp.mIl
        dt = Einv.dtype
        dev = Einv.device
        # ---- root matrix S over s0full = [x0; y0; z0; yl; zl] ----
        nb = len(self.batch_shape)
        Einv0 = 1.0 / (Dx.first + bcast(delta_p, Dx.first))
        Om0 = 1.0 / Ominv.first
        Oml = 1.0 / Ominv.link
        nD = m0E + m0I + mEl + mIl
        ns = n0 + nD
        yl0, zl0 = m0E + m0I, m0E + m0I + mEl      # dual offsets of yl, zl

        # contrib rows/cols are ordered [x0(n0), yl(mEl), zl(mIl)]
        cxx = contrib[..., :n0, :]
        cyl = contrib[..., n0:n0 + mEl, :]
        czl = contrib[..., n0 + mEl:, :]
        S11 = (torch.diag_embed(Dx.first + bcast(delta_p, Dx.first))
               - cxx[..., :n0])                                # [n0, n0]
        # dual-space layout: [y0(m0E), z0(m0I), yl(mEl), zl(mIl)]
        S12 = torch.cat([lp.A0.mT, lp.C0.mT,
                         lp.F0.mT - cxx[..., n0:n0 + mEl],
                         lp.G0.mT - cxx[..., n0 + mEl:]], dim=-1)  # [n0, nD]
        delta_p = scalar(delta_p, Einv, self.batch_shape)
        delta_d = scalar(delta_d, Einv, self.batch_shape)
        dd = bcast(delta_d, Om0)
        batch = Om0.shape[:-1]
        F0d = torch.cat([dd.expand(batch + (m0E,)), Om0 + dd,
                         dd.expand(batch + (mEl,)), Oml + dd], dim=-1)
        S22 = -torch.diag_embed(F0d)
        S22[..., yl0:zl0, yl0:zl0] -= cyl[..., n0:n0 + mEl]
        S22[..., yl0:zl0, zl0:] -= cyl[..., n0 + mEl:]
        S22[..., zl0:, yl0:zl0] -= czl[..., n0:n0 + mEl]
        S22[..., zl0:, zl0:] -= czl[..., n0 + mEl:]

        common = dict(L=L, Ninv=Ninv, Einv=Einv, Om=Om, Ux=Ux, Um=Um,
                      Om0=Om0, Oml=Oml, delta_p=delta_p, delta_d=delta_d)

        if self.band_root_plan is not None:
            # ---- banded root: the dual block eliminated FIRST by the
            # block-tridiagonal Cholesky of the permuted SDD = -S22 (the
            # 2-link sparse-SC exploitation, DistributedProblem.hpp:66-77),
            # then the small primal Schur complement S11x = S11 + S12
            # SDD^{-1} S12' factored dense.  Every factor takes the root's
            # dtype: under the wide-root rule (interface.ROOT_F32_MAX, f32
            # leaves) the panels, the peeled rows' block and S11x, the
            # dense root-like block, are f64 and go through potf2 ----
            from pips_ipmpp_tpu_torch.linalg.band_backend import \
                block_tridiag_factor
            plan = self.band_root_plan
            b, nbp, kd = plan.panel, plan.n_panels, plan.n_dense
            nband = nD - kd
            P = self._rb_perm
            SDD = -(S22[P][:, P]).to(fd)                 # SPD, banded+dense
            Bb = SDD[:nband, :nband]
            pad = nbp * b - nband
            if pad:
                Bb = torch.nn.functional.pad(Bb, (0, pad, 0, pad))
                Bb[nband:, nband:] += torch.eye(pad, dtype=fd, device=dev)
            grid = Bb.reshape(nbp, b, nbp, b)
            # panel (k, k) and panel (k+1, k), as [nbp, 1, b, b]
            Adiag = grid.diagonal(dim1=0, dim2=2).permute(2, 0, 1)[:, None]
            Asub = torch.cat([
                grid.diagonal(offset=-1, dim1=0, dim2=2).permute(2, 0, 1),
                SDD.new_zeros((1, b, b))])[:, None]
            Ginv, Cb, okd = block_tridiag_factor(Adiag, Asub)
            if kd:
                # peeled wide/global linking rows: trailing dense Schur
                Ud = SDD[:nband, nband:]                 # [nband, kd]
                Wdns = self._rb_band_solve(Ginv, Cb, Ud)
                cholSd, okc = _root_cholesky(SDD[nband:, nband:]
                                             - Ud.mT @ Wdns)
                Sdinv_d = _bchol_solve(cholSd, torch.eye(
                    kd, dtype=fd, device=dev))
                okd = okd & okc & torch.isfinite(Sdinv_d).all()
                Rb = (Ginv, Cb, Ud, Wdns, Sdinv_d)
            else:
                Rb = (Ginv, Cb)
            S12p = S12[:, P].to(fd)                      # [n0, nD]
            Td = self._rb_solve(Rb, S12p.mT)             # SDD^{-1} S12'
            chol1, ok1 = _root_cholesky(S11.to(fd) + S12p @ Td)
            return ArrowFactors(chol1=chol1, S11inv=None, T=S12p.to(dt),
                                chol2=None, Sdinv=None, Einv0=Einv0,
                                Sinv=None, ok=leaf_ok & okd & ok1, RbG=Rb,
                                **common)

        if self.root_ldl:
            # ---- single quasidefinite root factor+inverse (LDL kernel):
            # SPD primal block, negative-definite dual block -> unpivoted
            # LDL is stable (Vanderbei); the explicit inverse turns every
            # root solve into one matvec.  A stack of LPs factors its B
            # roots in one [B, ns, ns] call ----
            Sfull = torch.cat([torch.cat([S11, S12], dim=-1),
                               torch.cat([S12.mT, S22], dim=-1)],
                              dim=-2).to(fd)
            sgn = torch.cat([torch.ones(n0, dtype=fd, device=dev),
                             -torch.ones(nD, dtype=fd, device=dev)])

            def _root_factor(extra):
                S = Sfull + torch.diag_embed(sgn * extra[..., None])
                flat = S.reshape(-1, ns, ns)
                if self.sweep_kernel:
                    Sinv1, ds = sweep_inverse(flat)
                else:
                    Xs, ds = ldl_inverse_factors(flat)
                    Sinv1 = inverse_from_factors(Xs, ds)
                Sinv_ = Sinv1.reshape(S.shape)
                ds = ds.reshape(S.shape[:-1])
                ok_ = (self._all(torch.isfinite(Sinv_))
                       & self._all(ds[..., :n0] > 0.0)
                       & self._all(ds[..., n0:] < 0.0))
                return Sinv_, ok_

            extra = torch.zeros(self.batch_shape, dtype=fd, device=dev)
            Sinv, root_ok = _root_factor(extra)
            # the sweep's pivots are no reliable health signal: its
            # failures stay on the outer regularization ladder
            if self.root_escalation and not self.sweep_kernel:
                # Wrong-inertia failures in f32 sit in this small root
                # system: escalate only the root shift in place instead of
                # failing the whole factorization (an outer retry would
                # redo every leaf factorization); per LP over a stack
                def escalate(carry):
                    extra_, _, _ = carry
                    extra_ = torch.where(extra_ == 0.0,
                                         self.root_escalation_base,
                                         extra_ * self.root_escalation_growth)
                    # the configured max is the LAST rung tried
                    extra_ = torch.clamp(extra_, max=self.root_escalation_max)
                    return (extra_, *_root_factor(extra_))

                extra, Sinv, root_ok = dev_while(
                    lambda c: ~c[2] & (c[0] < self.root_escalation_max),
                    escalate, (extra, Sinv, root_ok), self._root_rungs())
                # the solved system carries delta_p + extra on the
                # first-stage primal diagonal and delta_d + extra on the
                # root dual rows (_aug_residual reads both)
                Einv0 = 1.0 / (Dx.first + bcast(delta_p, Dx.first)
                               + bcast(extra.to(dt), Dx.first))
            return ArrowFactors(chol1=None, S11inv=None, T=None, chol2=None,
                                Sdinv=None, Einv0=Einv0, Sinv=Sinv,
                                ok=leaf_ok & root_ok, extra_root=extra.to(dt),
                                **common)

        if self.iterative_root:
            # ---- preconditioned iterative root (reference SCsparsifier +
            # precondSC): factor only S11 and the sparsified block-Jacobi
            # panels of the dual Schur complement; Dsolve runs CG ----
            chol1, ok1 = _root_cholesky(S11.to(fd), nb)
            T = _bchol_solve(chol1, S12.to(fd))
            Sdual = -(S22.to(fd) - S12.to(fd).mT @ T)
            Pchol, okp, dropped = block_jacobi_factors(
                Sdual, self.iterative_root, self.sc_diag_dom_bound)
            _record("panels", dict(count=Pchol.shape[0], dropped=dropped),
                    Sdual)
            return ArrowFactors(chol1=chol1, S11inv=None, T=T.to(dt),
                                chol2=None, Sdinv=None, Einv0=Einv0,
                                Sinv=None, ok=leaf_ok & ok1 & okp, Sd=Sdual,
                                Pchol=Pchol, **common)

        # ---- root two-level condensation ----
        chol1, ok1 = _root_cholesky(S11.to(fd), nb)
        T = _bchol_solve(chol1, S12.to(fd))
        Sdual = -(S22.to(fd) - S12.to(fd).mT @ T)
        chol2, ok2 = _root_cholesky(Sdual, nb)
        root_ok = ok1 & ok2
        S11inv = Sdinv = None
        if self.root_explicit_inverse:
            S11inv = _bchol_solve(chol1, torch.eye(
                n0, dtype=fd, device=dev).expand(chol1.shape))
            Sdinv = _bchol_solve(chol2, torch.eye(
                nD, dtype=fd, device=dev).expand(chol2.shape))
            root_ok = (root_ok & self._all(torch.isfinite(S11inv))
                       & self._all(torch.isfinite(Sdinv)))
        return ArrowFactors(chol1=chol1, S11inv=S11inv, T=T.to(dt),
                            chol2=chol2, Sdinv=Sdinv, Einv0=Einv0, Sinv=None,
                            ok=leaf_ok & root_ok, **common)

    def _root_rungs(self) -> int:
        """Rungs of the root escalation from 0 up to its max (the loop's
        bound; its own test stops it there)."""
        n, extra = 0, 0.0
        while extra < self.root_escalation_max:
            extra = min(self.root_escalation_base if extra == 0.0
                        else extra * self.root_escalation_growth,
                        self.root_escalation_max)
            n += 1
        return n

    def _rb_band_solve(self, Ginv, Cb, rhs):
        """Band-part solve for rhs [nband, c] (permuted order)."""
        from pips_ipmpp_tpu_torch.linalg.band_backend import \
            block_tridiag_solve
        plan = self.band_root_plan
        b, nbp = plan.panel, plan.n_panels
        nband, c = rhs.shape
        pad = nbp * b - nband
        r = rhs if not pad else torch.cat([rhs, rhs.new_zeros((pad, c))])
        x = block_tridiag_solve(Ginv, Cb, r.to(Ginv.dtype).reshape(
            nbp, 1, b, c))
        return x.reshape(nbp * b, c)[:nband]

    def _rb_solve(self, Rb, rhs):
        """Banded-root SDD^{-1} rhs for rhs [nD, c] (permuted order),
        with the trailing peeled dense block through its Schur factors."""
        if len(Rb) == 2:
            return self._rb_band_solve(*Rb, rhs)
        Ginv, Cb, Ud, Wdns, Sdinv = Rb
        nband = Ud.shape[0]
        r1, r2 = rhs[:nband], rhs[nband:]
        u1 = self._rb_band_solve(Ginv, Cb, r1)
        x2 = Sdinv @ (r2 - Ud.mT @ u1)
        x1 = u1 - Wdns @ x2
        return torch.cat([x1, x2])

    def _leaf_apply_inv(self, L, Ninv, Einv, rx, rm):
        """K_i^{-1} applied to (rx [N, n, c], rm [N, a, c]), multi-RHS."""
        fd = self.factor_dtype
        Mf = self.Mf
        t = Mf @ (Einv[..., None] * rx).to(fd) - rm.to(fd)
        um = self._apply_Ninv_multi(L, Ninv, t)
        ux = Einv[..., None].to(fd) * (rx.to(fd) - Mf.mT @ um)
        return ux, um

    def _contrib_blockwise(self, L, Ninv, Einv):
        """The Schur contribution R' K^{-1} R streamed in column chunks of
        `blockwise_sc` (reference SC_COMPUTE_BLOCKWISE /
        addTermToSchurComplBlocked): the columns are the groups [x0 (n0) |
        yl (mEl) | zl (mIl)]; each chunk is solved and contracted against
        the whole border, and no [N, k, nS] cache is kept."""
        lp = self.lp
        fd = self.factor_dtype
        n0, mEl, mIl = lp.n0, lp.mEl, lp.mIl
        mE, mI = lp.mE, lp.mI
        nS = n0 + mEl + mIl
        ch = self.blockwise_sc
        dt, dev = Einv.dtype, Einv.device
        N = lp.N
        Af, Cf, Ff, Gf = (x.to(fd) for x in (lp.A, lp.C, lp.F, lp.G))
        contrib = torch.zeros((nS, nS), dtype=fd, device=dev)

        def chunk(col, rx, rm):
            """Columns col:col+c of R' K^{-1} R, rows [x0; yl; zl]."""
            ux, um = self._leaf_apply_inv(L, Ninv, Einv, rx, rm)
            contrib[:, col:col + rx.shape[-1]] = torch.cat([
                torch.einsum("imk,imc->kc", Af, um[:, :mE])
                + torch.einsum("imk,imc->kc", Cf, um[:, mE:]),
                torch.einsum("ilm,imc->lc", Ff, ux),
                torch.einsum("ilm,imc->lc", Gf, ux)])

        # x0 columns: R_x = 0, R_m = [A; C] columns
        for s in range(0, n0, ch):
            e = min(s + ch, n0)
            chunk(s, torch.zeros((N, lp.n, e - s), dtype=dt, device=dev),
                  torch.cat([lp.A[:, :, s:e], lp.C[:, :, s:e]], dim=1))
        # yl and zl columns: R_x = F' (G'), R_m = 0
        for col, W, m in ((n0, lp.F, mEl), (n0 + mEl, lp.G, mIl)):
            for s in range(0, m, ch):
                e = min(s + ch, m)
                chunk(col + s, W[:, s:e, :].mT,
                      torch.zeros((N, mE + mI, e - s), dtype=dt, device=dev))
        return contrib

    def factorization_ok(self, fac: ArrowFactors) -> torch.Tensor:
        return fac.ok

    # ------------------------------------------------------------------
    def _leaf_solve(self, fac: ArrowFactors, rho_x, rho_m):
        """Batched K_i^{-1} applied to (rho_x [N,n], rho_m [N,mE+mI])."""
        fd = self.factor_dtype
        M = self.M
        t = torch.einsum("...iam,...im->...ia", M, fac.Einv * rho_x) - rho_m
        gm = self._apply_Ninv_multi(fac.L, fac.Ninv,
                                    t[..., None].to(fd))[..., 0]
        gm = gm.to(rho_x.dtype)
        gx = fac.Einv * (rho_x - torch.einsum("...iam,...ia->...im", M, gm))
        return gx, gm

    def _root_solve(self, fac: ArrowFactors, p, q):
        """Solve S [a; d] = [p; q] via the cached root factorization."""
        fd = self.root_dtype
        dt = p.dtype
        if fac.RbG is not None:
            # banded-root Dsolve: S11x a = p + S12 SDD^{-1} q;
            # d = -SDD^{-1} (q - S12' a)   (two banded sweeps and one small
            # dense solve: the 2-link root counterpart of Dsolve)
            S12p = fac.T.to(fd)                          # [n0, nD] permuted
            qp = q[self._rb_perm].to(fd)[:, None]
            t = self._rb_solve(fac.RbG, qp)
            a = _bchol_solve(fac.chol1, p.to(fd) + (S12p @ t)[:, 0])
            rd = qp - (S12p.mT @ a)[:, None]
            d = -self._rb_solve(fac.RbG, rd)[:, 0][self._rb_iperm]
            return a.to(dt), d.to(dt)
        if fac.Sinv is not None:
            u = _mv(fac.Sinv, torch.cat([p, q], dim=-1).to(fd)).to(dt)
            return u[..., :p.shape[-1]], u[..., p.shape[-1]:]
        if fac.Pchol is not None:
            # Dsolve by preconditioned CG on the SPD dual Schur complement
            # (the reference's iterative root solve with the sparsified
            # preconditioner, sLinsysRootAug.C:930, precondSC)
            q2 = q.to(fd) - _mv(fac.T.to(fd).mT, p.to(fd))
            dsol, _ = preconditioned_cg(
                q2, lambda v: block_jacobi_apply(fac.Pchol, v),
                lambda v: _mv(fac.Sd, v), _vdot, self.it_root_maxiter,
                self.it_root_tol)
            d = -dsol.to(dt)
            a = _bchol_solve(fac.chol1, p.to(fd)).to(dt) - _mv(fac.T, d)
            return a, d
        q2 = (q - _mv(fac.T.mT, p)).to(fd)
        if self.root_explicit_inverse:
            d = -_mv(fac.Sdinv, q2).to(dt)
            a = _mv(fac.S11inv, p.to(fd)).to(dt) - _mv(fac.T, d)
        else:
            d = -_bchol_solve(fac.chol2, q2).to(dt)   # Sdual = -(S22 - ..)
            a = _bchol_solve(fac.chol1, p.to(fd)).to(dt) - _mv(fac.T, d)
        return a, d

    def solve_reduced(self, fac: ArrowFactors, rhs: ReducedRhs,
                      refinement_steps: int = 1):
        lp = self.lp
        m0E, m0I, mEl = lp.m0E, lp.m0I, lp.mEl
        mE = lp.mE

        nb = len(self.batch_shape)
        rho_x = -rhs.rhat_x.blocks
        rho_m = torch.cat([-rhs.rA.blocks, -rhs.rhat_z.blocks], dim=-1)
        p0 = -rhs.rhat_x.first
        q0 = torch.cat([-rhs.rA.first, -rhs.rhat_z.first,
                        -rhs.rA.link, -rhs.rhat_z.link], dim=-1)

        state = self._solve_core(fac, p0, q0, rho_x, rho_m)

        if refinement_steps > 0:
            # adaptive iterative refinement on the augmented residual in
            # the working dtype (absorbs f32 factorization error; the role
            # of solveCompressedIterRefin, LinearSystem.C:877)
            rhs_norm = torch.clamp(
                torch.maximum(_maxabs(rho_x, nb),
                              torch.maximum(_maxabs(p0, nb),
                                            _maxabs(q0, nb))),
                min=1e-30)

            def resid_norm(st):
                r = self._aug_residual(fac, p0, q0, rho_x, rho_m, *st)
                nrm = torch.stack([_maxabs(e, nb) for e in
                                   (r[2], r[3], r[0], r[1])], -1).amax(-1)
                return r, nrm

            def refine(carry):
                state_, res_, nrm_, _ = carry
                corr = self._solve_core(fac, *res_)
                new = tuple(s + c for s, c in zip(state_, corr))
                res2, nrm2 = resid_norm(new)
                # keep the better iterate if refinement diverged
                worse = nrm2 > nrm_
                return (select(worse, state_, new), res2,
                        torch.where(worse, nrm_, nrm2), nrm_)

            res, nrm = resid_norm(state)
            state, _, _, _ = dev_while(
                lambda c: (c[2] > 1e-11 * rhs_norm) & (c[2] < 0.25 * c[3]),
                refine, (state, res, nrm, torch.full_like(nrm, float("inf"))),
                refinement_steps)

        dx_first, dx_blocks, d0, gm = state
        # unpack: d0 = [yhat0, zhat0, yhat_l, zhat_l]; gm = [yhat_i, zhat_i]
        yl0, zl0 = m0E + m0I, m0E + m0I + mEl
        dy = RVec(-d0[..., :m0E], -gm[..., :mE], -d0[..., yl0:zl0])
        dz = RVec(-d0[..., m0E:yl0], -gm[..., mE:], -d0[..., zl0:])
        return XVec(dx_first, dx_blocks), dy, dz

    def _solve_core(self, fac: ArrowFactors, p0, q0, rho_x, rho_m):
        """One pass of Lsolve -> Dsolve -> Ltsolve (sLinsysRootAug.C:323-365)."""
        lp = self.lp
        mE = lp.mE
        yl0, zl0 = lp.m0E + lp.m0I, lp.m0E + lp.m0I + lp.mEl

        # Lsolve: leaf solves + accumulate border products
        gx, gm = self._leaf_solve(fac, rho_x, rho_m)
        acc_x0 = (torch.einsum("...imk,...im->...k", lp.A, gm[..., :mE])
                  + torch.einsum("...imk,...im->...k", lp.C, gm[..., mE:]))
        acc_yl = torch.einsum("...ilm,...im->...l", lp.F, gx)
        acc_zl = torch.einsum("...ilm,...im->...l", lp.G, gx)

        p = p0 - acc_x0
        q = torch.cat([q0[..., :yl0], q0[..., yl0:zl0] - acc_yl,
                       q0[..., zl0:] - acc_zl], dim=-1)

        # Dsolve: root dense solve
        a, d = self._root_solve(fac, p, q)

        # Ltsolve: back-substitute into blocks
        if fac.Ux is None:
            # no cached K^{-1}R (blockwise Schur complement): K^{-1}(R s0)
            # by one more leaf solve (reference blockwise Ltsolve)
            rx2 = (torch.einsum("ilm,l->im", lp.F, d[yl0:zl0])
                   + torch.einsum("ilm,l->im", lp.G, d[zl0:]))
            rm2 = torch.cat([torch.einsum("imk,k->im", lp.A, a),
                             torch.einsum("imk,k->im", lp.C, a)], dim=1)
            gx2, gm2 = self._leaf_solve(fac, rx2, rm2)
            return a, gx - gx2, d, gm - gm2
        s0 = torch.cat([a, d[..., yl0:zl0], d[..., zl0:]], dim=-1)
        dx_blocks = gx - torch.einsum("...imS,...S->...im", fac.Ux, s0)
        gm_out = gm - torch.einsum("...iaS,...S->...ia", fac.Um, s0)
        return a, dx_blocks, d, gm_out

    # ------------------------------------------------------------------
    # Outer BiCGStab on the whole structured augmented system,
    # preconditioned by one structured solve (the reference's OUTER_SOLVE=2
    # path: LinearSystem::solveCompressedBiCGStab, LinearSystem.C:550, its
    # preconditioner solveCompressed, :500-515).  The state is the tuple
    # (dx_first, dx_blocks, d0, gm) of `_solve_core`.
    # ------------------------------------------------------------------
    def _state_dot(self, a, b):
        ax0, axb, ad0, agm = a
        bx0, bxb, bd0, bgm = b
        return ((_vdot(ax0, bx0) + _vdot(ad0, bd0))
                + (_vdot(axb, bxb) + _vdot(agm, bgm)))

    def _apply_K(self, fac, state):
        """K state: minus `_aug_residual` with a zero right-hand side."""
        ex0, eq0, ex, em = self._aug_residual(
            fac, *(torch.zeros_like(v) for v in
                   (state[0], state[2], state[1], state[3])), *state)
        return (-ex0, -ex, -eq0, -em)

    def solve_reduced_bicgstab(self, fac: ArrowFactors, rhs: ReducedRhs,
                               max_iters: int = 8, tol=1e-10):
        """BiCGStab on K u = rho with M^{-1} = one structured direct solve
        (`_solve_core`).  Returns (dx, dy, dz, stats): the stats (device
        tensors) feed the IPM's corrector budget and probing trigger (the
        reference's Observer feedback, InteriorPointMethod.cpp:819-831)."""
        if self.batch_shape:
            raise NotImplementedError(
                "outer BiCGStab over a stack of LPs is not ported yet "
                "(ROADMAP.md §1: the fused batch under the solve modes)")
        lp = self.lp
        m0E, m0I, mEl, mE = lp.m0E, lp.m0I, lp.mEl, lp.mE
        b = (-rhs.rhat_x.first, -rhs.rhat_x.blocks,
             torch.cat([-rhs.rA.first, -rhs.rhat_z.first, -rhs.rA.link,
                        -rhs.rhat_z.link]),
             torch.cat([-rhs.rA.blocks, -rhs.rhat_z.blocks], dim=1))

        def precond(v):
            x0, xb, d0, gm = v
            return self._solve_core(fac, x0, d0, xb, gm)

        (dx_first, dx_blocks, d0, gm), stats = preconditioned_bicgstab(
            b, precond, lambda v: self._apply_K(fac, v), self._state_dot,
            max_iters, tol)
        yl0, zl0 = m0E + m0I, m0E + m0I + mEl
        dy = RVec(-d0[:m0E], -gm[:, :mE], -d0[yl0:zl0])
        dz = RVec(-d0[m0E:yl0], -gm[:, mE:], -d0[zl0:])
        return XVec(dx_first, dx_blocks), dy, dz, stats

    def _aug_residual(self, fac, p0, q0, rho_x, rho_m,
                      dx_first, dx_blocks, d0, gm):
        """Residual of the full augmented arrowhead system (refinement).

        Unknown layout: (dx_first, dx_blocks) primal; duals with *hat* sign
        (yhat = -dy): d0 = [y0,z0,yl,zl] root, gm = [y_i, z_i] per block."""
        lp = self.lp
        m0E, m0I, mEl = lp.m0E, lp.m0I, lp.mEl
        mE = lp.mE
        dd = fac.delta_d
        # root rows carry the extra in-factorize escalation shift (the
        # leaves stay at dd); E0 = 1/Einv0 already embeds dp + extra
        dd_root = dd + fac.extra_root
        yl0, zl0 = m0E + m0I, m0E + m0I + mEl

        y0h, z0h = d0[..., :m0E], d0[..., m0E:yl0]
        ylh, zlh = d0[..., yl0:zl0], d0[..., zl0:]
        yih, zih = gm[..., :mE], gm[..., mE:]

        ATyh = self.ATy(RVec(y0h, yih, ylh))
        CTzh = self.CTz(RVec(z0h, zih, zlh))
        x = XVec(dx_first, dx_blocks)
        Ax = self.Ax(x)
        Cx = self.Cx(x)

        E0 = 1.0 / fac.Einv0
        Eb = 1.0 / fac.Einv
        top_first = E0 * dx_first + ATyh.first + CTzh.first
        top_blocks = Eb * dx_blocks + ATyh.blocks + CTzh.blocks
        eq_first = Ax.first - bcast(dd_root, y0h) * y0h
        eq_blocks = Ax.blocks - bcast(dd, yih) * yih
        eq_link = Ax.link - bcast(dd_root, ylh) * ylh
        iq_first = Cx.first - (fac.Om0 + bcast(dd_root, z0h)) * z0h
        iq_blocks = Cx.blocks - (fac.Om + bcast(dd, zih)) * zih
        iq_link = Cx.link - (fac.Oml + bcast(dd_root, zlh)) * zlh

        ex0 = p0 - top_first
        ex = rho_x - top_blocks
        em = rho_m - torch.cat([eq_blocks, iq_blocks], dim=-1)
        eq0 = q0 - torch.cat([eq_first, iq_first, eq_link, iq_link], dim=-1)
        return ex0, eq0, ex, em
