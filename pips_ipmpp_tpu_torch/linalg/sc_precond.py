r"""Schur-complement sparsifier + preconditioner for the iterative root.

Counterpart of `pips_ipmpp_tpu/linalg/sc_precond.py` (the reference's
SCsparsifier + preconditioned root solve, Core/LinearSolvers/
Preconditioners/SCsparsifier.h:18-58, `DistributedRootLinearSystem::
precondSC`, DistributedRootLinearSystem.h:130): when the linking dimension
grows, the O(nD^3) dense factorization of the dual Schur complement
dominates; the root then runs preconditioned CG with a *sparsified* Schur
complement as the preconditioner.

As in the JAX package the preconditioner is *panel block-Jacobi*:

  - the dual Schur complement is cut into [pb, pb] diagonal panels,
    factored in one batched Cholesky (O(nD * pb^2));
  - inside each panel the reference's drop rule is applied (|s_ij| kept
    iff >= t*|s_ii| or >= t*|s_jj|, SCsparsifier.C:213-234);
  - the root solve becomes preconditioned CG with the dense Schur
    complement as its matvec (`arrow_backend.preconditioned_cg`).

The panels' Cholesky follows the f64 root's rule (`arrow_backend.
_root_cholesky`): with f64 on the card the potf2 kernel (LAPACK's order,
ROADMAP.md §3, F3), one batched call over the panels; otherwise
torch.linalg.  The `diagDomBounds` ladder and its moves are kept verbatim
in `SCsparsifier`.
"""
from __future__ import annotations

import torch

# reference threshold ladders (SCsparsifier.h:18-20); position moves
# right = less aggressive sparsification (keeps more entries)
DIAG_DOM_BOUNDS = (0.001, 0.0005, 0.0002, 0.000025, 0.000005, 0.000001)
DIAG_DOM_BOUNDS_LEAF = (0.002, 0.001, 0.0003, 0.000025, 0.000005, 0.000001)


class SCsparsifier:
    """Host-side threshold ladder (reference SCsparsifier.C:21-78).

    `increase_diag_dom_bound` = more aggressive (drop more, cheaper/weaker
    preconditioner); `decrease_diag_dom_bound` = less aggressive — what an
    IPM `troubles_hook` calls on numerical troubles, as the reference does
    (InteriorPointMethod.cpp:629-637)."""

    def __init__(self):
        self.position = 0

    @property
    def diag_dom_bound(self) -> float:
        return DIAG_DOM_BOUNDS[self.position]

    @property
    def diag_dom_bound_leaf(self) -> float:
        return DIAG_DOM_BOUNDS_LEAF[self.position]

    def increase_diag_dom_bound(self) -> bool:
        if self.position > 0:
            self.position -= 1
            return True
        return False

    def decrease_diag_dom_bound(self) -> bool:
        if self.position < len(DIAG_DOM_BOUNDS) - 1:
            self.position += 1
            return True
        return False


def sparsified_panels(Sd: torch.Tensor, panel: int, diag_dom_bound: float):
    """The [k, pb, pb] diagonal panels of Sd [nD, nD] (padded with the
    identity to k pb rows) with the reference's dominance drop rule applied
    inside each panel: off-diagonal s_ij is kept iff |s_ij| >= t*|s_ii| or
    |s_ij| >= t*|s_jj|; the diagonal is always kept.  Returns the panels
    and the fraction of within-panel off-diagonal entries dropped (a device
    scalar; the reference's updateStats ratio)."""
    nD = Sd.shape[-1]
    pad = (-nD) % panel
    if pad:
        Sp = torch.zeros((nD + pad, nD + pad), dtype=Sd.dtype,
                         device=Sd.device)
        Sp[:nD, :nD] = Sd
        Sp[nD:, nD:] = torch.eye(pad, dtype=Sd.dtype, device=Sd.device)
    else:
        Sp = Sd
    k = Sp.shape[0] // panel
    # [k, pb, k, pb] -> the k diagonal blocks [k, pb, pb]
    panels = Sp.reshape(k, panel, k, panel).diagonal(dim1=0, dim2=2) \
        .permute(2, 0, 1)
    diag = panels.diagonal(dim1=-2, dim2=-1).abs()            # [k, pb]
    mag = panels.abs()
    keep = ((mag >= diag_dom_bound * diag[:, :, None])
            | (mag >= diag_dom_bound * diag[:, None, :])
            | torch.eye(panel, dtype=torch.bool, device=Sd.device))
    sparsified = torch.where(keep, panels, 0.0)
    off = panel * panel - panel
    kept = (keep.sum() - k * panel).to(Sd.dtype)
    return sparsified, 1.0 - kept / max(k * off, 1)


def block_jacobi_factors(Sd: torch.Tensor, panel: int,
                         diag_dom_bound: float):
    """Batched Cholesky of the sparsified diagonal panels of the SPD dual
    Schur complement: the preconditioner's factorization (the role of the
    reference's PARDISO factorization of the sparsified Schur complement).
    Returns (Pchol [k, pb, pb], ok, dropped share); a failed panel factor
    shows in `ok` (torch.linalg does not fill it with NaN as JAX does)."""
    from pips_ipmpp_tpu_torch.linalg.arrow_backend import _root_cholesky

    panels, dropped = sparsified_panels(Sd, panel, diag_dom_bound)
    Pchol, ok = _root_cholesky(panels, 1)
    return Pchol, ok.all(), dropped


def block_jacobi_apply(Pchol: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Apply the preconditioner, block-diagonally: [nD] -> [nD]."""
    k, pb, _ = Pchol.shape
    nD = r.shape[0]
    pad = k * pb - nD
    rp = torch.cat([r, r.new_zeros(pad)]) if pad else r
    u = torch.linalg.solve_triangular(Pchol, rp.reshape(k, pb, 1),
                                      upper=False)
    u = torch.linalg.solve_triangular(Pchol.mT, u, upper=True)
    return u.reshape(k * pb)[:nD]
