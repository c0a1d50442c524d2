"""LP containers: flat dense LP and the doubly bordered block-diagonal (arrowhead) LP.

Counterpart of `pips_ipmpp_tpu/core/lp.py`.  The LP solved:

    min  c'x
    s.t. A x  = b                      (equality rows)
         clow <= C x <= cupp           (inequality rows; per-row indicator
                                        masks iclow/icupp select which sides exist)
         xlow <= x <= xupp             (per-variable indicator masks ixlow/ixupp)

Per-block matrices are stored batched dense and padded to uniform shapes
`[N, rows, cols]`; the padding keeps the padded LP exactly equivalent to the
original one (see `_pad_block`).  Every field is a torch tensor; the
containers are plain dataclasses with `.to(device)` and `.astype(dtype)`.

`stack_lps` stacks B same-shape arrowhead LPs into one `ArrowheadLP`
whose every field has a leading batch axis (`batch_shape == (B,)`), the
input of the fused batch solve; a single LP has `batch_shape == ()`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def _map_fields(obj, fn):
    return type(obj)(**{f.name: fn(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)})


def _maxabs(t: torch.Tensor, nb: int = 0) -> torch.Tensor:
    """max |t| over all of t, or per LP over all but the `nb` leading
    axes (0 where that is empty)."""
    if t[(0,) * nb].numel() == 0:
        return t.new_zeros(t.shape[:nb])
    return t.abs().reshape(t.shape[:nb] + (-1,)).amax(-1)


@dataclass
class DenseLP:
    """Flat (unstructured) LP, solved by `linalg/dense_backend.py`."""

    c: torch.Tensor        # [n]
    A: torch.Tensor        # [mE, n] equality matrix
    b: torch.Tensor        # [mE]
    C: torch.Tensor        # [mI, n] inequality matrix
    iclow: torch.Tensor    # [mI] 0/1 mask
    clow: torch.Tensor     # [mI]
    icupp: torch.Tensor    # [mI]
    cupp: torch.Tensor     # [mI]
    ixlow: torch.Tensor    # [n]
    xlow: torch.Tensor     # [n]
    ixupp: torch.Tensor    # [n]
    xupp: torch.Tensor     # [n]

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def mE(self) -> int:
        return self.b.shape[-1]

    @property
    def mI(self) -> int:
        return self.clow.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.c.dtype

    def astype(self, dtype) -> "DenseLP":
        return _map_fields(self, lambda t: t.to(dtype))

    def to(self, device) -> "DenseLP":
        return _map_fields(self, lambda t: t.to(device))

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return torch.dot(self.c, x)

    def datanorm(self) -> torch.Tensor:
        """inf-norm over all problem data (reference Problem::datanorm)."""
        leaves = [self.c, self.A, self.b, self.C,
                  self.clow * self.iclow, self.cupp * self.icupp,
                  self.xlow * self.ixlow, self.xupp * self.ixupp]
        return torch.stack([_maxabs(t) for t in leaves]).amax()


@dataclass
class ArrowheadLP:
    """Doubly bordered block-diagonal LP, batched-dense representation.

    Shapes (all padded-uniform): N blocks; per-block n vars, mE eq rows,
    mI ineq rows; first stage n0 vars, m0E eq, m0I ineq; linking mEl eq
    rows and mIl ineq rows.
    """

    # ---- first stage (block 0) ----
    c0: torch.Tensor       # [n0]
    A0: torch.Tensor       # [m0E, n0]
    b0: torch.Tensor       # [m0E]
    C0: torch.Tensor       # [m0I, n0]
    iclow0: torch.Tensor   # [m0I]
    clow0: torch.Tensor
    icupp0: torch.Tensor
    cupp0: torch.Tensor
    ixlow0: torch.Tensor   # [n0]
    xlow0: torch.Tensor
    ixupp0: torch.Tensor
    xupp0: torch.Tensor

    # ---- per-block, batched [N, ...] ----
    cN: torch.Tensor       # [N, n]
    A: torch.Tensor        # [N, mE, n0]  border (couples to x0)
    B: torch.Tensor        # [N, mE, n]   diagonal block
    bN: torch.Tensor       # [N, mE]
    C: torch.Tensor        # [N, mI, n0]  ineq border
    D: torch.Tensor        # [N, mI, n]   ineq diagonal
    iclowN: torch.Tensor   # [N, mI]
    clowN: torch.Tensor
    icuppN: torch.Tensor
    cuppN: torch.Tensor
    ixlowN: torch.Tensor   # [N, n]
    xlowN: torch.Tensor
    ixuppN: torch.Tensor
    xuppN: torch.Tensor

    # ---- linking rows (bottom border) ----
    F0: torch.Tensor       # [mEl, n0]
    F: torch.Tensor        # [N, mEl, n]
    bl: torch.Tensor       # [mEl]
    G0: torch.Tensor       # [mIl, n0]
    G: torch.Tensor        # [N, mIl, n]
    iclowl: torch.Tensor   # [mIl]
    clowl: torch.Tensor
    icuppl: torch.Tensor
    cuppl: torch.Tensor

    # ------------------------------------------------------------------
    @property
    def batch_shape(self) -> tuple:
        """() for one LP, (B,) for a stack of B LPs (`stack_lps`)."""
        return tuple(self.c0.shape[:-1])

    @property
    def N(self) -> int:
        return self.cN.shape[-2]

    @property
    def n0(self) -> int:
        return self.c0.shape[-1]

    @property
    def n(self) -> int:
        return self.cN.shape[-1]

    @property
    def mE(self) -> int:
        return self.bN.shape[-1]

    @property
    def mI(self) -> int:
        return self.clowN.shape[-1]

    @property
    def m0E(self) -> int:
        return self.b0.shape[-1]

    @property
    def m0I(self) -> int:
        return self.clow0.shape[-1]

    @property
    def mEl(self) -> int:
        return self.bl.shape[-1]

    @property
    def mIl(self) -> int:
        return self.clowl.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.c0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.c0.dtype

    def astype(self, dtype) -> "ArrowheadLP":
        return _map_fields(self, lambda t: t.to(dtype))

    def to(self, device) -> "ArrowheadLP":
        return _map_fields(self, lambda t: t.to(device))

    # ------------------------------------------------------------------
    def total_vars(self) -> int:
        return self.n0 + self.N * self.n

    def total_eq(self) -> int:
        return self.m0E + self.N * self.mE + self.mEl

    def total_ineq(self) -> int:
        return self.m0I + self.N * self.mI + self.mIl

    def datanorm(self) -> torch.Tensor:
        """inf-norm over all problem data (reference Problem::datanorm),
        one per LP of a stack."""
        leaves = [self.c0, self.A0, self.b0, self.C0, self.cN, self.A, self.B,
                  self.bN, self.C, self.D, self.F0, self.F, self.bl, self.G0,
                  self.G,
                  self.clow0 * self.iclow0, self.cupp0 * self.icupp0,
                  self.xlow0 * self.ixlow0, self.xupp0 * self.ixupp0,
                  self.clowN * self.iclowN, self.cuppN * self.icuppN,
                  self.xlowN * self.ixlowN, self.xuppN * self.ixuppN,
                  self.clowl * self.iclowl, self.cuppl * self.icuppl]
        nb = len(self.batch_shape)
        return torch.stack([_maxabs(t, nb) for t in leaves], -1).amax(-1)


def stack_lps(lps) -> ArrowheadLP:
    """One `ArrowheadLP` of B same-shape LPs, every field stacked on a new
    leading axis (the JAX package stacks its batch the same way,
    `jax.tree.map(jnp.stack)`).  Refuses LPs that are not all single
    `ArrowheadLP`s of one dtype and device, or whose fields differ in
    shape, naming the field; the LPs share one sparsity pattern in the
    dense layout by construction."""
    lps = list(lps)
    if not lps:
        raise ValueError("stack_lps needs at least one LP")
    for i, lp in enumerate(lps):
        if not isinstance(lp, ArrowheadLP):
            raise TypeError(f"stack_lps: LP {i} is a {type(lp).__name__}, "
                            f"not an ArrowheadLP")
        if lp.batch_shape != ():
            raise ValueError(f"stack_lps: LP {i} is already a stack "
                             f"(batch shape {lp.batch_shape})")
    ref = lps[0]
    for i, lp in enumerate(lps[1:], 1):
        if (lp.dtype, lp.device) != (ref.dtype, ref.device):
            raise ValueError(f"stack_lps: LP {i} is {lp.dtype} on "
                             f"{lp.device}, LP 0 {ref.dtype} on {ref.device}")
        for f in dataclasses.fields(ArrowheadLP):
            a, b = getattr(ref, f.name), getattr(lp, f.name)
            if a.shape != b.shape:
                raise ValueError(f"stack_lps: field {f.name} of LP {i} has "
                                 f"shape {tuple(b.shape)}, LP 0's "
                                 f"{tuple(a.shape)}")
    return ArrowheadLP(**{f.name: torch.stack([getattr(lp, f.name)
                                               for lp in lps])
                          for f in dataclasses.fields(ArrowheadLP)})


# ======================================================================
# Builders
# ======================================================================

def make_arrowhead_lp(blocks: list[dict], first_stage: dict,
                      linking_eq: Optional[dict] = None,
                      linking_ineq: Optional[dict] = None,
                      dtype=torch.float64, device="cpu") -> ArrowheadLP:
    """Build an ArrowheadLP from per-block dicts of numpy arrays.

    `blocks[i]` keys: c, A (mE x n0 border), B (mE x n diag), b,
    C, D, iclow, clow, icupp, cupp, ixlow, xlow, ixupp, xupp,
    F (mEl x n), G (mIl x n).
    `first_stage` keys: c, A, b, C, iclow..cupp, ixlow..xupp, F0 (mEl x n0),
    G0 (mIl x n0).
    `linking_eq`: {b: [mEl]}; `linking_ineq`: {iclow, clow, icupp, cupp}.

    Blocks may have heterogeneous shapes; they are padded to the max with
    exact-equivalence padding.  Everything stays numpy until the final
    conversion to tensors of `dtype` on `device`.
    """
    blocks = [dict(blk) for blk in blocks]
    fs = dict(first_stage)
    mEl = fs.get("F0", np.zeros((0, len(fs["c"])))).shape[0]
    mIl = fs.get("G0", np.zeros((0, len(fs["c"])))).shape[0]
    n0 = len(fs["c"])

    n_max = max(len(blk["c"]) for blk in blocks)
    mE_max = max(blk["b"].shape[0] for blk in blocks)
    mI_max = max(blk["clow"].shape[0] for blk in blocks)
    blocks = [_pad_block(blk, n_max, mE_max, mI_max, n0, mEl, mIl)
              for blk in blocks]

    le = linking_eq or {"b": np.zeros((mEl,))}
    li = linking_ineq or {k: np.zeros((mIl,)) for k in
                          ("iclow", "clow", "icupp", "cupp")}

    if len(np.asarray(le["b"])) != mEl:
        raise ValueError(
            f"linking_eq b has {len(np.asarray(le['b']))} rows but "
            f"first_stage F0 declares mEl={mEl} (pass F0 and per-block F "
            f"strips matching the linking rhs)")
    if len(np.asarray(li["iclow"])) != mIl:
        raise ValueError(
            f"linking_ineq masks have {len(np.asarray(li['iclow']))} rows "
            f"but first_stage G0 declares mIl={mIl}")
    if mIl and linking_ineq is None:
        raise ValueError(
            "G0 declares linking inequality rows but linking_ineq is "
            "None: every inequality row needs at least one finite side "
            "(a both-sides-free row makes the IPM barrier singular)")

    def check_ineq_bounded(il, iu, what):
        bad = np.nonzero((np.asarray(il) <= 0) & (np.asarray(iu) <= 0))
        if bad[0].size:
            raise ValueError(
                f"{what}: row(s) {bad[0][:5].tolist()} have neither a "
                f"lower nor an upper bound — drop them or bound one side")

    check_ineq_bounded(fs["iclow"], fs["icupp"], "first-stage ineq")
    check_ineq_bounded(li["iclow"], li["icupp"], "linking ineq")
    for i, blk in enumerate(blocks):
        check_ineq_bounded(blk["iclow"], blk["icupp"], f"block {i} ineq")

    def arr(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    def stack(key):
        return arr(np.stack([blk[key] for blk in blocks]))

    return ArrowheadLP(
        c0=arr(fs["c"]), A0=arr(fs["A"]), b0=arr(fs["b"]), C0=arr(fs["C"]),
        iclow0=arr(fs["iclow"]), clow0=arr(fs["clow"]),
        icupp0=arr(fs["icupp"]), cupp0=arr(fs["cupp"]),
        ixlow0=arr(fs["ixlow"]), xlow0=arr(fs["xlow"]),
        ixupp0=arr(fs["ixupp"]), xupp0=arr(fs["xupp"]),
        cN=stack("c"), A=stack("A"), B=stack("B"), bN=stack("b"),
        C=stack("C"), D=stack("D"),
        iclowN=stack("iclow"), clowN=stack("clow"),
        icuppN=stack("icupp"), cuppN=stack("cupp"),
        ixlowN=stack("ixlow"), xlowN=stack("xlow"),
        ixuppN=stack("ixupp"), xuppN=stack("xupp"),
        F0=arr(fs.get("F0", np.zeros((0, n0)))), F=stack("F"),
        bl=arr(le["b"]),
        G0=arr(fs.get("G0", np.zeros((0, n0)))), G=stack("G"),
        iclowl=arr(li["iclow"]), clowl=arr(li["clow"]),
        icuppl=arr(li["icupp"]), cuppl=arr(li["cupp"]),
    )


def _pad_block(blk: dict, n: int, mE: int, mI: int,
               n0: int, mEl: int, mIl: int) -> dict:
    """Pad one block to uniform (n, mE, mI) preserving exact LP equivalence.

    - padded variables get objective 0 and box bounds [-1, 1] — they
      decouple;
    - padded eq rows are paired with padded variables where possible
      (B[pad_row, pad_col] = 1, rhs 0 pins the padded var to 0); unpaired
      padded eq rows are zero rows with rhs 0 (dual regularization
      handles them);
    - padded ineq rows are zero rows bounded in [-1, 1].
    """
    blk = dict(blk)
    n_old = len(blk["c"])
    mE_old = blk["b"].shape[0]
    mI_old = blk["clow"].shape[0]
    dn, dE, dI = n - n_old, mE - mE_old, mI - mI_old
    f = np.asarray

    blk["c"] = np.concatenate([f(blk["c"]), np.zeros(dn)])
    blk["ixlow"] = np.concatenate([f(blk["ixlow"]), np.ones(dn)])
    blk["xlow"] = np.concatenate([f(blk["xlow"]), -np.ones(dn)])
    blk["ixupp"] = np.concatenate([f(blk["ixupp"]), np.ones(dn)])
    blk["xupp"] = np.concatenate([f(blk["xupp"]), np.ones(dn)])

    B = np.zeros((mE, n))
    B[:mE_old, :n_old] = blk["B"]
    for j in range(min(dE, dn)):
        B[mE_old + j, n_old + j] = 1.0
    blk["B"] = B
    A = np.zeros((mE, n0))
    A[:mE_old] = blk["A"]
    blk["A"] = A
    blk["b"] = np.concatenate([f(blk["b"]), np.zeros(dE)])

    D = np.zeros((mI, n))
    D[:mI_old, :n_old] = blk["D"]
    blk["D"] = D
    C = np.zeros((mI, n0))
    C[:mI_old] = blk["C"]
    blk["C"] = C
    blk["iclow"] = np.concatenate([f(blk["iclow"]), np.ones(dI)])
    blk["clow"] = np.concatenate([f(blk["clow"]), -np.ones(dI)])
    blk["icupp"] = np.concatenate([f(blk["icupp"]), np.ones(dI)])
    blk["cupp"] = np.concatenate([f(blk["cupp"]), np.ones(dI)])

    Fm = np.zeros((mEl, n))
    Fm[:, :n_old] = blk.get("F", np.zeros((mEl, n_old)))
    blk["F"] = Fm
    Gm = np.zeros((mIl, n))
    Gm[:, :n_old] = blk.get("G", np.zeros((mIl, n_old)))
    blk["G"] = Gm
    return blk
