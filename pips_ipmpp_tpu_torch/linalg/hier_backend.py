r"""Hierarchical (k-layer) Schur complement backend.

Counterpart of `pips_ipmpp_tpu/linalg/hier_backend.py` (the reference's
HIERARCHICAL option: DistributedTreeCallbacks::splitTree +
shaveDenseBorder, DistributedTreeCallbacks.C:753,1123,1191;
sLinsysRootBordered / sLinsysRootAugHierInner; link-structure exploitation,
DistributedProblem.hpp:105):

  - Linking rows whose support lies within ONE group of blocks ("local"
    rows: the reference's 2-link/k-link structure) are eliminated at an
    intermediate group-level Schur stage.
  - Only the first stage and the truly global linking rows reach the
    dense top system, which stays small as N and the linking-row count
    grow.

Layout transform (host numpy, once; `build_hierarchical_lp`): linking rows
are permuted to [group-0 locals | group-1 locals | ... | globals] and the
per-group local counts padded to a uniform (mElL, mIlL) with inert rows,
giving a plain ArrowheadLP in "hierarchical layout": the formulation and
the IPM are unchanged, only factorize and solve differ.  Deeper layers
(`coarse_levels`) put rows local to a coarse group of groups in per-level
sections at the front of the global part.

Factorization (every level batched):
  level 0: per-block condensed factor (ArrowBackend's `_leaf_factor`: the
           LDL kernel with f32 factors, Cholesky with f64);
  level 1: per-group Schur over the group's local linking rows (one
           batched Cholesky over the groups, cached W_in = K_b^{-1} R_in);
  coarse levels: one batched Cholesky per level over its coarse groups'
           rows of the top dual block;
  top:     S11 and the dual Schur complement over (x0, y0, z0, yl_glob,
           zl_glob), by the two-level Cholesky (triangular solves, no
           explicit inverses).
Every f64 Cholesky here is `arrow_backend._root_cholesky` (potf2 on the
card, LAPACK's order).

Factorization and solves are capture-clean (no read-back); the
refinement is a `control.dev_while`, a WHILE node in the fused graph.
One LP on one device: a stack of LPs (the fused batch) and the mesh
(`axis`, `n_shards`, `dist_root`) are not ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP
from pips_ipmpp_tpu_torch.core.spaces import RVec, XVec, _vdot, select, tmap
from pips_ipmpp_tpu_torch.ipm.control import dev_while
from pips_ipmpp_tpu_torch.ipm.formulation import ReducedRhs
from pips_ipmpp_tpu_torch.linalg.arrow_backend import (
    ArrowBackend, _bchol_solve, _mv, _record, _root_cholesky,
    preconditioned_bicgstab, scalar)


# ======================================================================
# Link-locality analysis + hierarchical layout construction (host numpy,
# bit for bit the JAX package's)
# ======================================================================

@dataclass
class HierMeta:
    n_groups: int
    group_size: int          # blocks per group
    mElL: int                # padded local eq link rows per group
    mIlL: int
    mElG: int                # EFFECTIVE global eq link rows (includes the
    mIlG: int                # coarse sections when levels is non-empty)
    permE: np.ndarray        # new eq-link layout -> old row index (-1 = pad)
    permI: np.ndarray
    # deeper layers (hierarchical_layers = 2 + len(levels)): rows local to
    # a level-l coarse group (but not to any finer level) sit in per-level
    # sections at the FRONT of the "global" part, padded to uniform width
    # per group, and are eliminated by one batched per-group Cholesky per
    # level before the dense top factorization.  A finer group lies inside
    # exactly one coarser group, so every level's block stays exactly
    # block-diagonal after the finer levels' downdates.
    # levels = ((C, mEl_c, mIl_c), ...) ordered finest -> coarsest;
    # () -> plain 2-layer scheme.
    levels: tuple = ()

    # single-coarse-level accessors (layers == 3)
    @property
    def n_coarse(self) -> int:
        return self.levels[0][0] if self.levels else 0

    @property
    def mEl2(self) -> int:
        return self.levels[0][1] if self.levels else 0

    @property
    def mIl2(self) -> int:
        return self.levels[0][2] if self.levels else 0


def analyze_link_locality(F: np.ndarray, n_groups: int) -> np.ndarray:
    """Group id per linking row: g if all nonzero block-strips lie in group
    g, else -1 (global). F: [N, ml, n]."""
    N, ml, _ = F.shape
    gs = N // n_groups
    owner = np.full(ml, -1, np.int64)
    touched = (np.abs(F) > 0).any(axis=2)    # [N, ml]
    for r in range(ml):
        blocks = np.nonzero(touched[:, r])[0]
        if blocks.size == 0:
            owner[r] = 0     # empty row: assign anywhere (group 0)
            continue
        groups = set(int(b) // gs for b in blocks)
        if len(groups) == 1:
            owner[r] = groups.pop()
    return owner


def build_hierarchical_lp(lp: ArrowheadLP, n_groups: int,
                          n_coarse: int = 0,
                          coarse_levels: tuple = ()
                          ) -> tuple[ArrowheadLP, HierMeta]:
    """Permute+pad linking rows into hierarchical layout (one host copy of
    the linking data; the new LP on `lp`'s device, in its dtype).

    `coarse_levels = (C2, C3, ...)` (finest -> coarsest, each dividing
    the previous; `n_coarse` is the single-level shorthand) adds one
    layer per entry: rows whose support exceeds every finer grouping
    but fits one level-l group are placed in that level's section of
    the global part, padded per group, and eliminated by a batched
    per-group Schur stage before the dense top factorization
    (hierarchical_layers = 2 + len(coarse_levels); reference splitTree
    recursion, DistributedTreeCallbacks.C:1123,1194-1217)."""
    if lp.N % n_groups != 0:
        raise ValueError(f"N={lp.N} not divisible by n_groups={n_groups}")
    if n_coarse:
        coarse_levels = (n_coarse,) + tuple(coarse_levels)
    prev = n_groups
    for C in coarse_levels:
        if C <= 0 or prev % C != 0:
            raise ValueError(f"coarse level sizes {coarse_levels} must "
                             f"divide the previous level ({prev} % {C})")
        prev = C
    host = {name: getattr(lp, name).detach().cpu().numpy()
            for name in ("F0", "F", "bl", "G0", "G", "iclowl", "clowl",
                         "icuppl", "cuppl")}
    Fn, Gn = host["F"], host["G"]
    ownE = analyze_link_locality(Fn, n_groups) if lp.mEl else np.zeros(0, int)
    ownI = analyze_link_locality(Gn, n_groups) if lp.mIl else np.zeros(0, int)
    ownsE = [analyze_link_locality(Fn, C) if lp.mEl else np.zeros(0, int)
             for C in coarse_levels]
    ownsI = [analyze_link_locality(Gn, C) if lp.mIl else np.zeros(0, int)
             for C in coarse_levels]

    def layout(owner, owners_lvl):
        locs = [np.nonzero(owner == g)[0] for g in range(n_groups)]
        mL = max((len(l) for l in locs), default=0)
        perm = []
        for g in range(n_groups):
            perm += list(locs[g]) + [-1] * (mL - len(locs[g]))
        assigned = owner != -1
        widths = []
        for C, own_l in zip(coarse_levels, owners_lvl):
            rows_l = [np.nonzero(~assigned & (own_l == c))[0]
                      for c in range(C)]
            mL2 = max((len(r) for r in rows_l), default=0)
            for c in range(C):
                perm += list(rows_l[c]) + [-1] * (mL2 - len(rows_l[c]))
                assigned[rows_l[c]] = True
            widths.append(mL2)
        glob = np.nonzero(~assigned)[0]
        perm += list(glob)
        mG = sum(C * w for C, w in zip(coarse_levels, widths)) + len(glob)
        return np.asarray(perm, np.int64), mL, mG, widths

    permE, mElL, mElG, widthsE = layout(ownE, ownsE)
    permI, mIlL, mIlG, widthsI = layout(ownI, ownsI)
    levels = tuple((C, wE, wI) for C, wE, wI
                   in zip(coarse_levels, widthsE, widthsI))
    meta = HierMeta(n_groups=n_groups, group_size=lp.N // n_groups,
                    mElL=mElL, mIlL=mIlL, mElG=mElG, mIlG=mIlG,
                    permE=permE, permI=permI, levels=levels)

    def pick(arr, perm, pad_value, axis):
        out_shape = list(arr.shape)
        out_shape[axis] = len(perm)
        out = np.full(out_shape, pad_value, arr.dtype)
        sel = perm >= 0
        idx_out = [slice(None)] * arr.ndim
        idx_in = [slice(None)] * arr.ndim
        idx_out[axis] = np.nonzero(sel)[0]
        idx_in[axis] = perm[sel]
        out[tuple(idx_out)] = arr[tuple(idx_in)]
        return torch.from_numpy(out).to(device=lp.F.device,
                                        dtype=lp.c0.dtype)

    return dataclasses.replace(
        lp,
        F0=pick(host["F0"], permE, 0.0, 0), F=pick(Fn, permE, 0.0, 1),
        bl=pick(host["bl"], permE, 0.0, 0),
        G0=pick(host["G0"], permI, 0.0, 0), G=pick(Gn, permI, 0.0, 1),
        # padded ineq link rows: inert bounds [-1, 1]
        iclowl=pick(host["iclowl"], permI, 1.0, 0),
        clowl=pick(host["clowl"], permI, -1.0, 0),
        icuppl=pick(host["icuppl"], permI, 1.0, 0),
        cuppl=pick(host["cuppl"], permI, 1.0, 0)), meta


def unpermute_link_one(meta: HierMeta, vec: np.ndarray, which: str,
                       size: int) -> np.ndarray:
    """Map ONE permuted-layout link vector back to original row order
    (which in {"E", "I"}; pad rows, perm == -1, are dropped)."""
    perm = meta.permE if which == "E" else meta.permI
    out = np.zeros(size, vec.dtype)
    sel = perm >= 0
    out[perm[sel]] = vec[np.nonzero(sel)[0]]
    return out


def unpermute_link(meta: HierMeta, vecE: np.ndarray, vecI: np.ndarray,
                   mEl_orig: int, mIl_orig: int):
    """Map permuted-layout link vectors back to original row order."""
    return (unpermute_link_one(meta, vecE, "E", mEl_orig),
            unpermute_link_one(meta, vecI, "I", mIl_orig))


# ======================================================================
# Hierarchical factors + backend
# ======================================================================

@dataclass
class HierFactors:
    """One factorization in hierarchical layout (G groups of Ng blocks,
    mL = mElL + mIlL local rows per group, nSo = n0 + mElG + mIlG outer
    border columns).  Fields a leaf mode does not use are None."""
    L: Optional[torch.Tensor]        # [N, a, a] leaf Cholesky (f64 leaves)
    Ninv: Optional[torch.Tensor]     # [N, a, a] leaf inverse (LDL kernel)
    Einv: torch.Tensor               # [N, n]
    Om: torch.Tensor                 # [N, mI]
    Lloc: torch.Tensor               # [G, mL, mL] Cholesky of -(local Schur)
    Win: torch.Tensor                # [N, n+a, mL]   K_b^{-1} R_in
    WoutB: torch.Tensor              # [N, n+a, nSo]  inner^{-1} R_out, blocks
    WoutL: torch.Tensor              # [G, mL, nSo]   inner^{-1} R_out, links
    chol1: torch.Tensor              # [n0, n0] Cholesky of S11
    T: torch.Tensor                  # [n0, nD] S11^{-1} S12
    chol2: torch.Tensor              # [nD, nD] Cholesky of the dual Schur
    Einv0: torch.Tensor              # [n0]
    Om0: torch.Tensor                # [m0I]
    OmlG: torch.Tensor               # [mIlG]
    OmlL: torch.Tensor               # [G, mIlL]
    delta_p: torch.Tensor
    delta_d: torch.Tensor
    ok: torch.Tensor                 # factorization-health flag
    # deeper layers (meta.levels), finest -> coarsest: per level
    L2: tuple = ()                   # [C, k2, k2] Cholesky of -(coarse block)
    U1: tuple = ()                   # [C, n0, k2]  S12[:, coarse_c]
    U2: tuple = ()                   # [C, nr, k2]  S22[rest, coarse_c]


def _chol(S):
    """`_root_cholesky` of S [..., k, k], an empty S (no rows at a stage)
    included."""
    if S.shape[-1] == 0:
        return S, torch.ones((), dtype=torch.bool, device=S.device)
    L, ok = _root_cholesky(S, 0)
    return L, ok.all()


def _solve(L, b):
    """L L' x = b in L's dtype, returned in b's dtype."""
    return _bchol_solve(L, b.to(L.dtype)).to(b.dtype)


class HierArrowBackend(ArrowBackend):
    """Backend over a hierarchical-layout ArrowheadLP (see
    build_hierarchical_lp).  The matvecs and bounds are inherited; only
    the KKT factorization and solves change.

    As in the JAX package the leaves take the LDL kernel with f32 factors
    (`_leaf_factor`), and the top keeps its triangular solves (no explicit
    inverses).  With f32 factors a root-like factor (a group's local
    Schur, a coarse level's, S11, the dual Schur complement) wider than
    `interface.ROOT_F32_MAX` is factored in f64, as the flat root is."""

    def __init__(self, lp: ArrowheadLP, meta: HierMeta,
                 factor_dtype=torch.float64, axis: Optional[str] = None,
                 n_shards: int = 1, dist_root: bool = False):
        if axis is not None or n_shards != 1 or dist_root:
            raise NotImplementedError(
                "HierArrowBackend over a mesh (axis, n_shards, dist_root) "
                "is not ported yet (ROADMAP.md §1: Distributed)")
        if lp.batch_shape:
            raise NotImplementedError(
                "HierArrowBackend over a stack of LPs is not ported yet "
                "(ROADMAP.md §1: the fused batch under the hierarchy)")
        super().__init__(lp, factor_dtype=factor_dtype,
                         explicit_inverse=False,
                         ldl_kernel=factor_dtype == torch.float32)
        self.meta = meta
        dev = lp.c0.device
        G, m = meta.n_groups, meta
        # padded local eq rows (permE == -1) are decoupled; they get a
        # UNIT diagonal so a zero delta_d (e.g. the Ipopt strategy's fresh
        # steps) cannot produce a zero pivot that poisons the solve
        self._padE = torch.as_tensor(
            (m.permE[:G * m.mElL] < 0).reshape(G, m.mElL),
            dtype=lp.c0.dtype, device=dev)

        # per-level static index maps over the dual vector
        # [m0E | m0I | ylG_eff | zlG_eff]: level-l rows of group c sit at
        # the level's section offsets within the ylG / zlG parts.  Each
        # stage's indices are POSITIONS WITHIN THE SPACE REMAINING after
        # the finer stages were eliminated
        self._lvl = []
        if meta.levels:
            m0E, m0I = lp.m0E, lp.m0I
            nD = m0E + m0I + meta.mElG + meta.mIlG
            base_e = m0E + m0I
            base_i = m0E + m0I + meta.mElG
            cur = np.arange(nD)                 # original ids, current space
            off_e = off_i = 0
            pe_off = meta.n_groups * meta.mElL
            pi_off = meta.n_groups * meta.mIlL
            for (C2, mE2, mI2) in meta.levels:
                ids = np.concatenate([
                    np.stack([np.arange(base_e + off_e + c * mE2,
                                        base_e + off_e + (c + 1) * mE2)
                              for c in range(C2)]),
                    np.stack([np.arange(base_i + off_i + c * mI2,
                                        base_i + off_i + (c + 1) * mI2)
                              for c in range(C2)])], axis=1)  # [C2, k2]
                pos_map = np.full(nD, -1, np.int64)
                pos_map[cur] = np.arange(cur.size)
                idxc_pos = pos_map[ids]
                assert (idxc_pos >= 0).all()
                rest_mask = np.ones(cur.size, bool)
                rest_mask[idxc_pos.reshape(-1)] = False
                idxr_pos = np.nonzero(rest_mask)[0]
                # unit diagonal for PADDED level eq rows, as padE
                padE2 = (meta.permE[pe_off:pe_off + C2 * mE2] < 0
                         ).reshape(C2, mE2)
                padI2 = (meta.permI[pi_off:pi_off + C2 * mI2] < 0
                         ).reshape(C2, mI2)
                pad = np.concatenate([padE2, padI2], axis=1)
                self._lvl.append((
                    torch.as_tensor(idxc_pos, device=dev),
                    torch.as_tensor(idxr_pos, device=dev),
                    torch.as_tensor(pad.astype(np.float64), device=dev),
                    int(cur.size)))
                cur = cur[rest_mask]
                off_e += C2 * mE2
                off_i += C2 * mI2
                pe_off += C2 * mE2
                pi_off += C2 * mI2

    def _cdt(self, width: int) -> torch.dtype:
        """The factor dtype of a root-like factor `width` wide."""
        from pips_ipmpp_tpu_torch import interface

        if (self.factor_dtype == torch.float32
                and width > interface.ROOT_F32_MAX):
            return torch.float64
        return self.factor_dtype

    # -- layout helpers ------------------------------------------------
    def _split_link(self, vec, which: str):
        """Permuted link vector -> (locals [G, mL], globals [mG])."""
        m = self.meta
        mL = m.mElL if which == "E" else m.mIlL
        cnt = m.n_groups * mL
        return vec[:cnt].reshape(m.n_groups, mL), vec[cnt:]

    @staticmethod
    def _join_link(loc, glob):
        return torch.cat([loc.reshape(-1), glob])

    def _local_strips(self):
        """Per-group local link strips [G, Ng, m_local, n]: group g's
        blocks against group g's local rows (views of the LP)."""
        lp, m = self.lp, self.meta
        G, Ng, n = m.n_groups, m.group_size, lp.n

        def strips(W, mL):
            W5 = W[:, :G * mL, :].reshape(G, Ng, G, mL, n)
            return W5.diagonal(dim1=0, dim2=2).permute(3, 0, 1, 2)

        return strips(lp.F, m.mElL), strips(lp.G, m.mIlL)

    def _local_first(self):
        """The first-stage columns of the local rows, [G, mElL, n0] and
        [G, mIlL, n0]."""
        lp, m = self.lp, self.meta
        G = m.n_groups
        return (lp.F0[:G * m.mElL].reshape(G, m.mElL, lp.n0),
                lp.G0[:G * m.mIlL].reshape(G, m.mIlL, lp.n0))

    def _per_block(self, t):
        """A per-group tensor [G, ...] repeated for each of its blocks."""
        m = self.meta
        return t[:, None].expand((m.n_groups, m.group_size) + t.shape[1:]
                                 ).reshape((self.lp.N,) + t.shape[1:])

    # ------------------------------------------------------------------
    def factorize(self, Dx: XVec, Ominv: RVec, delta_p, delta_d
                  ) -> HierFactors:
        lp, m = self.lp, self.meta
        fd = self.factor_dtype
        G, Ng, N = m.n_groups, m.group_size, lp.N
        n0, m0E, m0I = lp.n0, lp.m0E, lp.m0I
        mE, mI, n = lp.mE, lp.mI, lp.n
        mL = m.mElL + m.mIlL
        nSo = n0 + m.mElG + m.mIlG
        dt = Dx.blocks.dtype
        dev = Dx.blocks.device
        dp = scalar(delta_p, Dx.blocks)
        dd = scalar(delta_d, Dx.blocks)

        # ---- level 0: leaf condensation (as the flat backend) ----
        Einv = 1.0 / (Dx.blocks + dp)
        Om = 1.0 / Ominv.blocks
        M, Mf = self.M, self.Mf
        Fd = torch.cat([dd.expand(N, mE), Om + dd], dim=1)
        MEi = M * Einv[:, None, :]
        L, Ninv, leaf_ok = self._leaf_factor(M, MEi, Fd)

        F_l, G_l = self._local_strips()          # [G, Ng, m_local, n]
        F_g = lp.F[:, G * m.mElL:, :]                            # [N,mElG,n]
        G_g = lp.G[:, G * m.mIlL:, :]
        OmlL_inv, OmlG_inv = self._split_link(Ominv.link, "I")
        OmlL = 1.0 / OmlL_inv                                    # [G, mIlL]
        OmlG = 1.0 / OmlG_inv

        # ---- level 1: group Schur over the local links ----
        # R_in rows x_i: [Floc' Gloc']  [G, Ng, n, mL]
        RinX = torch.cat([F_l.transpose(2, 3), G_l.transpose(2, 3)], dim=3)
        flatRinX = RinX.reshape(N, n, mL).to(fd)
        EiR = RinX.reshape(N, n, mL) * Einv[:, :, None]
        EiRf = EiR.to(fd)
        Einvf = Einv.to(fd)[:, :, None]
        # K_b^{-1} R_in via condensation (R_in has zero (y, z) rows)
        Wm = self._apply_Ninv_multi(L, Ninv, Mf @ EiRf)          # [N, a, mL]
        Wx = EiRf - Einvf * (Mf.mT @ Wm)
        Win = torch.cat([Wx, Wm], dim=1)                         # [N, k, mL]

        # local Schur: Sloc = -Floc_diag - R_in' K_b^{-1} R_in
        RtW = (flatRinX.mT @ Wx).reshape(G, Ng, mL, mL).sum(dim=1)
        FlocD = torch.cat([dd + self._padE, OmlL + dd], dim=1)   # [G, mL]
        negSloc = torch.diag_embed(FlocD.to(fd)) + RtW
        Lloc, ok_loc = _chol(negSloc.to(self._cdt(mL)))

        # ---- outer border W_out = K_inner^{-1} R_out ----
        # R_out block rows: x_i: [0 | Fg' Gg'], y_i: [A 0], z_i: [C 0]
        RoX = torch.cat([torch.zeros((N, n, n0), dtype=dt, device=dev),
                         F_g.mT, G_g.mT], dim=2)                 # [N, n, nSo]
        RoM = torch.cat([
            torch.cat([lp.A, torch.zeros((N, mE, nSo - n0), dtype=dt,
                                         device=dev)], 2),
            torch.cat([lp.C, torch.zeros((N, mI, nSo - n0), dtype=dt,
                                         device=dev)], 2)], dim=1)
        # R_out local-link rows: yl_loc: [F0loc | 0], zl_loc: [G0loc | 0]
        F0loc, G0loc = self._local_first()
        RoL = torch.cat([
            torch.cat([F0loc, torch.zeros((G, m.mElL, nSo - n0), dtype=dt,
                                          device=dev)], 2),
            torch.cat([G0loc, torch.zeros((G, m.mIlL, nSo - n0), dtype=dt,
                                          device=dev)], 2)], dim=1)

        # block-level K_b^{-1} R_out (condensed, multi-RHS)
        EiRo = (RoX * Einv[:, :, None]).to(fd)
        WmO = self._apply_Ninv_multi(L, Ninv, Mf @ EiRo - RoM.to(fd))
        WxO = EiRo - Einvf * (Mf.mT @ WmO)
        gB = torch.cat([WxO, WmO], dim=1)                        # [N, k, nSo]

        # local-link correction: w = -negSloc^{-1} (RoL - R_in' gB_x)
        RtG = (flatRinX.mT @ WxO).reshape(G, Ng, mL, nSo).sum(dim=1)
        WoutL = -_solve(Lloc, RoL.to(fd) - RtG)                  # [G, mL, nSo]
        # u = gB - Win w (per block, the group's w)
        WoutB = gB - Win @ self._per_block(WoutL)

        # ---- outer Schur contribution: -(RoX'u_x + RoM'u_m + RoL'w) ----
        contrib = (torch.einsum("imS,imT->ST", RoX.to(fd), WoutB[:, :n, :])
                   + torch.einsum("iaS,iaT->ST", RoM.to(fd), WoutB[:, n:, :])
                   + torch.einsum("gmS,gmT->ST", RoL.to(fd), WoutL)).to(dt)

        # ---- top: root over (x0, y0, z0, ylG, zlG) ----
        Einv0 = 1.0 / (Dx.first + dp)
        Om0 = 1.0 / Ominv.first
        F0g = lp.F0[G * m.mElL:]
        G0g = lp.G0[G * m.mIlL:]
        yl0 = m0E + m0I
        S11 = torch.diag(Dx.first + dp) - contrib[:n0, :n0]
        S12 = torch.cat([lp.A0.mT, lp.C0.mT,
                         F0g.mT - contrib[:n0, n0:n0 + m.mElG],
                         G0g.mT - contrib[:n0, n0 + m.mElG:]], dim=1)
        F0d = torch.cat([dd.expand(m0E), Om0 + dd, dd.expand(m.mElG),
                         OmlG + dd])
        S22 = -torch.diag(F0d)
        S22[yl0:, yl0:] -= contrib[n0:, n0:]

        S11, S12, S22 = S11.to(fd), S12.to(fd), S22.to(fd)
        coarse_ok = torch.ones((), dtype=torch.bool, device=dev)
        L2s, U1s, U2s = [], [], []
        # ---- deeper layers: eliminate each level's coarse-local rows of
        # the top dual block BEFORE the dense factorization, finest level
        # first.  Cross-group Schur entries within a level are exactly
        # zero (disjoint block support, kept under the finer levels'
        # downdates), so each level is one [C, k2, k2] batched Cholesky
        for (idxc, idxr, pad, _sz) in self._lvl:
            Scc = S22[idxc[:, :, None], idxc[:, None, :]]        # [C, k2, k2]
            L2, ok2 = _chol((-Scc + torch.diag_embed(pad.to(fd))).to(
                self._cdt(idxc.shape[1])))
            U1 = S12[:, idxc].transpose(0, 1)                    # [C, n0, k2]
            U2 = S22[idxr][:, idxc].transpose(0, 1)              # [C, nr, k2]
            W1 = _solve(L2, U1.mT)
            W2 = _solve(L2, U2.mT)
            # Scc is negative definite, so the downdate ADDS the PSD
            # U negS2^{-1} U' terms (see _root_solve)
            S11 = S11 + torch.einsum("cnk,ckm->nm", U1, W1)
            S12 = S12[:, idxr] + torch.einsum("cnk,ckr->nr", U1, W2)
            S22 = S22[idxr][:, idxr] + torch.einsum("crk,cks->rs", U2, W2)
            coarse_ok = coarse_ok & ok2
            L2s.append(L2)
            U1s.append(U1.to(dt))
            U2s.append(U2.to(dt))

        chol1, ok1 = _chol(S11.to(self._cdt(n0)))
        T = _solve(chol1, S12)
        d2 = self._cdt(S22.shape[0])
        chol2, ok2 = _chol(-(S22.to(d2) - S12.to(d2).mT @ T.to(d2)))

        return HierFactors(
            L=L, Ninv=Ninv, Einv=Einv, Om=Om, Lloc=Lloc,
            Win=Win.to(dt), WoutB=WoutB.to(dt), WoutL=WoutL.to(dt),
            chol1=chol1, T=T.to(dt), chol2=chol2,
            Einv0=Einv0, Om0=Om0, OmlG=OmlG, OmlL=OmlL, delta_p=dp,
            delta_d=dd, ok=leaf_ok & ok_loc & coarse_ok & ok1 & ok2,
            L2=tuple(L2s), U1=tuple(U1s), U2=tuple(U2s))

    def factorization_ok(self, fac: HierFactors) -> torch.Tensor:
        return fac.ok

    def _root_solve(self, fac: HierFactors, p, q):
        """Top solve; with deeper layers, eliminate each level's coarse
        rows (finest first), solve the reduced dense system by the
        two-level Cholesky, then back-substitute level by level in
        reverse: dc = -negS2^{-1}(qc - U1' a - U2' dr)."""
        fd = self.factor_dtype
        dt = q.dtype
        stages = list(zip(self._lvl, fac.L2, fac.U1, fac.U2))
        qcs = []
        p_cur = p.to(fd)
        q_cur = q.to(fd)
        for (idxc, idxr, _pad, _sz), L2, U1, U2 in stages:
            qc = q_cur[idxc]                                     # [C, k2]
            t = _solve(L2, qc)                                   # negS2^-1 qc
            p_cur = p_cur + torch.einsum("cnk,ck->n", U1.to(fd), t)
            q_cur = q_cur[idxr] + torch.einsum("crk,ck->r", U2.to(fd), t)
            qcs.append(qc)
        a, d = self._top_solve(fac, p_cur.to(dt), q_cur.to(dt))
        af = a.to(fd)
        d = d.to(fd)
        for ((idxc, idxr, _pad, sz), L2, U1, U2), qc in zip(
                reversed(stages), reversed(qcs)):
            rhs = (qc - torch.einsum("cnk,n->ck", U1.to(fd), af)
                   - torch.einsum("crk,r->ck", U2.to(fd), d))
            dc = -_solve(L2, rhs)
            full = torch.zeros((sz,), dtype=fd, device=d.device)
            full[idxr] = d
            full[idxc.reshape(-1)] = dc.reshape(-1)
            d = full
        return a, d.to(dt)

    @staticmethod
    def _top_solve(fac: HierFactors, p, q):
        """The dense top system by the two-level condensation: Sdual =
        -(S22 - S12' S11^{-1} S12)."""
        d = -_solve(fac.chol2, q - _mv(fac.T.mT, p))
        a = _solve(fac.chol1, p) - _mv(fac.T, d)
        return a, d

    # ------------------------------------------------------------------
    def _rhs_parts(self, rhs: ReducedRhs):
        """The reduced right-hand side in the state layout's argument
        order (p0, q0, rho_x, rho_m, rho_lnk)."""
        rAl_loc, rAl_glob = self._split_link(-rhs.rA.link, "E")
        rzl_loc, rzl_glob = self._split_link(-rhs.rhat_z.link, "I")
        return (-rhs.rhat_x.first,
                torch.cat([-rhs.rA.first, -rhs.rhat_z.first, rAl_glob,
                           rzl_glob]),
                -rhs.rhat_x.blocks,
                torch.cat([-rhs.rA.blocks, -rhs.rhat_z.blocks], dim=1),
                torch.cat([rAl_loc, rzl_loc], dim=1))

    def _unpack(self, sol):
        """(dx, dy, dz) from a state (x0, xb, d0, gm, wl) of hat-sign
        duals."""
        lp, m = self.lp, self.meta
        m0E, yl0, mE = lp.m0E, lp.m0E + lp.m0I, lp.mE
        dx0, dxb, d0, gm, wl = sol
        ylh = self._join_link(wl[:, :m.mElL], d0[yl0:yl0 + m.mElG])
        zlh = self._join_link(wl[:, m.mElL:], d0[yl0 + m.mElG:])
        yhat = RVec(d0[:m0E], gm[:, :mE], ylh)
        zhat = RVec(d0[m0E:yl0], gm[:, mE:], zlh)
        return (XVec(dx0, dxb), tmap(torch.neg, yhat),
                tmap(torch.neg, zhat))

    def solve_reduced(self, fac: HierFactors, rhs: ReducedRhs,
                      refinement_steps: int = 1):
        parts = self._rhs_parts(rhs)
        sol = self._solve_core_hier(fac, *parts)

        if refinement_steps > 0:
            # keep-better refinement: an f32-factor correction can
            # DIVERGE; keep the better iterate and stop when no longer
            # improving
            def err_norm(s):
                err = self._residual_hier(fac, *parts, s)
                nrm = torch.stack([e.abs().max() if e.numel()
                                   else e.new_zeros(()) for e in err]).max()
                return err, nrm

            def cond(c):
                _, _, k, nrm, prev = c
                return ((k < refinement_steps) & (nrm > 1e-12)
                        & (nrm < 0.5 * prev))

            def body(c):
                s, err, k, nrm, _ = c
                new = tuple(a + b for a, b in
                            zip(s, self._solve_core_hier(fac, *err)))
                err2, nrm2 = err_norm(new)
                worse = nrm2 > nrm
                return (select(worse, s, new), err2, k + 1,
                        torch.where(worse, nrm, nrm2), nrm)

            err0, nrm0 = err_norm(sol)
            k0 = torch.zeros((), dtype=torch.int32, device=nrm0.device)
            sol, _, k, nrm, _ = dev_while(
                cond, body, (sol, err0, k0, nrm0,
                             torch.full_like(nrm0, float("inf"))),
                refinement_steps)
            _record("refinement", dict(iterations=k, residual=nrm), nrm)
        return self._unpack(sol)

    # ------------------------------------------------------------------
    def solve_reduced_bicgstab(self, fac: HierFactors, rhs: ReducedRhs,
                               max_iters: int = 8, tol=1e-10):
        """Outer BiCGStab in the hierarchical state layout
        (x0, xb, d0_root, gm, wl_local), preconditioned by one structured
        solve.  Returns (dx, dy, dz, stats)."""
        p0, q0, rho_x, rho_m, rho_lnk = self._rhs_parts(rhs)
        b = (p0, rho_x, q0, rho_m, rho_lnk)

        def precond(v):
            x0, xb, d0, gm, wl = v
            # _solve_core_hier takes rhs in arg order (p0, q0, rx, rm, rl)
            return self._solve_core_hier(fac, x0, d0, xb, gm, wl)

        def applyK(v):
            zeros = tmap(torch.zeros_like, (v[0], v[2], v[1], v[3], v[4]))
            # err = 0 - K.v in arg order (ex0, eq0, ex, em, el)
            ex0, eq0, ex, em, el = self._residual_hier(fac, *zeros, v)
            return (-ex0, -ex, -eq0, -em, -el)

        def dot(a, c):
            ax0, axb, ad0, agm, awl = a
            cx0, cxb, cd0, cgm, cwl = c
            return ((_vdot(ax0, cx0) + _vdot(ad0, cd0) + _vdot(awl, cwl))
                    + (_vdot(axb, cxb) + _vdot(agm, cgm)))

        u, stats = preconditioned_bicgstab(b, precond, applyK, dot,
                                           max_iters, tol)
        return (*self._unpack(u), stats)

    # ------------------------------------------------------------------
    def _solve_core_hier(self, fac: HierFactors, p0, q0, rho_x, rho_m,
                         rho_lnk):
        """Three-level Lsolve/Dsolve/Ltsolve."""
        lp, m = self.lp, self.meta
        G, Ng = m.n_groups, m.group_size
        yl0 = lp.m0E + lp.m0I
        mE, n = lp.mE, lp.n

        # level 0: leaf solves
        gx, gm = self._leaf_solve(fac, rho_x, rho_m)
        gk = torch.cat([gx, gm], dim=1)                          # [N, k]

        # level 1: local-link solve per group: r_l - R_in' g_x (R_in' has
        # only x rows)
        F_l, G_l = self._local_strips()
        gxg = gx.reshape(G, Ng, n)
        rl = rho_lnk - torch.cat([
            torch.einsum("gimn,gin->gm", F_l, gxg),
            torch.einsum("gimn,gin->gm", G_l, gxg)], dim=1)      # [G, mL]
        wl = -_solve(fac.Lloc, rl)
        # back-substitute local links into blocks
        gk = gk - torch.einsum("ikS,iS->ik", fac.Win, self._per_block(wl))
        gx, gm = gk[:, :n], gk[:, n:]

        # accumulate the outer border products
        F0loc, G0loc = self._local_first()
        acc_x0 = (torch.einsum("imk,im->k", lp.A, gm[:, :mE])
                  + torch.einsum("imk,im->k", lp.C, gm[:, mE:]))
        acc_x0 = (acc_x0 + torch.einsum("gmk,gm->k", F0loc, wl[:, :m.mElL])
                  + torch.einsum("gmk,gm->k", G0loc, wl[:, m.mElL:]))
        acc_yl = torch.einsum("ilm,im->l", lp.F[:, G * m.mElL:, :], gx)
        acc_zl = torch.einsum("ilm,im->l", lp.G[:, G * m.mIlL:, :], gx)

        p = p0 - acc_x0
        q = torch.cat([q0[:yl0], q0[yl0:yl0 + m.mElG] - acc_yl,
                       q0[yl0 + m.mElG:] - acc_zl])

        # top
        a, d = self._root_solve(fac, p, q)

        # back-substitution: s0out = [a, ylG, zlG]
        s0 = torch.cat([a, d[yl0:]])
        gk = gk - torch.einsum("ikS,S->ik", fac.WoutB, s0)
        wl = wl - torch.einsum("gmS,S->gm", fac.WoutL, s0)
        return a, gk[:, :n], d, gk[:, n:], wl

    def _residual_hier(self, fac: HierFactors, p0, q0, rho_x, rho_m,
                       rho_lnk, sol):
        """rhs - K.sol for the full system in hierarchical layout."""
        lp, m = self.lp, self.meta
        m0E, yl0, mE = lp.m0E, lp.m0E + lp.m0I, lp.mE
        dx0, dxb, d0, gm, wl = sol
        dd = fac.delta_d

        ylh = self._join_link(wl[:, :m.mElL], d0[yl0:yl0 + m.mElG])
        zlh = self._join_link(wl[:, m.mElL:], d0[yl0 + m.mElG:])
        yh = RVec(d0[:m0E], gm[:, :mE], ylh)
        zh = RVec(d0[m0E:yl0], gm[:, mE:], zlh)
        x = XVec(dx0, dxb)

        ATyh = self.ATy(yh)
        CTzh = self.CTz(zh)
        Ax = self.Ax(x)
        Cx = self.Cx(x)

        E0 = 1.0 / fac.Einv0
        Eb = 1.0 / fac.Einv
        ex0 = p0 - (E0 * dx0 + ATyh.first + CTzh.first)
        ex = rho_x - (Eb * dxb + ATyh.blocks + CTzh.blocks)
        eq_b = Ax.blocks - dd * gm[:, :mE]
        iq_b = Cx.blocks - (fac.Om + dd) * gm[:, mE:]
        em = rho_m - torch.cat([eq_b, iq_b], dim=1)

        # link rows (permuted layout)
        eql = Ax.link - dd * ylh
        Oml_full = torch.cat([fac.OmlL.reshape(-1), fac.OmlG])
        iql = Cx.link - (Oml_full + dd) * zlh
        eql_loc, eql_glob = self._split_link(eql, "E")
        iql_loc, iql_glob = self._split_link(iql, "I")
        el_loc = rho_lnk - torch.cat([eql_loc, iql_loc], dim=1)

        eq0 = Ax.first - dd * d0[:m0E]
        iq0 = Cx.first - (fac.Om0 + dd) * d0[m0E:yl0]
        eq0_full = q0 - torch.cat([eq0, iq0, eql_glob, iql_glob])
        return ex0, eq0_full, ex, em, el_loc
