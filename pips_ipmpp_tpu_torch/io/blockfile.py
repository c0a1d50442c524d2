"""Block-file I/O: one .npz per block + a meta file.

Counterpart of `pips_ipmpp_tpu/io/blockfile.py`, with the same format
version and keys, so either package reads what the other writes:

    <stem>_meta.npz     : N, linking dims, linking eq rhs + ineq bounds
    <stem>_block0.npz   : first-stage arrays (c, A, b, C, bounds, F0, G0)
    <stem>_block<i>.npz : block arrays (c, A, B, b, C, D, bounds, F, G)

(the reference reads GDX block files, Drivers/gams/gmspips/gmspipsio.h:
5-83).  Matrices are stored dense.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP, make_arrowhead_lp

FORMAT_VERSION = 1

_FIRST_KEYS = ("c", "A", "b", "C", "iclow", "clow", "icupp", "cupp",
               "ixlow", "xlow", "ixupp", "xupp", "F0", "G0")
_BLOCK_KEYS = ("c", "A", "B", "b", "C", "D", "iclow", "clow", "icupp",
               "cupp", "ixlow", "xlow", "ixupp", "xupp", "F", "G")
# ArrowheadLP fields of the first stage and of the blocks, by file key
_FIRST_FIELDS = dict(c="c0", A="A0", b="b0", C="C0", iclow="iclow0",
                     clow="clow0", icupp="icupp0", cupp="cupp0",
                     ixlow="ixlow0", xlow="xlow0", ixupp="ixupp0",
                     xupp="xupp0", F0="F0", G0="G0")
_BLOCK_FIELDS = dict(c="cN", A="A", B="B", b="bN", C="C", D="D",
                     iclow="iclowN", clow="clowN", icupp="icuppN",
                     cupp="cuppN", ixlow="ixlowN", xlow="xlowN",
                     ixupp="ixuppN", xupp="xuppN", F="F", G="G")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def write_blocks(lp: ArrowheadLP, stem: str) -> None:
    """Write an ArrowheadLP as block files (the inverse of read_blocks)."""
    np.savez(f"{stem}_meta.npz", version=FORMAT_VERSION, N=lp.N,
             bl=_np(lp.bl), iclowl=_np(lp.iclowl), clowl=_np(lp.clowl),
             icuppl=_np(lp.icuppl), cuppl=_np(lp.cuppl))
    np.savez(f"{stem}_block0.npz", **{
        k: _np(getattr(lp, f)) for k, f in _FIRST_FIELDS.items()})
    for i in range(lp.N):
        np.savez(f"{stem}_block{i + 1}.npz", **{
            k: _np(getattr(lp, f)[i]) for k, f in _BLOCK_FIELDS.items()})


def read_blocks(stem: str, n_blocks: Optional[int] = None,
                dtype=torch.float64, device="cpu") -> ArrowheadLP:
    """Read block files into an ArrowheadLP (heterogeneous blocks are
    padded). `n_blocks` = N+1 in gmspips convention (counting block 0) or
    None to use the meta file."""
    meta = np.load(f"{stem}_meta.npz")
    if int(meta.get("version", 1)) > FORMAT_VERSION:
        raise ValueError(f"unsupported block-file version "
                         f"{int(meta['version'])}")
    N = int(meta["N"]) if n_blocks is None else n_blocks - 1
    b0file = np.load(f"{stem}_block0.npz")
    first = {k: b0file[k] for k in _FIRST_KEYS}
    blocks = []
    for i in range(N):
        path = f"{stem}_block{i + 1}.npz"
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        bf = np.load(path)
        blocks.append({k: bf[k] for k in _BLOCK_KEYS})
    return make_arrowhead_lp(
        blocks, first,
        linking_eq={"b": meta["bl"]},
        linking_ineq={"iclow": meta["iclowl"], "clow": meta["clowl"],
                      "icupp": meta["icuppl"], "cupp": meta["cuppl"]},
        dtype=dtype, device=device)


def write_solution(stem: str, x: np.ndarray, y: np.ndarray = None,
                   z: np.ndarray = None, objective: float = None) -> None:
    """Write solution (the role of gmspipsio writeSolution, gmspipsio.h:71)."""
    kw = {"x": x}
    if y is not None:
        kw["y"] = y
    if z is not None:
        kw["z"] = z
    if objective is not None:
        kw["objective"] = objective
    np.savez(f"{stem}_solution.npz", **kw)
