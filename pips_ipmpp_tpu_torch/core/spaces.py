"""Vector spaces for the arrowhead structure + generic tree reductions.

Counterpart of `pips_ipmpp_tpu/core/spaces.py`:

  XVec: variable-space vector   (first: [n0], blocks: [N, n])
  RVec: row-space vector        (first: [m0], blocks: [N, m], link: [ml])

Elementwise IPM ops go through `tmap` (the `jax.tree.map` of this
package: it walks dataclasses, tuples, lists and dicts and applies `fn` to
the tensor leaves); reductions go through the functions below.  All of
them run on one device, so there is no mesh axis.

Reductions keep the reference's summation split: the `first`/`link`
parts are reduced together and the batched `blocks` parts separately,
then the two are combined — the same order the JAX package uses, so f64
results agree to the last few bits.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class XVec:
    """Variable-space vector: first-stage part + batched block parts."""
    first: torch.Tensor    # [n0]
    blocks: torch.Tensor   # [N, n]


@dataclass
class RVec:
    """Row-space vector: block-0 rows + batched block rows + linking rows."""
    first: torch.Tensor    # [m0]
    blocks: torch.Tensor   # [N, m]
    link: torch.Tensor     # [ml]


def tmap(fn, *trees):
    """Apply `fn` leafwise over matching trees of dataclasses, tuples,
    lists and dicts (leaves are tensors or Python scalars)."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return type(t0)(**{
            f.name: tmap(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if isinstance(t0, (tuple, list)):
        return type(t0)(tmap(fn, *xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: tmap(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def leaves(tree, is_leaf=None) -> list:
    """Flatten a tree in `tmap` order; `is_leaf(node)` stops the descent."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in leaves(getattr(tree, f.name), is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t, is_leaf)]
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], is_leaf)]
    return [tree]


def _is_space(x) -> bool:
    return isinstance(x, (XVec, RVec))


def _space_leaves(tree):
    return leaves(tree, is_leaf=_is_space)


def _vdot(a, b):
    if a.numel() == 0:
        # cuBLAS writes an empty dot's 0 from host memory, a copy that a
        # captured CUDA graph cannot replay
        return a.new_zeros(())
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _full_like_first(tree, value):
    t = leaves(tree)[0]
    return torch.full((), value, dtype=t.dtype, device=t.device)


def dot(a, b) -> torch.Tensor:
    """Sum of elementwise products over a tree of space vectors."""
    rep = _full_like_first(a, 0.0)
    shard = _full_like_first(a, 0.0)
    for la, lb in zip(_space_leaves(a), _space_leaves(b)):
        if _is_space(la):
            rep = rep + _vdot(la.first, lb.first)
            shard = shard + _vdot(la.blocks, lb.blocks)
            if isinstance(la, RVec):
                rep = rep + _vdot(la.link, lb.link)
        else:
            rep = rep + _vdot(la, lb)
    return rep + shard


def total_sum(a) -> torch.Tensor:
    rep = _full_like_first(a, 0.0)
    shard = _full_like_first(a, 0.0)
    for l in _space_leaves(a):
        if _is_space(l):
            rep = rep + torch.sum(l.first)
            shard = shard + torch.sum(l.blocks)
            if isinstance(l, RVec):
                rep = rep + torch.sum(l.link)
        else:
            rep = rep + torch.sum(l)
    return rep + shard


def norm_inf(a) -> torch.Tensor:
    rep = _full_like_first(a, 0.0)
    shard = _full_like_first(a, 0.0)

    def mx(x):
        return x.abs().max() if x.numel() else torch.zeros_like(rep)

    for l in _space_leaves(a):
        if _is_space(l):
            rep = torch.maximum(rep, mx(l.first))
            shard = torch.maximum(shard, mx(l.blocks))
            if isinstance(l, RVec):
                rep = torch.maximum(rep, mx(l.link))
        else:
            rep = torch.maximum(rep, mx(l))
    return torch.maximum(rep, shard)


def min_reduce(a) -> torch.Tensor:
    """Global minimum over all entries (used by step bound computations)."""
    rep = _full_like_first(a, float("inf"))
    shard = _full_like_first(a, float("inf"))

    def mn(x):
        return x.min() if x.numel() else torch.full_like(rep, float("inf"))

    for l in _space_leaves(a):
        if _is_space(l):
            rep = torch.minimum(rep, mn(l.first))
            shard = torch.minimum(shard, mn(l.blocks))
            if isinstance(l, RVec):
                rep = torch.minimum(rep, mn(l.link))
        else:
            rep = torch.minimum(rep, mn(l))
    return torch.minimum(rep, shard)


# Elementwise helpers --------------------------------------------------

def axpy(alpha, x, y):
    """y + alpha * x elementwise."""
    return tmap(lambda xe, ye: ye + alpha * xe, x, y)


def scale(alpha, x):
    return tmap(lambda e: alpha * e, x)


def zeros_like(x):
    return tmap(torch.zeros_like, x)
