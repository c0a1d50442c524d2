"""Vector spaces for the arrowhead structure + generic tree reductions.

Counterpart of `pips_ipmpp_tpu/core/spaces.py`:

  XVec: variable-space vector   (first: [n0], blocks: [N, n])
  RVec: row-space vector        (first: [m0], blocks: [N, m], link: [ml])

Over a bucketed LP (`core/bucketed.py`) `blocks` is a tuple of
per-bucket tensors; the reductions take its leaves in order, as the JAX
package's do.

Elementwise IPM ops go through `tmap` (the `jax.tree.map` of this
package: it walks dataclasses, tuples, lists and dicts and applies `fn` to
the tensor leaves); reductions go through the functions below.  All of
them run on one device, so there is no mesh axis.

Reductions keep the reference's summation split: the `first`/`link`
parts are reduced together and the batched `blocks` parts separately,
then the two are combined — the same order the JAX package uses, so f64
results agree to the last few bits.

A stack of B same-shape LPs (`core/lp.py::stack_lps`) puts a leading
batch axis in front of every part (first [B, n0], blocks [B, N, n]).  The
reductions see it in the space vectors' `first` part and reduce per LP,
over every axis but the batch axes, into a tensor of the batch shape; a
single LP's tree takes the branch it always took.  `bcast` lines a per-LP
scalar up against a batched tensor and `select` is `torch.where` with a
per-LP predicate over a tree.
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


def batch_ndim(tree) -> int:
    """The number of leading batch axes of a tree of space vectors: 0 for
    a single LP, 1 for a stack of LPs; 0 for a tree of plain tensors (a
    DenseLP's vectors)."""
    for x in _space_leaves(tree):
        if _is_space(x):
            return x.first.ndim - 1
    return 0


def bcast(s, like):
    """A per-LP scalar `s` (a tensor of the batch shape) with singleton
    axes appended, so that it broadcasts against `like` [*batch, ...]; a
    0-dim tensor or a Python number is returned as it is."""
    if not isinstance(s, torch.Tensor) or s.ndim == 0:
        return s
    return s.reshape(s.shape + (1,) * (like.ndim - s.ndim))


def select(pred, a, b):
    """`torch.where(pred, a, b)` leafwise over matching trees, with `pred`
    of the batch shape (or 0-dim).  Matching tensor leaves must have one
    shape (as a captured graph's carry buffers do, so that the eager run
    refuses what a capture would); non-tensor leaves must agree and are
    kept."""
    def sel(x, y):
        if not isinstance(x, torch.Tensor):
            if isinstance(y, torch.Tensor) or x != y:
                raise ValueError(f"a non-tensor leaf differs: {x!r}, {y!r}")
            return x
        if x.shape != y.shape:
            raise ValueError(f"leaves of shapes {tuple(x.shape)} and "
                             f"{tuple(y.shape)}")
        return torch.where(bcast(pred, x), x, y)
    return tmap(sel, a, b)


def reduce_all(fn, t: torch.Tensor, nb: int) -> torch.Tensor:
    """`fn(t)` over all of `t` (nb = 0), or per LP over every axis but the
    `nb` leading ones, with `fn(x, dim)` (`torch.amax`, `torch.all`, ...)."""
    if nb == 0:
        return fn(t)
    return fn(t.reshape(t.shape[:nb] + (-1,)), -1)


def _parts(l):
    """(replicated parts, the blocks part) of a space vector."""
    if isinstance(l, RVec):
        return (l.first, l.link), l.blocks
    return (l.first,), l.blocks


def _batched(tree, nb, empty, red, comb):
    """Per-LP reduction over a batched tree: `red(x)` reduces every axis
    of x [*batch, ...] but the batch axes (an empty part gives `empty`),
    `comb` combines two partial results; the replicated parts and the
    blocks are reduced apart and combined last, as in the single-LP
    branch."""
    first = next(x for x in _space_leaves(tree) if _is_space(x)).first
    init = torch.full(first.shape[:nb], empty, dtype=first.dtype,
                      device=first.device)

    def r(x):
        if x[(0,) * nb].numel() == 0:
            return init
        return red(x.reshape(x.shape[:nb] + (-1,)))

    rep, shard = init, init
    for l in _space_leaves(tree):
        if _is_space(l):
            reps, blocks = _parts(l)
            for x in reps:
                rep = comb(rep, r(x))
            shard = comb(shard, r(blocks))
        else:
            rep = comb(rep, r(l))
    return comb(rep, shard)


def _blk_leaves(blocks):
    """The tensors of a `blocks` part: the one batched tensor, or the
    per-bucket tensors of a bucketed LP."""
    return tuple(blocks) if isinstance(blocks, (tuple, list)) else (blocks,)


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
    """Sum of elementwise products over a tree of space vectors (per LP
    for a batched tree)."""
    nb = batch_ndim(a)
    if nb:
        prod = tmap(torch.mul, a, b)
        return _batched(prod, nb, 0.0, lambda x: x.sum(-1), torch.add)
    rep = _full_like_first(a, 0.0)
    shard = _full_like_first(a, 0.0)
    for la, lb in zip(_space_leaves(a), _space_leaves(b)):
        if _is_space(la):
            rep = rep + _vdot(la.first, lb.first)
            for ba, bb in zip(_blk_leaves(la.blocks), _blk_leaves(lb.blocks)):
                shard = shard + _vdot(ba, bb)
            if isinstance(la, RVec):
                rep = rep + _vdot(la.link, lb.link)
        else:
            rep = rep + _vdot(la, lb)
    return rep + shard


def total_sum(a) -> torch.Tensor:
    nb = batch_ndim(a)
    if nb:
        return _batched(a, nb, 0.0, lambda x: x.sum(-1), torch.add)
    rep = _full_like_first(a, 0.0)
    shard = _full_like_first(a, 0.0)
    for l in _space_leaves(a):
        if _is_space(l):
            rep = rep + torch.sum(l.first)
            for bl in _blk_leaves(l.blocks):
                shard = shard + torch.sum(bl)
            if isinstance(l, RVec):
                rep = rep + torch.sum(l.link)
        else:
            rep = rep + torch.sum(l)
    return rep + shard


def norm_inf(a) -> torch.Tensor:
    nb = batch_ndim(a)
    if nb:
        return _batched(a, nb, 0.0, lambda x: x.abs().amax(-1),
                        torch.maximum)
    rep = _full_like_first(a, 0.0)
    shard = _full_like_first(a, 0.0)

    def mx(x):
        return x.abs().max() if x.numel() else torch.zeros_like(rep)

    for l in _space_leaves(a):
        if _is_space(l):
            rep = torch.maximum(rep, mx(l.first))
            for bl in _blk_leaves(l.blocks):
                shard = torch.maximum(shard, mx(bl))
            if isinstance(l, RVec):
                rep = torch.maximum(rep, mx(l.link))
        else:
            rep = torch.maximum(rep, mx(l))
    return torch.maximum(rep, shard)


def min_reduce(a) -> torch.Tensor:
    """Global minimum over all entries (used by step bound computations);
    per LP for a batched tree."""
    nb = batch_ndim(a)
    if nb:
        return _batched(a, nb, float("inf"), lambda x: x.amin(-1),
                        torch.minimum)
    rep = _full_like_first(a, float("inf"))
    shard = _full_like_first(a, float("inf"))

    def mn(x):
        return x.min() if x.numel() else torch.full_like(rep, float("inf"))

    for l in _space_leaves(a):
        if _is_space(l):
            rep = torch.minimum(rep, mn(l.first))
            for bl in _blk_leaves(l.blocks):
                shard = torch.minimum(shard, mn(bl))
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
