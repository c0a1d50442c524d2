"""Bucketed arrowhead LP: heterogeneous block sizes without global padding.

Counterpart of `pips_ipmpp_tpu/core/bucketed.py`.  The batched layout of
`core/lp.py` pads every block to the global maximum shape, O(N max^2)
waste when block sizes vary widely (the reference keeps each block at its
own size, DistributedMatrix.h:44-48).  Blocks are grouped into a few SIZE
BUCKETS instead, each padded only to its own maximum and batched apart;
all buckets share one first stage and one set of linking rows, and their
Schur contributions are summed before a single root factorization
(`linalg/bucket_backend.py`).

Space vectors over a bucketed LP carry `blocks` as a TUPLE of per-bucket
tensors; `core/spaces.py`'s reductions and `tmap` walk them in the JAX
package's leaf order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp


@dataclasses.dataclass
class BucketedArrowheadLP:
    """A tuple of per-bucket ArrowheadLPs sharing identical first-stage and
    linking data, plus the block -> (bucket, position) placement map."""
    buckets: tuple          # tuple[ArrowheadLP, ...]
    placement: tuple        # tuple[(bucket, pos), ...] per original block

    @property
    def n0(self) -> int:
        return self.buckets[0].n0

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def N(self) -> int:
        return len(self.placement)

    @property
    def batch_shape(self) -> tuple:
        return ()

    @property
    def device(self) -> torch.device:
        return self.buckets[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.buckets[0].dtype

    def total_vars(self) -> int:
        return self.n0 + sum(b.N * b.n for b in self.buckets)

    def astype(self, dtype) -> "BucketedArrowheadLP":
        return BucketedArrowheadLP(
            tuple(b.astype(dtype) for b in self.buckets), self.placement)

    def to(self, device) -> "BucketedArrowheadLP":
        return BucketedArrowheadLP(
            tuple(b.to(device) for b in self.buckets), self.placement)


def bucket_blocks(shapes: list, quantum: int = 64) -> list:
    """Group block shapes (n, mE, mI) into buckets: shapes are quantized
    up to multiples of `quantum` and grouped by the quantized triple, so
    padding waste is bounded by the quantum while the number of distinct
    batch shapes stays small.  Returns the bucket key per block."""
    keys = []
    for (n, mE, mI) in shapes:
        def q(v):
            return max(((int(v) + quantum - 1) // quantum) * quantum, 1)
        keys.append((q(n), q(mE), q(mI)))
    return keys


def make_bucketed_arrowhead_lp(blocks: list, first_stage: dict,
                               linking_eq: Optional[dict] = None,
                               linking_ineq: Optional[dict] = None,
                               dtype=torch.float64, quantum: int = 64,
                               device="cpu") -> BucketedArrowheadLP:
    """Build a BucketedArrowheadLP from the same per-block dicts as
    `make_arrowhead_lp` (core/lp.py), grouping blocks into size buckets
    (ordered by their quantized shape) instead of padding everything to
    the global max.  Padding inside each bucket is `make_arrowhead_lp`'s;
    larger `quantum` => fewer buckets, more padding."""
    shapes = [(len(b["c"]), np.asarray(b["b"]).shape[0],
               np.asarray(b["clow"]).shape[0]) for b in blocks]
    keys = bucket_blocks(shapes, quantum)
    order = sorted(set(keys))
    bucket_of = {k: i for i, k in enumerate(order)}

    members: list[list[int]] = [[] for _ in order]
    for i, k in enumerate(keys):
        members[bucket_of[k]].append(i)

    placement = [None] * len(blocks)
    subs = []
    for bi, idxs in enumerate(members):
        for pos, i in enumerate(idxs):
            placement[i] = (bi, pos)
        subs.append(make_arrowhead_lp([blocks[i] for i in idxs],
                                      first_stage, linking_eq, linking_ineq,
                                      dtype=dtype, device=device))
    return BucketedArrowheadLP(tuple(subs), tuple(placement))
