"""Data carried in from numpy: LPs and iterates given as plain arrays.

The JAX package's containers turn into numpy with
`{f.name: np.asarray(getattr(obj, f.name))}` on the caller's side (an ELL
field as `{"val": ..., "col": ...}`), so this package never touches JAX;
both packages then compute from the same data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.bucketed import BucketedArrowheadLP
from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP, stack_lps
from pips_ipmpp_tpu_torch.core.sparse import Ell, SparseArrowheadLP
from pips_ipmpp_tpu_torch.core.spaces import RVec, XVec
from pips_ipmpp_tpu_torch.ipm.formulation import Iterate
from pips_ipmpp_tpu_torch.linalg.band_backend import BandPlan
from pips_ipmpp_tpu_torch.linalg.band_root import BandRootPlan


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def lp_from_numpy(fields: dict[str, np.ndarray], *, device, dtype,
                  cls=ArrowheadLP):
    """An ArrowheadLP (or a `cls` LP, a DenseLP) from a dict holding one
    array per field."""
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"missing {cls.__name__} fields: "
                         f"{sorted(missing)}")
    return cls(**{k: _tensor(fields[k], device, dtype) for k in names})


def lps_from_numpy(batch: list[dict[str, np.ndarray]], *, device,
                   dtype) -> ArrowheadLP:
    """One stacked ArrowheadLP (`core/lp.py::stack_lps`, a leading batch
    axis) from a list of dicts, one per LP, as `lp_from_numpy` takes
    them: the batch of `IPMSolver.solve_fused_batch_async`."""
    return stack_lps([lp_from_numpy(f, device=device, dtype=dtype)
                      for f in batch])


def bucketed_lp_from_numpy(buckets: list[dict[str, np.ndarray]],
                           placement, *, device,
                           dtype) -> BucketedArrowheadLP:
    """A BucketedArrowheadLP from one field dict per bucket (as
    `lp_from_numpy` takes them) and the block -> (bucket, position)
    placement."""
    return BucketedArrowheadLP(
        tuple(lp_from_numpy(f, device=device, dtype=dtype) for f in buckets),
        tuple((int(b), int(p)) for b, p in placement))


def band_plan_from_numpy(fields: dict) -> BandPlan:
    """A BandPlan from {perm, iperm, half_bandwidth, panel, n_panels,
    n_dense}."""
    return _plan(BandPlan, fields)


def band_root_plan_from_numpy(fields: dict) -> BandRootPlan:
    """A BandRootPlan from the same keys as `band_plan_from_numpy`."""
    return _plan(BandRootPlan, fields)


def _plan(cls, fields):
    return cls(perm=np.asarray(fields["perm"], np.int32),
               iperm=np.asarray(fields["iperm"], np.int32),
               **{k: int(fields[k]) for k in ("half_bandwidth", "panel",
                                              "n_panels", "n_dense")})


def sparse_lp_from_numpy(fields: dict, *, device,
                         dtype) -> SparseArrowheadLP:
    """SparseArrowheadLP from a dict holding one array per dense field and
    `{"val": ..., "col": ...}` per ELL field (B, Bt, D, Dt)."""
    names = [f.name for f in dataclasses.fields(SparseArrowheadLP)]
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"missing SparseArrowheadLP fields: "
                         f"{sorted(missing)}")
    kw = {}
    for k in names:
        v = fields[k]
        if isinstance(v, dict):
            kw[k] = Ell(_tensor(v["val"], device, dtype),
                        _tensor(v["col"], device, torch.int32))
        else:
            kw[k] = _tensor(v, device, dtype)
    return SparseArrowheadLP(**kw)


def space_from_numpy(parts: dict[str, np.ndarray], *, device, dtype):
    """XVec from {first, blocks}; RVec from {first, blocks, link}."""
    t = {k: _tensor(v, device, dtype) for k, v in parts.items()}
    if "link" in t:
        return RVec(t["first"], t["blocks"], t["link"])
    return XVec(t["first"], t["blocks"])


def iterate_from_numpy(fields: dict[str, dict[str, np.ndarray]], *, device,
                       dtype) -> Iterate:
    """Iterate from {name: {first, blocks[, link]}} for its 12 vectors."""
    return Iterate(**{f.name: space_from_numpy(fields[f.name], device=device,
                                               dtype=dtype)
                      for f in dataclasses.fields(Iterate)})
