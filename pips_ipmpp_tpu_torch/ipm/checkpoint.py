"""Iterate checkpoint/resume.

Counterpart of `pips_ipmpp_tpu/ipm/checkpoint.py`, in its file format: one
.npz of the iterate's leaves (`leaf_0`, `leaf_1`, ... in the order of
`_flatten_iterate`) and a JSON `meta` entry (version, the spaces' kinds,
the iteration, delta_p, delta_d, extra), so a checkpoint written by either
package loads in the other.  The leaves keep their dtype.  A save copies
the iterate to the host once per dtype (once for the solver's f64
iterate), the shifts included; a load puts the leaves on the caller's
device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.spaces import RVec, XVec
from pips_ipmpp_tpu_torch.ipm.formulation import Iterate

_CKPT_VERSION = 1


def _flatten_iterate(it: Iterate):
    leaves = []
    spec = []
    for name in ("x", "s", "y", "z", "v", "w", "t", "u",
                 "gamma", "phi", "lam", "pi"):
        val = getattr(it, name)
        if isinstance(val, XVec):
            spec.append((name, "XVec"))
            leaves += [val.first, val.blocks]
        elif isinstance(val, RVec):
            spec.append((name, "RVec"))
            leaves += [val.first, val.blocks, val.link]
        else:
            spec.append((name, "array"))
            leaves.append(val)
    return leaves, spec


def _to_host(tensors: list) -> list:
    """numpy copies of `tensors`, one device->host copy per dtype."""
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        flat = flat.cpu().numpy()
        off = 0
        for i in idx:
            size = tensors[i].numel()
            out[i] = flat[off:off + size].reshape(tuple(tensors[i].shape))
            off += size
    return out


def save_checkpoint(path: str, it: Iterate, iteration: int,
                    delta_p, delta_d, extra: dict | None = None) -> None:
    """Write `it` and the IPM's position (`iteration`, the regularization
    shifts, Python numbers or 0-dim tensors) to `path`, atomically."""
    leaves, spec = _flatten_iterate(it)
    # the shifts ride along in the f64 leaves' copy
    shifts = [torch.as_tensor(d, dtype=torch.float64,
                              device=leaves[0].device).reshape(1)
              for d in (delta_p, delta_d)]
    host = _to_host(leaves + shifts)
    arrays = {f"leaf_{i}": a for i, a in enumerate(host[:len(leaves)])}
    delta_p, delta_d = (float(h[0]) for h in host[len(leaves):])
    meta = dict(version=_CKPT_VERSION, spec=spec, iteration=iteration,
                delta_p=delta_p, delta_d=delta_d, extra=extra or {})
    tmp = path + ".tmp.npz"
    np.savez(tmp, meta=json.dumps(meta), **arrays)
    os.replace(tmp, path)   # atomic swap


def load_checkpoint(path: str, dtype=None, device="cpu"):
    """Returns (iterate, iteration, delta_p, delta_d, extra), the iterate's
    leaves on `device` in their stored dtype or in `dtype`."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta["version"] > _CKPT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    n_leaves = len([k for k in data.files if k.startswith("leaf_")])
    leaves = [torch.from_numpy(data[f"leaf_{i}"]).to(device=device,
                                                     dtype=dtype)
              for i in range(n_leaves)]
    fields = {}
    pos = 0
    for name, kind in meta["spec"]:
        if kind == "XVec":
            fields[name] = XVec(leaves[pos], leaves[pos + 1])
            pos += 2
        elif kind == "RVec":
            fields[name] = RVec(leaves[pos], leaves[pos + 1], leaves[pos + 2])
            pos += 3
        else:
            fields[name] = leaves[pos]
            pos += 1
    it = Iterate(**fields)
    return it, meta["iteration"], meta["delta_p"], meta["delta_d"], \
        meta["extra"]
