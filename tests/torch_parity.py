"""Helpers for the parity tests between the JAX package and its PyTorch
counterpart: data crosses between them as numpy arrays only.  JAX is
imported only by the helpers that build JAX values.

Importing it pins torch to one intra-op thread: the tests run in several
worker processes that share the machine's cores with each other and with
the JAX tests, and the port's tests work on small tensors."""
import dataclasses

import numpy as np
import torch

from pips_ipmpp_tpu_torch import bridge

torch.set_num_threads(1)


def jax_fields(obj) -> dict:
    """{field: numpy array} of a JAX dataclass pytree (an ArrowheadLP)."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def jax_sparse_fields(obj) -> dict:
    """jax_fields of a JAX SparseArrowheadLP: each ELL field as
    {"val", "col"} (the form `bridge.sparse_lp_from_numpy` takes)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = ({"val": np.asarray(v.val), "col": np.asarray(v.col)}
                       if hasattr(v, "col") else np.asarray(v))
    return out


def jax_space(vec) -> dict:
    """{first, blocks[, link]} numpy parts of a JAX XVec/RVec."""
    return {f.name: np.asarray(getattr(vec, f.name))
            for f in dataclasses.fields(vec)}


def jax_iterate(it) -> dict:
    """{name: {first, blocks[, link]}} of a JAX Iterate."""
    return {f.name: jax_space(getattr(it, f.name))
            for f in dataclasses.fields(it)}


def np_tree(x):
    """numpy leaves of a tree of XVec/RVec (either package) or tensors."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: np_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [np_tree(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_close(got, want, rtol, path="", atol=0.0):
    """Leafwise assert_allclose over matching np_tree structures."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            assert_tree_close(got[k], want[k], rtol, f"{path}.{k}", atol)
    elif isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, rtol, f"{path}[{i}]", atol)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=path)


def normwise_close(got, want, rtol):
    """max |got - want| <= rtol * max |want| (relative to the array's
    scale, so tiny entries are held to the same absolute bound)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.max(np.abs(want)) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * scale)


def jspace(parts):
    """JAX XVec (first, blocks) or RVec (+ link) from numpy parts."""
    import jax.numpy as jnp

    from pips_ipmpp_tpu.core.spaces import RVec as JRVec
    from pips_ipmpp_tpu.core.spaces import XVec as JXVec

    p = {k: jnp.asarray(v) for k, v in parts.items()}
    return JRVec(**p) if "link" in p else JXVec(**p)


def tspace(parts):
    return bridge.space_from_numpy(parts, device="cpu", dtype=torch.float64)


def random_iterate(rng, lp, positive):
    """numpy {name: parts} for the 12 iterate vectors: pairs strictly
    positive when `positive`, signed otherwise (a direction)."""
    xs = {"first": (lp.n0,), "blocks": (lp.N, lp.n)}
    eq = {"first": (lp.m0E,), "blocks": (lp.N, lp.mE), "link": (lp.mEl,)}
    iq = {"first": (lp.m0I,), "blocks": (lp.N, lp.mI), "link": (lp.mIl,)}
    spaces = dict(x=xs, s=iq, y=eq, z=iq, v=xs, w=xs, t=iq, u=iq,
                  gamma=xs, phi=xs, lam=iq, pi=iq)
    out = {}
    for name, shp in spaces.items():
        pair = name not in ("x", "s", "y", "z")
        out[name] = {
            k: (rng.uniform(0.2, 2.0, size=s) if pair and positive
                else rng.normal(size=s)) for k, s in shp.items()}
    return out
