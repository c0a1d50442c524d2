r"""Batched ELL sparse x dense products for the sparse leaf.

Counterpart of `pips_ipmpp_tpu/linalg/pallas_spmv.py::tiled_spmv` and of the
ELL products in `pips_ipmpp_tpu/core/sparse.py` (`ell_mv`, `ell_mv_multi`,
`ell_sq_diag`).  For val/col [N, m, K] (core/sparse.py `Ell`) and
X [N, n, c]:

    Y[b, r, :] = sum_k val[b, r, k] * X[b, col[b, r, k], :]     Y [N, m, c]

Transpose products use the stored transpose (`Bt`, `Dt`); the Jacobi
diagonal diag(M W M') is the product of the squared values with W.

`ell_spmm` dispatches on the tensors' device: CPU tensors go to the plain
torch version `ell_spmm_ref` (a gather and a sum), CUDA tensors to the
hand-written Hopper kernel `csrc/ell_spmm.cu`, which takes f32 or f64 and
reads val/col K-major (`ell_kmajor`, built once per operator; any other
layout is copied to it on every call).  There is no fallback from one to
the other.
"""
from __future__ import annotations

import torch

from pips_ipmpp_tpu_torch.core.sparse import Ell

_KERNEL_DTYPES = (torch.float32, torch.float64)


def ell_spmm_ref(val: torch.Tensor, col: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """Plain torch version: gather the X rows each entry names, then
    contract over K."""
    N, m, K = val.shape
    c = X.shape[2]
    idx = col.reshape(N, m * K, 1).long().expand(N, m * K, c)
    g = torch.gather(X, 1, idx).reshape(N, m, K, c)
    return torch.einsum("imk,imkc->imc", val, g)


def _check(val, col, X):
    if val.ndim != 3 or X.ndim != 3 or col.shape != val.shape \
            or X.shape[0] != val.shape[0]:
        raise ValueError(f"expected val/col [N, m, K] and X [N, n, c], got "
                         f"{tuple(val.shape)}, {tuple(col.shape)}, "
                         f"{tuple(X.shape)}")
    if col.dtype != torch.int32:
        raise TypeError(f"ELL column ids must be int32, got {col.dtype}")
    if X.dtype != val.dtype:
        raise TypeError(f"X is {X.dtype} but the ELL values are {val.dtype}")
    if not (val.device == col.device == X.device):
        raise ValueError("val, col and X must be on one device")


def _kmajor(t: torch.Tensor) -> torch.Tensor:
    """t [N, m, K] stored K-major: t itself when it already is, else a
    copy."""
    if t.transpose(1, 2).is_contiguous():
        return t
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _ell_spmm_cuda(val, col, X):
    from pips_ipmpp_tpu_torch import _build

    if val.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA ELL kernel takes float32 or float64, got "
                        f"{val.dtype}")
    if not X.is_contiguous():
        raise ValueError("the CUDA ELL kernel needs a contiguous X")
    val, col = _kmajor(val), _kmajor(col)
    N, m, K = val.shape
    n, c = X.shape[1], X.shape[2]
    Y = torch.empty((N, m, c), dtype=X.dtype, device=X.device)
    if N == 0 or m == 0 or c == 0:
        return Y
    if K == 0 or n == 0:
        return Y.zero_()
    lib = _build.load()
    fn = lib.ell_spmm_f32 if val.dtype == torch.float32 else lib.ell_spmm_f64
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(val.data_ptr(), col.data_ptr(), X.data_ptr(), Y.data_ptr(),
                N, m, K, n, c, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm launch failed: CUDA error {rc} at "
                           f"[{N}, {m}, {K}] x [{N}, {n}, {c}]")
    ell_spmm.launches += 1
    return Y


def ell_spmm(val: torch.Tensor, col: torch.Tensor,
             X: torch.Tensor) -> torch.Tensor:
    """Y [N, m, c] = M X for the ELL matrix (val, col) [N, m, K] and
    X [N, n, c].  Column ids must lie in [0, n) (`ell_kmajor` checks it
    once).  CPU tensors run the plain version; CUDA tensors launch the
    kernel and count the launch in `ell_spmm.launches`."""
    _check(val, col, X)
    if X.device.type == "cpu":
        return ell_spmm_ref(val, col, X)
    if X.device.type == "cuda":
        return _ell_spmm_cuda(val, col, X)
    raise ValueError(f"no ELL product for device {X.device}")


ell_spmm.launches = 0


def ell_mv(ell: Ell, x: torch.Tensor) -> torch.Tensor:
    """y[i, r] = sum_k val[i,r,k] * x[i, col[i,r,k]];  x: [N, n] -> [N, m]."""
    return ell_spmm(ell.val, ell.col, x.contiguous()[:, :, None])[:, :, 0]


def ell_mv_multi(ell: Ell, X: torch.Tensor) -> torch.Tensor:
    """Multi-RHS product;  X: [N, n, c] -> [N, m, c]."""
    return ell_spmm(ell.val, ell.col, X.contiguous())


def ell_sq_diag(ell: Ell, w: torch.Tensor) -> torch.Tensor:
    """diag of (M W M') per row: sum_k val^2 * w[col];  w: [N, n] -> [N, m].

    Exact only when column ids are unique within each row (the builders
    and the synthetic generator guarantee it).  A caller that needs it
    every iteration squares the values once and calls `ell_mv`."""
    return ell_mv(Ell(ell.val * ell.val, ell.col), w)


def ell_kmajor(ell: Ell, n: int) -> Ell:
    """The same ELL matrix stored K-major (slot k of all rows contiguous),
    the layout the CUDA kernel reads with neighbouring threads on
    neighbouring addresses.  Built once per matrix; also checks that the
    column ids lie in [0, n), which the products do not check."""
    col = ell.col
    if col.numel() and (int(col.min()) < 0 or int(col.max()) >= n):
        raise ValueError(f"ELL column id out of range [0, {n})")
    return Ell(_kmajor(ell.val), _kmajor(col))
