r"""Batched ELL sparse x dense products for the sparse leaf.

Counterpart of `pips_ipmpp_tpu/linalg/pallas_spmv.py::tiled_spmv` and of the
ELL products in `pips_ipmpp_tpu/core/sparse.py` (`ell_mv`, `ell_mv_multi`,
`ell_sq_diag`).  For val/col [N, m, K] (core/sparse.py `Ell`) and
X [N, n, c]:

    Y[b, r, :] = sum_k val[b, r, k] * X[b, col[b, r, k], :]     Y [N, m, c]

with an optional diagonal epilogue, rounded as the separate torch
operations round it (a multiply, then an add):

    Y = alpha[..., None] * (M X) + beta[..., None] * Z

alpha and beta [N, m], Z [N, m, c]; an absent alpha is 1, an absent beta
with Z present is 1, an absent Z adds nothing.  Transpose products use the
stored transpose (`Bt`, `Dt`); the Jacobi diagonal diag(M W M') is the
product of the squared values with W.

The card reads a sliced ELL layout (SELL-C-sigma; Kreutzer, Hager, Wellein,
Fehske and Bishop, SIAM J. Sci. Comput. 36(5), 2014), built once per
operator by `sell_from_ell`: within each block, rows are sorted by nonzero
count inside windows of sigma = 256 rows and grouped into slices of C = 32
rows, and each slice stores only its own longest row's slots, K-major.  A
transposed operator whose rows hold 10 nonzeros on average but up to 33
slots then stores ~1.1 slots per nonzero instead of 3.3.  The `SellEll`
keeps the padded `Ell` beside the slices for the plain version.

`ell_spmm` dispatches on the tensors' device: CPU tensors go to the plain
torch version `ell_spmm_ref` on the padded ELL (a gather and a sum), CUDA
tensors to the hand-written Hopper kernel `csrc/ell_spmm.cu` on the slices.
There is no fallback from one to the other.  `sell_spmm_ref` is the plain
version over the sliced arrays, which tests the layout on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pips_ipmpp_tpu_torch.core.sparse import Ell

_KERNEL_DTYPES = (torch.float32, torch.float64)
SLICE_ROWS = 32         # C: the rows of one slice, one warp's worth at c = 1
SORT_WINDOW = 256       # sigma: rows sorted by nonzero count inside windows


@dataclass
class SellEll:
    """One ELL operator in the sliced layout, with its padded original.

    Slice g = b * S + s holds the rows of block b at sorted positions
    [s C, s C + C); its slot (k, i) is element slice_ptr[g] + k C + i of
    `val`/`col`, for k < slice_k[g].  row[g C + i] is that position's row
    in the block, -1 past the block's last row."""
    ell: Ell                  # [N, m, K] padded: the plain version's operator
    val: torch.Tensor         # [slots] values, slice after slice, K-major
    col: torch.Tensor         # [slots] int32 column ids
    slice_ptr: torch.Tensor   # [N S + 1] int64 first slot of each slice
    slice_k: torch.Tensor     # [N S] int32 slots per row of each slice
    row: torch.Tensor         # [N S C] int32 row of each sliced position
    n: int                    # columns: X is [N, n, c]
    nnz: int                  # nonzero values of `ell`
    name: str = ""            # the key of `ell_spmm.launches_by`

    @property
    def N(self) -> int:
        return self.ell.N

    @property
    def m(self) -> int:
        return self.ell.m

    @property
    def S(self) -> int:
        return self.slice_k.numel() // max(self.N, 1)

    @property
    def slots(self) -> int:
        return self.val.numel()


def sell_from_ell(ell: Ell, n: int, name: str = "") -> SellEll:
    """The sliced layout of `ell`, built once per operator on its device.

    Each row keeps its nonzero slots (val != 0) in stored order, packed to
    the front; rows are stably sorted by descending count inside windows
    of SORT_WINDOW rows, so rows of equal count keep the identity
    permutation.  Also checks that the column ids lie in [0, n), which the
    products do not check."""
    C, win = SLICE_ROWS, SORT_WINDOW
    val, col = ell.val, ell.col
    if col.numel() and (int(col.min()) < 0 or int(col.max()) >= n):
        raise ValueError(f"ELL column id out of range [0, {n})")
    N, m, K = val.shape
    dev = val.device
    S = -(-m // C)
    # 1. pack each row's nonzeros to the front, in stored order
    keep = val != 0
    order = torch.sort((~keep).to(torch.int8), dim=2, stable=True).indices
    keep = torch.gather(keep, 2, order)
    pval = torch.where(keep, torch.gather(val, 2, order), 0)
    pcol = torch.where(keep, torch.gather(col, 2, order), 0)
    cnt = keep.sum(2)                                         # [N, m]
    # 2. sort rows by descending count inside windows of `win` rows; rows
    #    past m (key 1) stay past m, since they fill the last window's end
    P = -(-m // win) * win
    key = torch.ones((N, P), dtype=torch.int64, device=dev)
    key[:, :m] = -cnt
    perm = torch.sort(key.view(N, P // win, win), dim=2, stable=True).indices
    perm = (perm + torch.arange(0, P, win, device=dev)[:, None]).view(N, P)
    perm = perm[:, :S * C]                                    # [N, S C]
    real = perm < m
    src = torch.where(real, perm, 0)
    idx = src[:, :, None].expand(N, S * C, K)
    sval = torch.where(real[:, :, None], torch.gather(pval, 1, idx), 0)
    scol = torch.where(real[:, :, None], torch.gather(pcol, 1, idx), 0)
    scnt = torch.where(real, torch.gather(cnt, 1, src), 0)
    # 3. each slice keeps its own longest row's slots, K-major
    slice_k = scnt.view(N, S, C).amax(2)                      # [N, S]
    take = (torch.arange(K, device=dev)[None, None, :, None]
            < slice_k[:, :, None, None]).expand(N, S, K, C)
    kmaj = lambda t: t.view(N, S, C, K).transpose(2, 3)      # noqa: E731
    slice_k = slice_k.reshape(-1)
    ptr = torch.zeros(N * S + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(slice_k * C, 0)
    row = torch.where(real, perm, -1)
    return SellEll(ell=ell, val=kmaj(sval)[take].contiguous(),
                   col=kmaj(scol)[take].to(torch.int32).contiguous(),
                   slice_ptr=ptr, slice_k=slice_k.to(torch.int32),
                   row=row.reshape(-1).to(torch.int32), n=n,
                   nnz=int(cnt.sum()), name=name)


def _epilogue(Y, alpha, beta, Z):
    """alpha[..., None] * Y + beta[..., None] * Z as separate torch
    operations, each term left out where its operand is absent."""
    if alpha is not None:
        Y = alpha[..., None] * Y
    if Z is not None:
        Y = Y + (Z if beta is None else beta[..., None] * Z)
    return Y


def ell_spmm_ref(val: torch.Tensor, col: torch.Tensor, X: torch.Tensor,
                 alpha=None, beta=None, Z=None) -> torch.Tensor:
    """Plain torch version on the padded ELL: gather the X rows each entry
    names, contract over K, then the epilogue."""
    N, m, K = val.shape
    c = X.shape[2]
    idx = col.reshape(N, m * K, 1).long().expand(N, m * K, c)
    g = torch.gather(X, 1, idx).reshape(N, m, K, c)
    return _epilogue(torch.einsum("imk,imkc->imc", val, g), alpha, beta, Z)


def sell_spmm_ref(op: SellEll, X: torch.Tensor, alpha=None, beta=None,
                  Z=None) -> torch.Tensor:
    """Plain torch version over the sliced arrays, in the kernel's order:
    per sliced row, slots k = 0..K_s-1 in turn, then the epilogue at the
    row's original index.  Tests `sell_from_ell` where the kernel cannot
    run."""
    C, N, S, m = SLICE_ROWS, op.N, op.S, op.m
    c = X.shape[2]
    G = N * S
    dev = X.device
    ks = op.slice_k.long()
    Kmax = int(ks.max()) if G else 0
    g = torch.repeat_interleave(torch.arange(G, device=dev), ks * C)
    local = torch.arange(op.slots, device=dev) - op.slice_ptr[g]
    V = torch.zeros((G, Kmax, C), dtype=X.dtype, device=dev)
    I = torch.zeros((G, Kmax, C), dtype=torch.int64, device=dev)
    V[g, local // C, local % C] = op.val
    I[g, local // C, local % C] = op.col.long()
    b = torch.arange(G, device=dev) // S
    acc = torch.zeros((G, C, c), dtype=X.dtype, device=dev)
    for k in range(Kmax):
        acc = acc + V[:, k, :, None] * X[b[:, None], I[:, k]]
    rows = op.row.view(G, C).long()
    real = rows >= 0
    Y = torch.zeros((N, m, c), dtype=X.dtype, device=dev)
    Y[b[:, None].expand(G, C)[real], rows[real]] = acc[real]
    return _epilogue(Y, alpha, beta, Z)


def _check(op, X, alpha, beta, Z):
    ell = op.ell if isinstance(op, SellEll) else op
    val, col = ell.val, ell.col
    if val.ndim != 3 or X.ndim != 3 or col.shape != val.shape \
            or X.shape[0] != val.shape[0]:
        raise ValueError(f"expected val/col [N, m, K] and X [N, n, c], got "
                         f"{tuple(val.shape)}, {tuple(col.shape)}, "
                         f"{tuple(X.shape)}")
    if isinstance(op, SellEll) and X.shape[1] != op.n:
        raise ValueError(f"X has {X.shape[1]} rows, the operator {op.n} "
                         f"columns")
    if col.dtype != torch.int32:
        raise TypeError(f"ELL column ids must be int32, got {col.dtype}")
    if X.dtype != val.dtype:
        raise TypeError(f"X is {X.dtype} but the ELL values are {val.dtype}")
    N, m = val.shape[:2]
    for name, t, shape in (("alpha", alpha, (N, m)), ("beta", beta, (N, m)),
                           ("Z", Z, (N, m, X.shape[2]))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape}")
        if t.dtype != X.dtype or t.device != X.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, X "
                            f"{X.dtype} on {X.device}")
    if beta is not None and Z is None:
        raise ValueError("beta without Z")
    if not (val.device == col.device == X.device):
        raise ValueError("val, col and X must be on one device")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _ell_spmm_cuda(op, X, alpha, beta, Z):
    from pips_ipmpp_tpu_torch import _build

    if not isinstance(op, SellEll):
        raise TypeError("the CUDA ELL kernel reads the sliced layout: build "
                        "it once with sell_from_ell")
    if X.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA ELL kernel takes float32 or float64, got "
                        f"{X.dtype}")
    for name, t in (("X", X), ("alpha", alpha), ("beta", beta), ("Z", Z)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"the CUDA ELL kernel needs a contiguous {name}")
    N, m, n, c = op.N, op.m, op.n, X.shape[2]
    Y = torch.empty((N, m, c), dtype=X.dtype, device=X.device)
    if N == 0 or m == 0 or c == 0:
        return Y
    lib = _build.load()
    fn = lib.ell_spmm_f32 if X.dtype == torch.float32 else lib.ell_spmm_f64
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(op.val.data_ptr(), op.col.data_ptr(), op.slice_ptr.data_ptr(),
                op.slice_k.data_ptr(), op.row.data_ptr(), X.data_ptr(),
                Y.data_ptr(), _ptr(alpha), _ptr(beta), _ptr(Z), N, op.S, m,
                n, c, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm launch failed: CUDA error {rc} at "
                           f"{op.slots} slots [{N}, {m}] x [{N}, {n}, {c}]")
    ell_spmm.launches += 1
    ell_spmm.captured += torch.cuda.is_current_stream_capturing()
    key = (op.name, c)
    ell_spmm.launches_by[key] = ell_spmm.launches_by.get(key, 0) + 1
    return Y


def ell_spmm(op, X: torch.Tensor, alpha=None, beta=None,
             Z=None) -> torch.Tensor:
    """Y [N, m, c] = alpha * (M X) + beta * Z for the operator `op` (a
    `SellEll`, or on the CPU also a padded `Ell`) and X [N, n, c].  Column
    ids must lie in [0, n) (`sell_from_ell` checks it once).  CPU tensors
    run the plain version on the padded ELL; CUDA tensors launch the kernel
    on the slices, on the current stream, and count the launch in
    `ell_spmm.launches` and `ell_spmm.launches_by[(op.name, c)]` (one into
    a graph being captured also in `ell_spmm.captured`)."""
    _check(op, X, alpha, beta, Z)
    if X.device.type == "cpu":
        ell = op.ell if isinstance(op, SellEll) else op
        return ell_spmm_ref(ell.val, ell.col, X, alpha, beta, Z)
    if X.device.type == "cuda":
        return _ell_spmm_cuda(op, X, alpha, beta, Z)
    raise ValueError(f"no ELL product for device {X.device}")


ell_spmm.launches = 0
ell_spmm.captured = 0   # of those, into a captured CUDA graph
ell_spmm.launches_by = {}


def _col(v):
    return None if v is None else v.contiguous()[:, :, None]


def ell_mv(op, x: torch.Tensor, alpha=None, beta=None,
           z=None) -> torch.Tensor:
    """y[i, r] = alpha * sum_k val[i,r,k] * x[i, col[i,r,k]] + beta * z;
    x: [N, n] -> [N, m]."""
    return ell_spmm(op, x.contiguous()[:, :, None], alpha, beta,
                    _col(z))[:, :, 0]


def ell_mv_multi(op, X: torch.Tensor, alpha=None, beta=None,
                 Z=None) -> torch.Tensor:
    """Multi-RHS product;  X: [N, n, c] -> [N, m, c]."""
    return ell_spmm(op, X.contiguous(), alpha, beta,
                    None if Z is None else Z.contiguous())


def ell_sq_diag(ell: Ell, w: torch.Tensor) -> torch.Tensor:
    """diag of (M W M') per row: sum_k val^2 * w[col];  w: [N, n] -> [N, m].

    Exact only when column ids are unique within each row (the builders
    and the synthetic generator guarantee it).  A caller that needs it
    every iteration squares the values once and calls `ell_mv`."""
    return ell_mv(Ell(ell.val * ell.val, ell.col), w)
