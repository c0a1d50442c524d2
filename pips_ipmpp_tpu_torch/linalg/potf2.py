r"""Batched f64 Cholesky in LAPACK's unblocked order (dpotf2).

The two-level root of `ArrowBackend` factors S11 and the dual Schur
complement with Cholesky.  The JAX package's `jnp.linalg.cholesky` is
LAPACK on its CPU; on the card `torch.linalg.cholesky_ex` is cuSOLVER,
whose other order of sums accepts root blocks singular to working
precision that LAPACK refuses (ROADMAP.md §3, F3).  On the card the root
therefore goes through this module's kernel, `csrc/potf2.cu`, in LAPACK's
unblocked order (blocked over 32-column panels and many CTAs, each
element's sums still in that order); on the CPU it stays with
`torch.linalg`, which is LAPACK itself.

`cholesky_potf2(S)` factors (S + S')/2, as `jnp.linalg.cholesky` does by
default, and returns (L, ok): L lower triangular, ok per matrix (every
pivot positive and finite, every factor finite).  A CPU tensor runs the
plain version `cholesky_potf2_ref`, a CUDA tensor the kernel; nothing falls
back from one to the other.
"""
from __future__ import annotations

import torch


def cholesky_potf2_ref(A: torch.Tensor):
    """Plain torch Cholesky of the symmetric A [..., n, n] (its lower
    triangle read) in dpotf2's order: column j's pivot is a_jj minus the
    serial sum of l_jk^2 over k < j; the column below it is a_ij plus
    (-l_jk) l_ik for k = 0, 1, ... in turn, times 1 / l_jj.  Returns (L,
    info): info 0, or j + 1 for the first pivot j that is not positive and
    finite (the factorization goes on with NaNs).  No read-back."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    info = torch.zeros(A.shape[:-2], dtype=torch.int32, device=A.device)
    for j in range(n):
        s = torch.zeros_like(A[..., j, j])
        for k in range(j):
            s = s + L[..., j, k] * L[..., j, k]
        ajj = A[..., j, j] - s
        bad = ~((ajj > 0) & torch.isfinite(ajj))
        info = torch.where((info == 0) & bad, j + 1, info)
        ljj = torch.sqrt(ajj)
        L[..., j, j] = ljj
        if j + 1 < n:
            y = A[..., j + 1:, j]
            for k in range(j):
                y = y + (-L[..., j, k])[..., None] * L[..., j + 1:, k]
            L[..., j + 1:, j] = y * (1.0 / ljj)[..., None]
    return L, info


def _potf2_cuda(A: torch.Tensor):
    from pips_ipmpp_tpu_torch import _build

    if A.dtype != torch.float64:
        raise TypeError(f"the CUDA potf2 kernel takes float64, got {A.dtype}")
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected [..., n, n], got {tuple(A.shape)}")
    A = A.contiguous()
    n = A.shape[-1]
    L = torch.empty_like(A)
    info = torch.empty(A.shape[:-2], dtype=torch.int32, device=A.device)
    B = info.numel()
    if B == 0 or n == 0:
        return L, info.zero_()
    W = torch.empty((B, 2 * n), dtype=A.dtype, device=A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.potf2_f64(A.data_ptr(), L.data_ptr(), W.data_ptr(),
                           info.data_ptr(), B, n, stream)
    if rc != 0:
        raise RuntimeError(f"potf2_f64 launch failed: CUDA error {rc} at "
                           f"B={B}, n={n}")
    potf2.launches += 1
    potf2.captured += torch.cuda.is_current_stream_capturing()
    potf2.launches_by[(B, n)] = potf2.launches_by.get((B, n), 0) + 1
    return L, info


def potf2(A: torch.Tensor):
    """(L, info) of `cholesky_potf2_ref` for the symmetric A [..., n, n]:
    the plain version for a CPU tensor, the kernel for a CUDA one, which
    counts its launch in `potf2.launches` (one into a graph being captured
    also in `potf2.captured`) and per shape in `potf2.launches_by[(B,
    n)]`."""
    if A.device.type == "cpu":
        return cholesky_potf2_ref(A)
    if A.device.type == "cuda":
        return _potf2_cuda(A)
    raise ValueError(f"no potf2 implementation for device {A.device}")


potf2.launches = 0
potf2.captured = 0   # of those, into a captured CUDA graph
potf2.launches_by = {}


def cholesky_potf2(S: torch.Tensor):
    """Cholesky factor of (S + S')/2 in LAPACK's unblocked order and a
    health flag per matrix (shape S.shape[:-2]); a failed factorization
    does not raise."""
    L, info = potf2((S + S.mT) / 2)
    return L, (info == 0) & torch.isfinite(L).flatten(-2).all(-1)
