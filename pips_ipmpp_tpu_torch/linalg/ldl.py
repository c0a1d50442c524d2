r"""Batched LDL^T factorization + triangular inverse.

Counterpart of `pips_ipmpp_tpu/linalg/pallas_ldl.py`.  Every block's
condensed KKT `Neq_i` (SPD) and the root quasidefinite matrix S are
factorized and explicitly inverted each IPM iteration.  For a batch A
[B, a, a] of symmetric quasidefinite matrices the unpivoted LDL^T gives

    A = L D L^T,   X = L^{-1} (unit lower),   A^{-1} = X^T D^{-1} X.

It is sign-agnostic and takes no square root, so the SPD leaves and the
indefinite root go through the same routine.  No pivot is checked here:
`inverse_ok` does that afterwards.

`ldl_inverse_factors` dispatches on the tensor's device: a CPU tensor goes
to the plain torch version `ldl_inverse_factors_ref`, a CUDA tensor to the
hand-written Hopper kernel `csrc/ldl_inverse.cu`, which takes any edge a
whose [B, a, a] input, output and scratch fit in device memory.  There is
no fallback from one to the other.  `ldl_inverse_factors_blocked_ref` is
the kernel's blocked algorithm in plain torch, for the tests.
"""
from __future__ import annotations

import torch


def ldl_inverse_factors_ref(A: torch.Tensor):
    """Plain torch batched unpivoted LDL^T + L^{-1}, in A's dtype.

    One column sweep per step j on the shrinking trailing matrix; row j of
    X is final when step j runs (steps only touch rows > j), so the L
    column is applied to X immediately and L itself is never stored."""
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"expected [B, a, a], got {tuple(A.shape)}")
    B, a, _ = A.shape
    W = A.clone()
    X = torch.eye(a, dtype=A.dtype, device=A.device).repeat(B, 1, 1)
    d = torch.empty((B, a), dtype=A.dtype, device=A.device)
    for j in range(a):
        piv = W[:, j, j]
        d[:, j] = piv
        if j + 1 == a:
            break
        col = W[:, j + 1:, j]                                  # [B, a-j-1]
        lcol = col / piv[:, None]
        W[:, j + 1:, j + 1:] -= lcol[:, :, None] * col[:, None, :]
        X[:, j + 1:, :j + 1] -= lcol[:, :, None] * X[:, j:j + 1, :j + 1]
    return X, d


def ldl_inverse_factors_blocked_ref(A: torch.Tensor, nb: int = 64):
    """Plain torch mirror of the CUDA kernel's blocked algorithm.

    Per panel step k0 -> k1 = k0 + nb (the kernel's launches in brackets):
      (a) [diag]   A11 = L11 D1 L11^T and X11 = L11^{-1} on the diagonal
                   block; the panel's X rows left of it become
                   X11 X[k0:k1, :k0] [panel launch];
      (b) [panel]  L21 = A21 X11^T D1^{-1};
      (c) [update] A22 -= L21 D1 L21^T;
      (d) [update] X[k1:, :k1] -= L21 X[k0:k1, :k1].
    Tests hold it against `ldl_inverse_factors_ref` so that the kernel's
    decomposition is pinned where the kernel cannot run; the solver never
    calls it."""
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"expected [B, a, a], got {tuple(A.shape)}")
    B, a, _ = A.shape
    W = A.clone()
    X = torch.zeros_like(A)
    d = torch.empty((B, a), dtype=A.dtype, device=A.device)
    for k0 in range(0, a, nb):
        k1 = min(k0 + nb, a)
        X11, d1 = ldl_inverse_factors_ref(W[:, k0:k1, k0:k1])      # (a)
        d[:, k0:k1] = d1
        X[:, k0:k1, :k0] = X11 @ X[:, k0:k1, :k0]
        X[:, k0:k1, k0:k1] = X11
        if k1 == a:
            break
        L21 = W[:, k1:, k0:k1] @ X11.mT / d1[:, None, :]            # (b)
        W[:, k1:, k1:] -= (L21 * d1[:, None, :]) @ L21.mT           # (c)
        X[:, k1:, :k1] -= L21 @ X[:, k0:k1, :k1]                    # (d)
    return X, d


def _ldl_inverse_factors_cuda(A: torch.Tensor):
    from pips_ipmpp_tpu_torch import _build

    if A.dtype != torch.float32:
        raise TypeError(f"the CUDA LDL kernel takes float32, got {A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"expected [B, a, a], got {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("the CUDA LDL kernel needs a contiguous input")
    B, a, _ = A.shape
    X = torch.empty_like(A)
    W = torch.empty_like(A)
    d = torch.empty((B, a), dtype=A.dtype, device=A.device)
    if B == 0 or a == 0:
        return X, d
    lib = _build.load()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.ldl_inverse_f32(A.data_ptr(), X.data_ptr(), d.data_ptr(),
                                 W.data_ptr(), B, a, stream)
    if rc != 0:
        raise RuntimeError(f"ldl_inverse_f32 launch failed: CUDA error {rc} "
                           f"at B={B}, a={a}")
    ldl_inverse_factors.launches += 1
    ldl_inverse_factors.captured += torch.cuda.is_current_stream_capturing()
    by = ldl_inverse_factors.launches_by
    by[(B, a)] = by.get((B, a), 0) + 1
    return X, d


def ldl_inverse_factors(A: torch.Tensor):
    """Batched LDL^T of A [B, a, a] -> (X, d) with A^{-1} = X^T D^{-1} X.

    X is L^{-1} (unit lower triangular, zero above the diagonal), d the
    pivot vector [B, a] (negative entries are fine).  CPU tensors run the
    plain version; CUDA tensors launch the kernel and count the launch in
    `ldl_inverse_factors.launches` (one into a graph being captured also
    in `ldl_inverse_factors.captured`) and per shape in
    `ldl_inverse_factors.launches_by[(B, a)]`."""
    if A.device.type == "cpu":
        return ldl_inverse_factors_ref(A)
    if A.device.type == "cuda":
        return _ldl_inverse_factors_cuda(A)
    raise ValueError(f"no LDL implementation for device {A.device}")


ldl_inverse_factors.launches = 0
ldl_inverse_factors.captured = 0   # of those, into a captured CUDA graph
ldl_inverse_factors.launches_by = {}


def inverse_from_factors(X: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """A^{-1} = X^T diag(1/d) X for a batch of factors."""
    return X.transpose(1, 2) @ (X / d[:, :, None])


def batched_inverse(A: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a batch of symmetric quasidefinite matrices."""
    return inverse_from_factors(*ldl_inverse_factors(A))


def inverse_ok(X: torch.Tensor, d: torch.Tensor,
               n_pos: int | None = None) -> torch.Tensor:
    """Factorization health check: finite factors, nonzero pivots, and —
    when `n_pos` is given — the quasidefinite inertia (first n_pos pivots
    positive, rest negative), the role of the reference's inertia test
    (factorize_with_correct_inertia, LinearSystem.C:296-325)."""
    ok = (torch.isfinite(X).all() & torch.isfinite(d).all()
          & (d.abs() > 0.0).all())
    if n_pos is not None:
        ok = ok & (d[:, :n_pos] > 0.0).all() & (d[:, n_pos:] < 0.0).all()
    else:
        ok = ok & (d > 0.0).all()
    return ok
