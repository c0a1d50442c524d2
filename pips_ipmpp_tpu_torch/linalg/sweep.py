r"""Batched explicit inverse by the blocked symmetric SWEEP operator.

Counterpart of `pips_ipmpp_tpu/linalg/pallas_sweep.py`.  One pass turns a
batch of symmetric quasidefinite matrices A [B, a, a] into A^{-1} and the
pivots d [B, a] of its 2x2 pivot blocks (d_2j = a, d_2j+1 = det/a), whose
signs give the inertia (`ldl.inverse_ok` reads them).  Per panel K of
columns, on the working matrix m (= A at the start):

    B = inv(m[K,K])                (2x2-pivot Gauss-Jordan)
    W = m[:,K] B
    m -= W m[:,K]^T                (rank-|K| update of the full matrix)
    m[K,:] = W^T,  m[:,K] = W,  m[K,K] = -B

and A^{-1} = -m after the last panel.  The JAX kernel sweeps panels of 16
columns, on a identity-padded to a multiple of 16; the CUDA kernel panels
of 64 (a ragged last one when a is not a multiple of 64), on a padded to
an even edge.  Identity padding is exact (the padded inverse is block
diagonal), and in exact arithmetic both orders are the same sweep: the
same A^{-1} and the same pivots d, rounded differently.

Unpivoted Gauss-Jordan has no backward-stability guarantee: on matrices
with IPM-like diagonal spread the inverse is O(1) wrong even in f64, so
`ArrowBackend` uses it only with `sweep_kernel=True`.

`sweep_inverse` dispatches on the tensor's device: a CPU tensor goes to
the plain torch version `sweep_inverse_ref` (the JAX kernel's 16-column
panels), a CUDA tensor to the hand-written Hopper kernel
`csrc/sweep_inverse.cu` (float32), which takes any edge a whose input,
output and scratch fit in device memory.  There is no fallback from one to
the other.  `sweep_inverse_blocked_ref` is the kernel's 64-column
algorithm in plain torch, for the tests.
"""
from __future__ import annotations

from functools import partial

import torch

PANEL = 16      # the JAX kernel's panel width, and the padding unit
PAIR = 2        # the CUDA kernel's padding unit: one 2x2 pivot


def _small_sweep_inv(P: torch.Tensor):
    """Inverse and pivots of a [G, p, p] symmetric quasidefinite block by
    p/2 steps of 2x2 pivots.  Returns (P^{-1}, d [G, p])."""
    m = P.clone()
    G, p, _ = P.shape
    d = torch.zeros((G, p), dtype=P.dtype, device=P.device)
    for j in range(p // 2):
        j0, j1 = 2 * j, 2 * j + 1
        col0, col1 = m[:, :, j0].clone(), m[:, :, j1].clone()      # [G, p]
        a, b, c = col0[:, j0], col0[:, j1], col1[:, j1]            # [G]
        det = a * c - b * b
        idet = 1.0 / det
        e00, e01, e11 = (c * idet)[:, None], (-b * idet)[:, None], \
            (a * idet)[:, None]
        W0 = col0 * e00 + col1 * e01                               # [G, p]
        W1 = col0 * e01 + col1 * e11
        # the full update zeroes the swept rows/cols and the pivot block
        m = m - W0[:, :, None] * col0[:, None, :] \
            - W1[:, :, None] * col1[:, None, :]
        # pivot columns <- W (their pivot rows hold -B's 2x2 block), pivot
        # rows <- W^T outside the pivot columns
        Wc0, Wc1 = W0.clone(), W1.clone()
        Wc0[:, j0], Wc0[:, j1] = -e00[:, 0], -e01[:, 0]
        Wc1[:, j0], Wc1[:, j1] = -e01[:, 0], -e11[:, 0]
        Wr0, Wr1 = W0.clone(), W1.clone()
        Wr0[:, [j0, j1]] = 0.0
        Wr1[:, [j0, j1]] = 0.0
        m[:, :, j0] += Wc0
        m[:, :, j1] += Wc1
        m[:, j0, :] += Wr0
        m[:, j1, :] += Wr1
        d[:, j0] = a
        d[:, j1] = det / torch.where(a == 0.0, torch.ones_like(a), a)
    return -m, d


def _sweep_panels(A: torch.Tensor, panel: int):
    """The panel loop on A [B, a, a] with a a multiple of PANEL, in panels
    of `panel` columns (a multiple of PANEL; the last one ragged)."""
    x = A.clone()
    d = torch.empty(A.shape[:2], dtype=A.dtype, device=A.device)
    for r0 in range(0, A.shape[1], panel):
        K = slice(r0, r0 + panel)
        Binv, d[:, K] = _small_sweep_inv(x[:, K, K])
        colk = x[:, :, K].clone()                              # [B, a, p]
        W = colk @ Binv
        x -= W @ colk.mT
        x[:, K, :] = W.mT
        x[:, :, K] = W
        x[:, K, K] = -Binv
    return -x, d


def padded_edge(a: int, unit: int = PAIR) -> int:
    """The edge that `run` of `_padded` sees for edge a: a rounded up to a
    multiple of `unit` (the CUDA kernel's by default)."""
    return a + (-a) % unit


def _padded(A: torch.Tensor, run, unit: int):
    """Identity-pad a to a multiple of `unit`, run, and cut the pad off."""
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"expected [B, a, a], got {tuple(A.shape)}")
    B, a, _ = A.shape
    pad = padded_edge(a, unit) - a
    if not pad:
        return run(A)
    Ap = torch.zeros((B, a + pad, a + pad), dtype=A.dtype, device=A.device)
    Ap[:, :a, :a] = A
    Ap[:, a:, a:] = torch.eye(pad, dtype=A.dtype, device=A.device)
    Ainv, d = run(Ap)
    return Ainv[:, :a, :a], d[:, :a]


def sweep_inverse_ref(A: torch.Tensor):
    """Plain torch version in the JAX kernel's order (16-column panels), in
    A's dtype: (A^{-1}, d)."""
    return _padded(A, partial(_sweep_panels, panel=PANEL), PANEL)


def sweep_inverse_blocked_ref(A: torch.Tensor, nb: int = 64):
    """Plain torch mirror of the CUDA kernel's algorithm: panels of `nb`
    columns (a multiple of 16), the last one ragged.  Per panel (the
    kernel's launches in brackets): B by nb/2 steps of 2x2 pivots [pivot];
    the old column panel C = m[:,K] and W = C B [panel]; m -= W C^T and the
    write-back [update].  Tests hold it against the JAX kernel so that the
    kernel's decomposition is pinned where the kernel cannot run; the
    solver never calls it."""
    if nb <= 0 or nb % PANEL:
        raise ValueError(f"nb must be a positive multiple of {PANEL}")
    return _padded(A, partial(_sweep_panels, panel=nb), PANEL)


def _sweep_cuda(A: torch.Tensor):
    from pips_ipmpp_tpu_torch import _build

    B, a, _ = A.shape
    Ainv = torch.empty_like(A)
    d = torch.empty((B, a), dtype=A.dtype, device=A.device)
    if B == 0:
        return Ainv, d
    lib = _build.load()
    work = torch.empty((B, lib.sweep_inverse_workspace(a)), dtype=A.dtype,
                       device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.sweep_inverse_f32(A.data_ptr(), Ainv.data_ptr(),
                                   d.data_ptr(), work.data_ptr(), B, a,
                                   stream)
    if rc != 0:
        raise RuntimeError(f"sweep_inverse_f32 launch failed: CUDA error "
                           f"{rc} at B={B}, a={a}")
    sweep_inverse.launches += 1
    sweep_inverse.captured += torch.cuda.is_current_stream_capturing()
    return Ainv, d


def sweep_inverse(A: torch.Tensor):
    """Batched explicit inverse of symmetric quasidefinite A [B, a, a] ->
    (A^{-1} [B, a, a], d [B, a]).  CPU tensors run the plain version
    `sweep_inverse_ref`; CUDA tensors (float32, contiguous) launch the
    kernel and count the call in `sweep_inverse.launches` (the kernel's
    CUDA launches per call: `sweep_inverse_launches(padded_edge(a))` of
    the library)."""
    if A.device.type == "cpu":
        return sweep_inverse_ref(A)
    if A.device.type != "cuda":
        raise ValueError(f"no sweep implementation for device {A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"the CUDA sweep kernel takes float32, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("the CUDA sweep kernel needs a contiguous input")
    return _padded(A, _sweep_cuda, PAIR)


sweep_inverse.launches = 0
sweep_inverse.captured = 0   # of those, into a captured CUDA graph
