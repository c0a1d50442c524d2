// Batched f64 Cholesky in LAPACK's unblocked order (dpotf2) for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package factors the two-level root's
// blocks (S11 and the dual Schur complement, f64, a few to ~200 rows) with
// jnp.linalg.cholesky, which on its CPU is LAPACK.  On the card
// torch.linalg.cholesky_ex is cuSOLVER's potrf, whose other order of sums
// accepts root blocks singular to working precision that LAPACK refuses
// (ROADMAP.md §3, F3: a pivot ratio of 6e-27 where LAPACK's pivot goes
// negative), and two golden instances then miss PIPS-IPM++'s acceptance.
// This kernel takes LAPACK's unblocked order instead, the order of the
// plain version `linalg/potf2.py::cholesky_potf2_ref`, bit for bit:
//   column j:  pivot  a_jj - s,  s = sum_{k<j} l_jk^2 added in turn from
//                                k = 0 (DDOT's serial loop);
//              l_jj   = sqrt(pivot); a pivot <= 0 or not finite fails;
//              l_ij   = (a_ij + (-l_jk) l_ik for k = 0, 1, ... in turn)
//                       * (1 / l_jj)     (DGEMV's column sweep, DSCAL).
// Every product and sum is rounded on its own (__dmul_rn, __dadd_rn): no
// FMA contraction, as in the plain version's separate torch operations.
//
// What bounds it on an H100.  The work is n^3/3 f64 flops and n^2 doubles
// per matrix, microseconds at any rate; the time is the chain of n pivots,
// a few barriers each, and the latency of the memory the running sums sit
// in.  Design: one CTA per matrix (grid = batch), 1024 threads (32 warps
// to hide the latency of the short dependent updates), right-looking.
// Each entry below the diagonal keeps its running sum y_ij and each row
// its running pivot sum s_i; both take the terms of step k in turn, k = 0,
// 1, ..., so their order is the plain version's left-looking one, term
// for term.  Step k, two barriers: the threads scale column k
// (adding l_ik^2 to s_i, which completes s_{k+1}, so the thread of row
// k + 1 forms pivot k + 1 there), then each warp updates rows of the
// trailing triangle, y_ij += (-l_jk) l_ik, its lanes over consecutive j.
// Where the lower triangle, packed, and three vectors (s, column k, A's
// diagonal) fit in shared memory (n <= 237 with the H100's 227 KiB) they
// live there and L is written once at the end; a larger matrix keeps them
// in device memory (L itself and a workspace), so no edge is refused.
// The lower triangle of A is read; L's upper triangle is written as zeros.
// info[b] is 0, or j + 1 for the first failed pivot j (the factorization
// goes on, as the plain version does, with NaNs).
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
potf2_kernel(const double* __restrict__ A, double* __restrict__ L,
             double* __restrict__ W, int* __restrict__ info, int n,
             bool in_shared) {
  extern __shared__ double smem[];
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const double* a = A + off;
  double* l = L + off;
  // s: row pivot sums; col: column k; d: A's diagonal; t: the running
  // sums, packed lower triangle in shared memory or L row major
  double* s = in_shared ? smem : W + static_cast<size_t>(blockIdx.x) * 3 * n;
  double* col = s + n;
  double* d = s + 2 * n;
  double* t = in_shared ? smem + 3 * n : l;
  auto at = [&](int i, int j) -> double& {
    return t[in_shared ? static_cast<size_t>(i) * (i + 1) / 2 + j
                       : static_cast<size_t>(i) * n + j];
  };
  __shared__ double s_inv[2];   // 1 / l_kk, by the parity of k
  __shared__ int s_info;
  // pivot j from its completed s_j (thread 0 of the step before)
  auto pivot = [&](int j) {
    const double ajj = __dsub_rn(d[j], s[j]);
    if (!(ajj > 0.0) || isinf(ajj))
      if (s_info == 0) s_info = j + 1;
    const double ljj = __dsqrt_rn(ajj);
    at(j, j) = ljj;
    s_inv[j & 1] = __ddiv_rn(1.0, ljj);
  };
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int r = idx / n, c = idx % n;
    if (c < r)
      at(r, c) = a[idx];
    else if (!in_shared)
      l[idx] = 0.0;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = 0.0;
    d[i] = a[static_cast<size_t>(i) * n + i];
  }
  if (threadIdx.x == 0) s_info = 0;
  __syncthreads();
  if (threadIdx.x == 0) pivot(0);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = 0; k < n; ++k) {
    const double inv = s_inv[k & 1];
    for (int i = k + 1 + threadIdx.x; i < n; i += blockDim.x) {
      const double v = __dmul_rn(at(i, k), inv);
      at(i, k) = v;
      col[i] = v;
      s[i] = __dadd_rn(s[i], __dmul_rn(v, v));
      if (i == k + 1) pivot(i);
    }
    __syncthreads();
    for (int i = k + 1 + warp; i < n; i += kWarps) {
      // row i and column k never overlap: the loads may run ahead
      double* __restrict__ row = &at(i, 0);
      const double* __restrict__ ck = col;
      const double li = ck[i];
#pragma unroll 4
      for (int j = k + 1 + lane; j < i; j += 32)
        row[j] = __dadd_rn(row[j], __dmul_rn(-ck[j], li));
    }
    __syncthreads();
  }
  if (in_shared)
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int r = idx / n, c = idx % n;
      l[idx] = c <= r ? at(r, c) : 0.0;
    }
  if (threadIdx.x == 0) info[blockIdx.x] = s_info;
}

}  // namespace

// A, L: [B, n, n] float64 row major on the device (A symmetric, its lower
// triangle read); W: [B, 3n] float64 workspace (used where the matrix does
// not fit in shared memory); info: [B] int32.  One launch on `stream`;
// returns the first CUDA error of the attribute calls or the launch, else
// 0.
extern "C" int potf2_f64(const double* A, double* L, double* W, int* info,
                         int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t words = 3 * static_cast<size_t>(n) +
                       static_cast<size_t>(n) * (n + 1) / 2;
  // the kernel's own static shared memory: s_inv and s_info
  const bool in_shared = (words * sizeof(double) + 64) <=
                         static_cast<size_t>(optin);
  const size_t bytes = in_shared ? words * sizeof(double) : 0;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(potf2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  potf2_kernel<<<B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      A, L, W, info, n, in_shared);
  return static_cast<int>(cudaGetLastError());
}
