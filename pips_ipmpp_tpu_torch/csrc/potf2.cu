// Batched f64 Cholesky in LAPACK's unblocked order (dpotf2) for Hopper
// (sm_90a), blocked over panels of kNb = 32 columns and many CTAs.
//
// Replaces no Pallas kernel.  The JAX package factors the two-level root's
// blocks (S11 and the dual Schur complement, f64, a few to ~550 rows) with
// jnp.linalg.cholesky, which on its CPU is LAPACK.  On the card
// torch.linalg.cholesky_ex is cuSOLVER's potrf, whose other order of sums
// accepts root blocks singular to working precision that LAPACK refuses
// (ROADMAP.md §3, F3: a pivot ratio of 6e-27 where LAPACK's pivot goes
// negative), and two golden instances then miss PIPS-IPM++'s acceptance.
// This kernel keeps LAPACK's unblocked order instead, the order of the
// plain version `linalg/potf2.py::cholesky_potf2_ref`, bit for bit:
//   column j:  pivot  a_jj - s_j,  s_j = sum_{k<j} l_jk^2 added in turn
//                                  from k = 0 (DDOT's serial loop);
//              l_jj   = sqrt(pivot); a pivot <= 0 or not finite fails;
//              l_ij   = (a_ij + (-l_jk) l_ik for k = 0, 1, ... in turn)
//                       * (1 / l_jj)     (DGEMV's column sweep, DSCAL).
// Every product and sum is rounded on its own (__dmul_rn, __dadd_rn): no
// FMA contraction, as in the plain version's separate torch operations.
// Blocking keeps that order: each element's terms arrive in increasing k
// because the panels run in order and, inside a panel, each element takes
// its own terms in order (no split k, no partial sums).
//
// What bounds it on an H100.  The work is n^3/3 f64 flops and n^2 doubles
// per matrix: microseconds at any rate for every root block (0.002 ms at
// n = 550).  The floor is the chain of n dependent pivots: pivot j + 1
// needs s_{j+1}, which needs l_{j+1,j} = y * (1 / l_jj), which needs the
// square root and the division of pivot j, each a software sequence of
// dependent f64 operations with a rarely taken slow path.  The one-CTA
// kernel this replaces (two CTA-wide barriers per column, its running
// sums in device memory above n = 237, where one SM streamed ~n^3/6 x 16 B
// through L2) took 7.73 ms at n = 550.  This one keeps the chain inside
// one warp and spreads the rest over many CTAs; its floor is ceil(n / 32)
// diagonal blocks, ~7.5 us each on an H100 (PERF.md §6).
//
// Design, per panel of columns [c0, c1), c1 = c0 + kNb (the last panel
// may be narrower), three parts:
//  (a) the diagonal block, one warp per matrix: lane r holds row c0 + r
//      of the block in registers (y, its pivot sum s and a_rr), and the
//      block is factored right-looking with warp shuffles only; per
//      column the chain is DSUB, SHFL, DSQRT, DDIV, DMUL, DMUL, DADD.
//      Column k's updates of the columns after it wait for the square
//      root of pivot k + 1, so that no branch parts them from it and they
//      run in the shadow of its latency, and a failed pivot is found by
//      one ballot after the block, off the chain.  It writes L's
//      block, 1 / l_jj of its columns to the workspace, and info;
//  (b) the panel's rows below it, one warp per row over many CTAs: lane
//      t holds y_{i,c0+t} and row t of the factored block; each row is a
//      triangular sweep in k order, (y_ij + sum_{c0<=k<j} (-l_jk) l_ik)
//      * (1 / l_jj), and adds its l_ik^2 to s_i in k order.  It also
//      writes the zeros of L's upper triangle above the row's column;
//  (c) the trailing update over (tiles x batch) CTAs of kNb x kNb tiles
//      of the strictly lower trailing triangle: each element stays in a
//      register and takes the panel's kNb terms in k order, the panel's
//      rows of both tiles staged in shared memory.  The diagonal is never
//      updated through y: it goes only through s and a_jj.
// Lookahead: the CTA of the trailing triangle's first tile, the next
// panel's diagonal block, factors it (a) right after its own update,
// while the other CTAs update theirs, so a panel costs two launches, (b)
// and (c) + (a), and the whole call 2 ceil(n / kNb) - 1 on the caller's
// stream (one for n <= kNb).  A deeper lookahead, one persistent kernel
// whose CTAs take the same parts as items in a topological ticket order
// with ready flags in device memory, was measured slower at every edge
// above kNb (PERF.md §6), so the panels stay launches.  The running sums
// live in L itself (the lower triangle of A is read where L holds
// nothing yet) and in a workspace W [B, 2n] (s, then 1 / l_jj); nothing
// is read back, so the call can be captured into a CUDA graph.  info[b]
// is 0, or j + 1 for the first failed pivot j (the factorization goes
// on, as the plain version does, with NaNs).  No edge is refused.
#include <math.h>

namespace {

constexpr int kNb = 32;               // panel width: one lane per row
constexpr int kRowWarps = 4;          // (b): rows per CTA
constexpr int kTileThreads = 256;     // (c): 8 warps, 4 rows each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool bad_pivot(double p) {
  return !(p > 0.0) || isinf(p);
}

// (a): factor the diagonal block at rows and columns [c0, c0 + m),
// m = min(kNb, n - c0), in one warp; load(r, j) gives y of block row r,
// column j < r, with every term of the columns before c0.  `first`: no
// panel came before (s = 0, info starts at 0).  a, l, w, info are this
// matrix's.
template <class Load>
__device__ __forceinline__ void factor_block(Load load,
                                             const double* __restrict__ a,
                                             double* __restrict__ l,
                                             double* __restrict__ w,
                                             int* __restrict__ info, int n,
                                             int c0, bool first) {
  const int lane = threadIdx.x & 31;
  const int m = min(kNb, n - c0);
  const size_t r = static_cast<size_t>(c0) + lane;
  double y[kNb];
#pragma unroll
  for (int j = 0; j < kNb; ++j)
    y[j] = (j < lane && lane < m) ? load(lane, j) : 0.0;
  double s = (first || lane >= m) ? 0.0 : w[r];
  const double d = lane < m ? a[r * n + r] : 1.0;
  double lrr = 0.0, rinv = 0.0, rpiv = 1.0, v = 0.0;
  // pivot 0 from lane 0's s, the same value on every lane
  double piv = __shfl_sync(kFull, __dsub_rn(d, s), 0);
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    if (k >= m) break;
    // column k - 1's updates, y_rj += (-l_j,k-1) l_r,k-1 for j >= k, wait
    // until here, where no branch parts them from the square root, so
    // that they run in the shadow of its latency; y_rk needs them only
    // after the division
    if (k > 0) {
#pragma unroll
      for (int j = k; j < kNb; ++j)
        y[j] = __dadd_rn(y[j], __dmul_rn(-__shfl_sync(kFull, v, j), v));
    }
    const double lkk = __dsqrt_rn(piv);
    const double inv = __ddiv_rn(1.0, lkk);
    if (lane == k) {
      rpiv = piv;
      lrr = lkk;
      rinv = inv;
    }
    // l_rk on the lanes below k (the others' values go unused)
    v = __dmul_rn(y[k], inv);
    y[k] = v;
    s = __dadd_rn(s, __dmul_rn(v, v));
    // pivot k + 1 from lane k + 1's completed s, at once
    if (k + 1 < kNb) piv = __shfl_sync(kFull, __dsub_rn(d, s), k + 1);
  }
  // the first failed pivot of the block, unless one failed before it
  const unsigned failed = __ballot_sync(kFull, lane < m && bad_pivot(rpiv));
  const int before = first ? 0 : *info;
  if (lane < m) {
    double* row = l + r * n + c0;
#pragma unroll
    for (int j = 0; j < kNb; ++j)
      if (j < m) row[j] = j < lane ? y[j] : (j == lane ? lrr : 0.0);
    w[n + r] = rinv;
  }
  if (lane == 0) *info = before == 0 && failed ? c0 + __ffs(failed) : before;
}

// (a) of the first panel: one warp per matrix (blockIdx.x)
__global__ void __launch_bounds__(32)
potf2_diag_kernel(const double* __restrict__ A, double* __restrict__ L,
                  double* __restrict__ W, int* __restrict__ info, int n) {
  const size_t b = blockIdx.x;
  const double* a = A + b * n * n;
  factor_block([&](int r, int j) { return a[static_cast<size_t>(r) * n + j]; },
               a, L + b * n * n, W + b * 2 * n, info + b, n, 0, true);
}

// (b): row i = c1 + blockIdx.x * kRowWarps + warp of matrix blockIdx.y,
// panel [c0, c0 + kNb) (never the last panel, so always kNb wide)
__global__ void __launch_bounds__(kRowWarps * 32)
potf2_panel_kernel(const double* __restrict__ A, double* __restrict__ L,
                   double* __restrict__ W, int n, int c0) {
  const size_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = c0 + kNb + blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (i >= n) return;
  double* l = L + b * n * n;
  double* w = W + b * 2 * n;
  const double* src = c0 == 0 ? A + b * n * n : l;
  const size_t j = static_cast<size_t>(c0) + lane;    // this lane's column
  double y = src[static_cast<size_t>(i) * n + j];
  const double inv = w[n + j];
  double ljk[kNb];                                    // l_jk, k < lane
#pragma unroll
  for (int k = 0; k < kNb; ++k)
    ljk[k] = k < lane ? l[j * n + c0 + k] : 0.0;
  double s = c0 == 0 ? 0.0 : w[i];
  double out = 0.0;
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const double lik = __shfl_sync(kFull, __dmul_rn(y, inv), k);
    if (lane == k) out = lik;
    s = __dadd_rn(s, __dmul_rn(lik, lik));
    y = __dadd_rn(y, __dmul_rn(-ljk[k], lik));
  }
  l[static_cast<size_t>(i) * n + j] = out;
  l[j * n + i] = 0.0;                                 // L's upper triangle
  if (lane == 0) w[i] = s;
}

// (c) + the next panel's (a): tile blockIdx.x of the strictly lower
// trailing triangle below panel [c0, c0 + kNb) of matrix blockIdx.y;
// tile 0 is the next diagonal block, which this CTA then factors
__global__ void __launch_bounds__(kTileThreads)
potf2_update_kernel(const double* __restrict__ A, double* __restrict__ L,
                    double* __restrict__ W, int* __restrict__ info, int n,
                    int c0) {
  __shared__ double pi[kNb][kNb + 1];   // the panel's rows of the tile's rows
  __shared__ double pj[kNb][kNb + 1];   // ... of the tile's columns
  __shared__ double tile[kNb][kNb + 1];
  const size_t b = blockIdx.y;
  const int c1 = c0 + kNb;
  // tile t -> (I, J), I >= J, in the order (0,0), (1,0), (1,1), (2,0), ...
  const int t = blockIdx.x;
  int I = static_cast<int>((sqrt(8.0 * t + 1.0) - 1.0) / 2.0);
  while (I * (I + 1) / 2 > t) --I;
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  const int J = t - I * (I + 1) / 2;
  const int r0 = c1 + I * kNb, q0 = c1 + J * kNb;
  const double* a = A + b * n * n;
  double* l = L + b * n * n;
  const double* src = c0 == 0 ? a : l;
  for (int e = threadIdx.x; e < kNb * kNb; e += kTileThreads) {
    const int r = e / kNb, k = e % kNb;
    pi[r][k] = r0 + r < n ? l[static_cast<size_t>(r0 + r) * n + c0 + k] : 0.0;
    pj[r][k] = q0 + r < n ? l[static_cast<size_t>(q0 + r) * n + c0 + k] : 0.0;
  }
  __syncthreads();
  const int tx = threadIdx.x % kNb, ty = threadIdx.x / kNb;
  constexpr int kRows = kNb * kNb / kTileThreads;
  const int j = q0 + tx;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int ri = ty + q * (kTileThreads / kNb);
    const int i = r0 + ri;
    if (i < n && j < i) {
      double y = src[static_cast<size_t>(i) * n + j];
#pragma unroll 8
      for (int k = 0; k < kNb; ++k)
        y = __dadd_rn(y, __dmul_rn(-pj[tx][k], pi[ri][k]));
      if (t == 0)
        tile[ri][tx] = y;
      else
        l[static_cast<size_t>(i) * n + j] = y;
    }
  }
  if (t != 0) return;
  __syncthreads();
  if (threadIdx.x < 32)
    factor_block([&](int r, int jj) { return tile[r][jj]; }, a, l,
                 W + b * 2 * n, info + b, n, c1, false);
}

int launches(int n) { return n <= kNb ? 1 : 2 * ((n + kNb - 1) / kNb) - 1; }

}  // namespace

// CUDA launches per call at edge n, and the panel width
extern "C" int potf2_launches(int n) { return n > 0 ? launches(n) : 0; }
extern "C" int potf2_nb() { return kNb; }

// A, L: [B, n, n] float64 row major on the device (A symmetric, its lower
// triangle read); W: [B, 2n] float64 workspace; info: [B] int32.
// potf2_launches(n) kernels on `stream`; returns the first CUDA error of
// the launches, else 0.
extern "C" int potf2_f64(const double* A, double* L, double* W, int* info,
                         int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  potf2_diag_kernel<<<B, 32, 0, st>>>(A, L, W, info, n);
  cudaError_t err = cudaGetLastError();
  for (int c0 = 0; err == cudaSuccess && c0 + kNb < n; c0 += kNb) {
    const int below = n - c0 - kNb;
    potf2_panel_kernel<<<dim3((below + kRowWarps - 1) / kRowWarps, B),
                         kRowWarps * 32, 0, st>>>(A, L, W, n, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    const int R = (below + kNb - 1) / kNb;
    potf2_update_kernel<<<dim3(R * (R + 1) / 2, B), kTileThreads, 0, st>>>(
        A, L, W, info, n, c0);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
