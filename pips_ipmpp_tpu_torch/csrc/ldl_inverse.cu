// Batched unpivoted LDL^T + unit-lower inverse for Hopper (sm_90a).
//
// Replaces pips_ipmpp_tpu/linalg/pallas_ldl.py:224 (_ldl_call, the Pallas
// TPU kernel behind ldl_inverse_factors).  For each symmetric quasidefinite
// A[b] (a x a, row major) it writes X[b] = L^{-1} (unit lower, zero above
// the diagonal) and the pivots d[b], so that A^{-1} = X^T diag(1/d) X.  No
// sqrt and no pivot check: SPD leaves and the indefinite root share the
// kernel, and inverse_ok() checks the pivots afterwards.
//
// What bounds it on an H100.  At the big leaves [64,1024,1024] the work is
// 2a^3/3 flops per matrix, 0.68 ms at the f32 FFMA peak (67 TFLOP/s); the
// bytes (A in, X out) take 0.32 ms, but a blocked elimination also streams
// the trailing matrix and X's lower rows through device memory once per
// panel (~45 MB per matrix at nb = 64, 0.85 ms for the batch).  At
// [64,256,256] and at the B = 1 roots the work is tens of microseconds or
// less, and launches and the serial chain of diagonal blocks set the time.
//
// Design: blocked right-looking LDL^T with panel width nb = 64, every
// update of rank 64, one matrix spread over many CTAs.  An edge a <= 128
// is one launch of part (a) on the whole matrix.  Otherwise panel step
// k0 -> k1 = k0 + nb is three launches:
//   diag    (a)  one CTA per matrix factors the nb x nb diagonal block,
//                A11 = L11 D1 L11^T, and forms X11 = L11^{-1}, every
//                element in a register, one __syncthreads per column;
//   panel   (b)  L21 = A21 X11^T D1^{-1} in 64 x 64 tiles, written over
//                A21 in W;
//           (a') the panel's X rows left of the block, X11 X[k0:k1, :k0],
//                one 64-column strip per CTA, in place; the strips right
//                of the block are written as zeros (X's upper triangle);
//   update  (c)  A22 -= L21 D1 L21^T on the lower 64 x 64 tiles only (the
//                triangular tile index in closed form);
//           (d)  X[k1:, :k1] -= L21 X[k0:k1, :k1], the elimination applied
//                to the identity.
// The tile parts are GEMMs of depth nb (ffma_tile.cuh): each CTA stages
// its two operands in shared memory in two slices of depth 32, with 16-byte
// cp.async (4-byte when a is not a multiple of 4): the second slice lands
// while the first is used, and an update's old values are loaded into
// registers under both.  256 threads each keep a 4 x 4 tile of f32 sums
// and read their operands as float4.  Grids are (tiles x batch): thousands of CTAs
// at the big leaves, several at a B = 1 root.
// Shared memory holds the two slices of both operands (36 KB) and the
// diagonal kernel's published rows, never a full-height panel, so no edge
// a is refused: any a whose A, X and W fit in device memory is taken.  The
// first step reads A and writes W; later steps work in W, which the
// wrapper allocates.  One writer per output element and no atomics, so
// results do not depend on the schedule.  All arithmetic is f32 FFMA: no
// TF32 (the port pins it off; reduced-precision products stalled the IPM
// near mu 1e-3).  Measured and not kept: a 3xTF32 mma.sync variant of the
// tile GEMMs (passed the accuracy gate, ran 1.5x slower: operands split
// per use, 185+ registers, one CTA per SM), and nb = 128 (1% faster at
// a = 1024, slower at a = 2048 and at the roots: the update is not bound
// by its traffic).
#include <math.h>

#include "ffma_tile.cuh"

namespace {

constexpr int kOneBlock = 128;     // a <= this: one diagonal-block launch

// ---- (a) the diagonal block, one CTA per matrix ----------------------------
// NB = kNb, or kOneBlock when the whole matrix is one block.  The CTA
// holds the block's lower triangle in registers, element (ty + 16 r,
// tx + 16 c) in m[r][c], and W shares the slots with X11: after step j,
// column j of the strict lower triangle holds X11, not W.  Step j
// publishes v = (row j of X11 left of j, the pivot, column j of W below
// j) through shared memory; then every row i > j does
//   m[i][k] -= l_i v[k] (k != j),  m[i][j] = -l_i,  l_i = W[i][j] / piv,
// the W update for k > j and the X update for k < j at once.  The column
// block jq = j / 16 is a compile-time index, so the owners publish without
// selects and the rows r < jq, all above j, are skipped.  One barrier per
// column: step j + 1 publishes into the other buffer, and no thread
// reaches step j + 2 before all have passed step j + 1's.
template <int NB>
__global__ void __launch_bounds__(kThreads)
    ldl_diag_kernel(const float* __restrict__ src, float* __restrict__ X,
                    float* __restrict__ d, int a, int k0) {
  constexpr int Q = NB / 16;
  __shared__ float v[2][NB];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int pw = min(NB, a - k0);
  const size_t off = static_cast<size_t>(blockIdx.x) * a * a;
  const float* S = src + off + static_cast<size_t>(k0) * a + k0;
  float* db = d + static_cast<size_t>(blockIdx.x) * a + k0;
  float m[Q][Q];
#pragma unroll
  for (int r = 0; r < Q; ++r)
#pragma unroll
    for (int c = 0; c < Q; ++c) {
      const int i = ty + 16 * r, k = tx + 16 * c;
      m[r][c] = (i < pw && k <= i) ? S[static_cast<size_t>(i) * a + k] : 0.f;
    }
#pragma unroll
  for (int jq = 0; jq < Q; ++jq) {
    for (int jl = 0; jl < 16; ++jl) {
      const int j = 16 * jq + jl, buf = j & 1;
      if (j >= pw) break;
      if (tx == jl) {  // column j, rows >= j
#pragma unroll
        for (int r = jq; r < Q; ++r)
          if (ty + 16 * r >= j) v[buf][ty + 16 * r] = m[r][jq];
      }
      if (ty == jl) {  // row j, columns < j
#pragma unroll
        for (int c = 0; c <= jq; ++c)
          if (tx + 16 * c < j) v[buf][tx + 16 * c] = m[jq][c];
      }
      __syncthreads();
      const float piv = v[buf][j];
      if (threadIdx.x == 0) db[j] = piv;
      const float inv = 1.f / piv;
      float vk[Q];
#pragma unroll
      for (int c = 0; c < Q; ++c) vk[c] = v[buf][tx + 16 * c];
#pragma unroll
      for (int r = jq; r < Q; ++r) {
        const float l = ty + 16 * r > j ? v[buf][ty + 16 * r] * inv : 0.f;
#pragma unroll
        for (int c = 0; c < Q; ++c) m[r][c] = fmaf(-l, vk[c], m[r][c]);
        if (tx == jl) m[r][jq] = ty + 16 * r > j ? -l : m[r][jq];
      }
    }
  }
  float* Xo = X + off + static_cast<size_t>(k0) * a + k0;
#pragma unroll
  for (int r = 0; r < Q; ++r)
#pragma unroll
    for (int c = 0; c < Q; ++c) {
      const int i = ty + 16 * r, k = tx + 16 * c;
      if (i < pw && k < pw)
        Xo[static_cast<size_t>(i) * a + k] =
            i == k ? 1.f : (k < i ? m[r][c] : 0.f);
    }
}

// ---- (b) L21 and (a') the panel's X rows -----------------------------------
// grid.x: n_rows tiles of (b), then one 64-column strip of the panel's X
// rows per column tile outside the diagonal block; grid.y walks the batch.
template <int V>
__global__ void __launch_bounds__(kThreads)
    ldl_panel_kernel(const float* __restrict__ src, float* __restrict__ W,
                     float* __restrict__ X, const float* __restrict__ d,
                     int B, int a, int k0) {
  __shared__ __align__(16) float As[2 * kSlot];
  __shared__ __align__(16) float Bs[2 * kSlot];
  const int pw = min(kNb, a - k0), k1 = k0 + pw;
  const int n_rows = (a - k1 + kTile - 1) / kTile;
  const int u = blockIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const size_t off = static_cast<size_t>(b) * a * a;
    const float* X11 = X + off + static_cast<size_t>(k0) * a + k0;
    float acc[4][4];
    if (u < n_rows) {
      // (b): L21[i, j] = sum_kk A21[i, kk] X11[j, kk] / d[j]
      const int i0 = k1 + u * kTile;
      const float* A21 = src + off + static_cast<size_t>(i0) * a + k0;
      tile_gemm<V, false>(acc, As, Bs, A21, a, X11, a, a - i0, pw, 0, pw,
                          nullptr);
      const float* dp = d + static_cast<size_t>(b) * a + k0;
      float* L21 = W + off + static_cast<size_t>(i0) * a + k0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + out_row(r) >= a) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = out_col(false, c);
          L21[static_cast<size_t>(out_row(r)) * a + j] = acc[r][c] / dp[j];
        }
      }
    } else {
      const int t = u - n_rows, left = k0 / kTile;
      const int c0 = (t < left ? t : t - left + k1 / kTile) * kTile;
      float* Xp = X + off + static_cast<size_t>(k0) * a + c0;
      if (c0 < k0) {
        // (a'): X[k0 + r, c] = sum_kk X11[r, kk] X[k0 + kk, c], in place:
        // this CTA alone reads and writes these 64 columns of the strip,
        // and tile_gemm's last barrier follows every read
        tile_gemm<V, true>(acc, As, Bs, X11, a, Xp, a, pw, pw, kTile, pw,
                           nullptr);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (out_row(r) >= pw) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            Xp[static_cast<size_t>(out_row(r)) * a + out_col(true, c)] =
                acc[r][c];
        }
      } else {
        // X's upper triangle right of the diagonal block
        const int w = min(kTile, a - c0);
        for (int e = threadIdx.x; e < pw * kTile; e += kThreads) {
          const int i = e / kTile, c = e % kTile;
          if (c < w) Xp[static_cast<size_t>(i) * a + c] = 0.f;
        }
      }
    }
    __syncthreads();  // the slots are restaged for the next matrix
  }
}

// ---- (c) trailing update and (d) X rows below the panel --------------------
// grid.x: the n(n+1)/2 lower tiles of (c), then n x k1/64 tiles of (d).
template <int V>
__global__ void __launch_bounds__(kThreads)
    ldl_update_kernel(const float* __restrict__ src, float* __restrict__ W,
                      float* __restrict__ X, const float* __restrict__ d,
                      int B, int a, int k0) {
  __shared__ __align__(16) float As[2 * kSlot];
  __shared__ __align__(16) float Bs[2 * kSlot];
  const int k1 = k0 + kNb;
  const int n = (a - k1 + kTile - 1) / kTile;
  const int n_c = n * (n + 1) / 2;
  const int u = blockIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const size_t off = static_cast<size_t>(b) * a * a;
    float acc[4][4], old[4][4];
    if (u < n_c) {
      // (c): lower tile (ti, tk), ti >= tk, of the trailing matrix
      int ti = static_cast<int>((sqrt(8.0 * u + 1.0) - 1.0) * 0.5);
      if ((ti + 1) * (ti + 2) / 2 <= u) ++ti;  // guard sqrt's rounding
      if (ti * (ti + 1) / 2 > u) --ti;
      const int tk = u - ti * (ti + 1) / 2;
      const int i0 = k1 + ti * kTile, j0 = k1 + tk * kTile;
      const float* S = src + off + static_cast<size_t>(i0) * a + j0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = out_row(r), j = out_col(false, c);
          old[r][c] = (i0 + i < a && j0 + j < a)
                          ? S[static_cast<size_t>(i) * a + j]
                          : 0.f;
        }
      const float* Li = W + off + static_cast<size_t>(i0) * a + k0;
      const float* Lj = W + off + static_cast<size_t>(j0) * a + k0;
      tile_gemm<V, false>(acc, As, Bs, Li, a, Lj, a, a - i0, a - j0, 0, kNb,
                          d + static_cast<size_t>(b) * a + k0);
      float* Wo = W + off + static_cast<size_t>(i0) * a + j0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + out_row(r) >= a) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j0 + out_col(false, c) < a)
            Wo[static_cast<size_t>(out_row(r)) * a + out_col(false, c)] =
                old[r][c] - acc[r][c];
      }
    } else {
      // (d): X[i, c] -= sum_kk L21[i, kk] X[k0 + kk, c], c < k1; the
      // columns k0..k1 of rows below the panel are still zero (unwritten)
      const int n_x = k1 / kTile;
      const int t = u - n_c;
      const int i0 = k1 + (t / n_x) * kTile, c0 = (t % n_x) * kTile;
      float* Xo = X + off + static_cast<size_t>(i0) * a + c0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          old[r][c] = (i0 + out_row(r) < a && c0 < k0)
                          ? Xo[static_cast<size_t>(out_row(r)) * a +
                               out_col(true, c)]
                          : 0.f;
      const float* Li = W + off + static_cast<size_t>(i0) * a + k0;
      const float* Xp = X + off + static_cast<size_t>(k0) * a + c0;
      tile_gemm<V, true>(acc, As, Bs, Li, a, Xp, a, a - i0, kNb, kTile, kNb,
                         nullptr);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + out_row(r) >= a) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          Xo[static_cast<size_t>(out_row(r)) * a + out_col(true, c)] =
              old[r][c] - acc[r][c];
      }
    }
    __syncthreads();  // the slots are restaged for the next matrix
  }
}

template <int V>
int run(const float* A, float* X, float* d, float* W, int B, int a,
        cudaStream_t s) {
  if (a <= kOneBlock) {
    if (a <= kNb)
      ldl_diag_kernel<kNb><<<B, kThreads, 0, s>>>(A, X, d, a, 0);
    else
      ldl_diag_kernel<kOneBlock><<<B, kThreads, 0, s>>>(A, X, d, a, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const int gy = min(B, kMaxGridY);
  const int n_all = (a + kTile - 1) / kTile;
  for (int k0 = 0; k0 < a; k0 += kNb) {
    const float* src = k0 == 0 ? A : W;
    const int k1 = min(k0 + kNb, a);
    ldl_diag_kernel<kNb><<<B, kThreads, 0, s>>>(src, X, d, a, k0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n = (a - k1 + kTile - 1) / kTile;
    const int strips = k0 / kTile + (k1 < a ? n_all - k1 / kTile : 0);
    ldl_panel_kernel<V><<<dim3(n + strips, gy), kThreads, 0, s>>>(
        src, W, X, d, B, a, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n > 0) {
      ldl_update_kernel<V>
          <<<dim3(n * (n + 1) / 2 + n * (k1 / kTile), gy), kThreads, 0, s>>>(
              src, W, X, d, B, a, k0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

// Panel width at edge a: the width of the diagonal blocks.
extern "C" int ldl_inverse_nb(int a) {
  return a > kNb && a <= kOneBlock ? kOneBlock : kNb;
}

// CUDA launches one call makes at edge a: one for a <= 128; otherwise per
// panel step the diagonal block and the panel, and the update on every
// step but the last.
extern "C" int ldl_inverse_launches(int a) {
  if (a <= 0) return 0;
  if (a <= kOneBlock) return 1;
  return 3 * ((a + kNb - 1) / kNb) - 1;
}

// A, X, W: [B, a, a] float32 row major on the device; d: [B, a].  W is
// scratch.  Launches on `stream` and returns the first nonzero
// cudaGetLastError() of its launches, else 0.
extern "C" int ldl_inverse_f32(const float* A, float* X, float* d, float* W,
                               int B, int a, void* stream) {
  if (B <= 0 || a <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a % 4 == 0 && aligned16(A) && aligned16(X) && aligned16(W))
    return run<4>(A, X, d, W, B, a, s);
  return run<1>(A, X, d, W, B, a, s);
}
