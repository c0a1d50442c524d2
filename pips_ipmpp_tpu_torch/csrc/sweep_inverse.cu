// Batched blocked symmetric SWEEP inverse for Hopper (sm_90a).
//
// Replaces pips_ipmpp_tpu/linalg/pallas_sweep.py:158 (_sweep_call, the
// Pallas TPU kernel behind sweep_inverse; body _sweep_kernel, panel inverse
// _small_sweep_inv).  For each symmetric quasidefinite A[b] (a x a, row
// major, a even; the wrapper identity-pads an odd a by one) it writes the
// explicit inverse X[b] = A[b]^{-1} and the pivots d[b] of the 2x2 pivot
// blocks (d_2j = a, d_2j+1 = det / a), whose signs give the inertia.
//
// Per panel K of nb = 64 columns (m is the working matrix, m = A at the
// start; the last panel is ragged when a is not a multiple of 64):
//     B = inv(m[K,K])          2x2-pivot Gauss-Jordan, 32 sequential steps
//     W = m[:,K] B
//     m -= W m[:,K]^T          rank-64 update, symmetric: m[:,K] B m[:,K]^T
//     m[K,:] = W^T, m[:,K] = W, m[K,K] = -B
// and after the last panel X = -m.  In exact arithmetic sweeping the
// 16-column panels K1..K4 in turn (the TPU kernel's order) equals one sweep
// on their union, and the 32 steps on consecutive column pairs inside the
// block are the reference's steps, so A^{-1} and d are the same
// quantities, rounded differently.
//
// What bounds it on an H100.  Operations: the symmetric rank-nb update once
// per panel is a^3 flops per matrix (one triangle of 2 a^3), 0.016 ms at
// [64,256,256] and 1.03 ms at [64,1024,1024] at the f32 FFMA peak (67
// TFLOP/s); A in and X out take 0.010 and 0.16 ms.  At the B = 1 roots
// the serial chain of pivot blocks sets the time.
//
// Design: the LDL kernel's (ldl_inverse.cu), one matrix spread over many
// CTAs.  An edge a <= 64 is one launch of part (a), which then writes X.
// Otherwise part (a) runs once on its own for the first panel, and each
// panel is then two launches:
//   pivot  (a)  one CTA inverts a matrix's pivot block with every element
//               in a register, one __syncthreads per 2x2 step (the step's
//               two columns are published through a double buffer in
//               shared memory), and writes its pivots to d and P = -B to
//               scratch;
//   panel  (b)  W = m[:,K] B = -(m[:,K] P) in 64-row tiles, one CTA per
//               (tile, matrix) outside K; the same pass copies the old
//               column panel m[:,K] from its shared-memory stage into the
//               scratch C;
//   update (c)  over the (a/64)(a/64 + 1)/2 lower tiles of the matrix:
//               m -= W C^T, reading the column panel from C, never from X
//               (the tiles of panel K overwrite X[:,K] in other CTAs); a
//               tile off the diagonal also writes its transpose, so X
//               leaves each panel symmetric; the tiles of panel K write
//               W, W^T and -B = P instead.  The CTA of the next panel's
//               pivot block runs part (a) on its new values where they
//               are, in registers, and is launched first, so that the
//               serial chain overlaps the other tiles (P alternates
//               between two buffers).  The last panel writes -m: the
//               final negation costs nothing.
// Parts (b) and (c) are 64 x 64 FFMA tiles of depth 64 with cp.async-staged
// operands (ffma_tile.cuh, the LDL kernel's tiles).  Grids are (tiles x
// batch).  Shared memory holds the two staged slices of both operands
// (36 KB) and the pivot step's two columns, never a full-height panel, so
// no edge a is refused: any a whose A, X and scratch (two P, W, C:
// 2 nb (nb + a) floats per matrix) fit in device memory is taken.  The
// first panel reads A and writes X; later panels work in X.  One writer
// per output element and no atomics.  All arithmetic is f32 FFMA: no TF32
// and no wgmma, matching the TPU kernel's Precision.HIGHEST.  Measured and
// not kept: three launches per panel (the pivot block on its own), blocks
// ordered matrices fastest, the pivot step rounded as the plain version,
// the update over all (a/64)^2 tiles (none mirrored: 1.5x slower at
// a = 1024), and three update CTAs per SM (80 registers, spills).
//
// The sweep has no backward-stability guarantee: on IPM-conditioned
// matrices (diagonal spread 1e-6..1e6) its inverse is O(1) wrong even in
// f64.  ArrowBackend uses it only when asked (sweep_kernel=True).
#include <math.h>

#include "ffma_tile.cuh"

namespace {

// ---- (a) the pivot block ---------------------------------------------------
// Thread (ty, tx) holds element (ty + 16 r, tx + 16 c) of the pw x pw block
// (zeros outside) in m[r][c]; on return m = -B.  Step s pivots on the
// columns j0 = 2 s and j1 = j0 + 1: their owners publish them (the matrix
// is symmetric, so they are also rows j0 and j1) into v, one barrier, then
// every thread applies _small_sweep_inv's update and write-back to its 16
// entries: the plain update on all 16, the write-back's corrections only
// on the threads that hold a pivot row or column.  Each product and sum is
// rounded as the one-CTA version of this kernel (16-column panels in
// shared memory) rounded it: nvcc leaves the mul/add pairs of that step
// to ptxas, which formed FMAs by context, so the pattern its build chose
// is pinned here with __fmaf_rn, __fmul_rn and __fadd_rn.  For a <= 16,
// one 16-column panel, the two versions then give the same bits.  The f32
// sweep solve in chip_smoke.py turns on the last bit of these inverses:
// the plain torch version fails it on the card, and so did this kernel
// with the pattern ptxas chose for it.  The column block jq = j0 / 16 is a
// compile-time index, so m[r][jq] and m[jq][c] are registers.  One barrier
// per step: step s + 1 publishes into the other buffer of v, and no thread
// reaches step s + 2 before all have passed step s + 1's barrier.  Off the
// chain, thread 0 keeps each step's a and det in pd; the pivots d (det / a
// for odd columns) are written after the last step.
__device__ __forceinline__ void pivot_chain(float (&m)[4][4],
                                            float (*v)[2][kNb], float* pd,
                                            int pw, float* __restrict__ db) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int jq = 0; jq < 4; ++jq) {
    for (int jl = 0; jl < 16; jl += 2) {
      const int j0 = 16 * jq + jl, buf = (j0 / 2) & 1;
      if (j0 >= pw) break;
      if (tx == jl || tx == jl + 1) {
        float* col = v[buf][tx - jl];
#pragma unroll
        for (int r = 0; r < 4; ++r) col[ty + 16 * r] = m[r][jq];
      }
      __syncthreads();
      const float* c0 = v[buf][0];
      const float* c1 = v[buf][1];
      const float pa = c0[j0], pb = c0[j0 + 1], pc = c1[j0 + 1];
      // q = -e01; products and sums as the one-CTA version's build
      // contracted them (see above)
      const float det = __fmaf_rn(pa, pc, -__fmul_rn(pb, pb));
      const float idet = __frcp_rn(det);  // = 1.f / det, without a divide
      const float e00 = __fmul_rn(pc, idet), q = __fmul_rn(pb, idet);
      const float e11 = __fmul_rn(pa, idet);
      if (threadIdx.x == 0) {
        pd[j0] = pa;
        pd[j0 + 1] = det;
      }
      float c0k[4], c1k[4], w0i[4], w1i[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        c0k[c] = c0[tx + 16 * c];
        c1k[c] = c1[tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float c0i = c0[ty + 16 * r], c1i = c1[ty + 16 * r];
        w0i[r] = __fmaf_rn(c0i, e00, -__fmul_rn(c1i, q));
        w1i[r] = __fmaf_rn(c1i, e11, -__fmul_rn(c0i, q));
#pragma unroll
        for (int c = 0; c < 4; ++c)
          m[r][c] = __fmaf_rn(-w1i[r], c1k[c],
                              __fmaf_rn(-w0i[r], c0k[c], m[r][c]));
      }
      // write-back: pivot columns <- W (their pivot rows hold -B's 2x2),
      // pivot rows <- W^T outside the pivot columns
      const bool col0 = tx == jl, col1 = tx == jl + 1;
      if (col0 || col1) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool row0 = r == jq && ty == jl, row1 = r == jq && ty == jl + 1;
          m[r][jq] = __fadd_rn(m[r][jq], row0   ? (col0 ? -e00 : q)
                                         : row1 ? (col0 ? q : -e11)
                                                : (col0 ? w0i[r] : w1i[r]));
        }
      }
      if (ty == jl || ty == jl + 1) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c == jq && (col0 || col1)) continue;
          const float w = ty == jl
                              ? __fmaf_rn(c0k[c], e00, -__fmul_rn(c1k[c], q))
                              : __fmaf_rn(c1k[c], e11, -__fmul_rn(c0k[c], q));
          m[jq][c] = __fadd_rn(m[jq][c], w);
        }
      }
    }
  }
  __syncthreads();  // pd is complete
  const int j = threadIdx.x;
  if (j < pw) {
    const float pa = pd[j & ~1];
    db[j] = (j & 1) ? pd[j] / (pa == 0.f ? 1.f : pa) : pa;
  }
}

// One CTA per matrix: the first panel's pivot block, or, for a <= nb, the
// whole inverse.  Writes sign * m (m = -B) to out + blockIdx.x * ldo^2 with
// row stride ldo.
__global__ void __launch_bounds__(kThreads)
    sweep_pivot_kernel(const float* __restrict__ src, float* __restrict__ out,
                       float* __restrict__ d, int a, int ldo, float sign) {
  __shared__ float v[2][2][kNb];  // [buffer][column j0 or j1][row]
  __shared__ float pd[kNb];
  const int pw = min(kNb, a);
  const float* S = src + static_cast<size_t>(blockIdx.x) * a * a;
  float m[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = out_row(r), k = out_col(false, c);
      m[r][c] = (i < pw && k < pw) ? S[static_cast<size_t>(i) * a + k] : 0.f;
    }
  pivot_chain(m, v, pd, pw, d + static_cast<size_t>(blockIdx.x) * a);
  float* O = out + static_cast<size_t>(blockIdx.x) * ldo * ldo;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = out_row(r), k = out_col(false, c);
      if (i < pw && k < pw)
        O[static_cast<size_t>(i) * ldo + k] = sign * m[r][c];
    }
}

// ---- (b) W and the copy of the column panel ---------------------------------
// grid.x: the row tiles other than K's; grid.y walks the batch.  W and C are
// [a, nb] per matrix, P [nb, nb].
template <int V>
__global__ void __launch_bounds__(kThreads)
    sweep_panel_kernel(const float* __restrict__ src,
                       const float* __restrict__ P, float* __restrict__ W,
                       float* __restrict__ C, int B, int a, int k0) {
  __shared__ __align__(16) float As[2 * kSlot];
  __shared__ __align__(16) float Bs[2 * kSlot];
  const int pw = min(kNb, a - k0), tK = k0 / kTile;
  const int t = blockIdx.x;
  const int i0 = (t < tK ? t : t + 1) * kTile;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const size_t off = static_cast<size_t>(b) * a * a;
    const size_t offw = static_cast<size_t>(b) * a * kNb + i0 * kNb;
    float acc[4][4];
    const float* Ag = src + off + static_cast<size_t>(i0) * a + k0;
    tile_gemm<V, true>(acc, As, Bs, Ag, a,
                       P + static_cast<size_t>(b) * kNb * kNb, kNb, a - i0,
                       pw, pw, pw, nullptr);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (i0 + out_row(r) < a)
        *reinterpret_cast<float4*>(W + offw + out_row(r) * kNb +
                                   out_col(true, 0)) =
            make_float4(-acc[r][0], -acc[r][1], -acc[r][2], -acc[r][3]);
    // the old m[i0:, K] is in As (zeros past pw), visible to every thread
    // after tile_gemm's last barrier
    for (int e = threadIdx.x; e < kTile * kNb / 4; e += kThreads) {
      const int r = e / (kNb / 4), c = 4 * (e % (kNb / 4));
      if (i0 + r < a)
        *reinterpret_cast<float4*>(C + offw + r * kNb + c) =
            *reinterpret_cast<const float4*>(As + (c / kSlice) * kSlot +
                                             r * kLds + c % kSlice);
    }
    __syncthreads();  // the slots are restaged for the next matrix
  }
}

// ---- (c) the rank-nb update, the write-back and the next pivot block -------
// The update m -= W C^T = C B C^T is symmetric, and so is every write-back,
// so the grid covers the lower tiles (ti >= tk) only, each CTA writing its
// tile and, off the diagonal, its mirror (tk, ti) through a transpose in
// shared memory: (nt (nt + 1) / 2) tiles x gy matrices.  Every element of X
// is written as sign * (new m), except the next panel's pivot block when
// there is one: the CTA of that (diagonal) tile keeps it in registers, in
// the pivot chain's layout, runs the chain there and writes the next
// panel's Pn and pivots instead.  Those CTAs come first in launch order
// (linear block ids 0..gy-1), so their serial chain overlaps the other
// tiles, which follow in the order of (matrix, tile), so that CTAs running
// together share W and C in L2.  Two CTAs per SM: unbounded, ptxas gives
// this kernel 168 registers, one CTA per SM, and a call at a = 1024 runs
// 1.4x slower; bounded to 128 it spills nothing.
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
    sweep_update_kernel(const float* __restrict__ src,
                        const float* __restrict__ P,
                        const float* __restrict__ W,
                        const float* __restrict__ C, float* __restrict__ X,
                        float* __restrict__ Pn, float* __restrict__ d, int B,
                        int a, int k0, float sign) {
  __shared__ __align__(16) float As[2 * kSlot];
  __shared__ __align__(16) float Bs[2 * kSlot];
  __shared__ float v[2][2][kNb];
  __shared__ float pd[kNb];
  constexpr int kLdt = kTile + 1;  // transpose buffer stride
  static_assert(kTile * kLdt <= 2 * kSlot, "the transpose fits in As");
  const int pw = min(kNb, a - k0);
  const int nt = (a + kTile - 1) / kTile, tK = k0 / kTile;
  const int gy = gridDim.y;
  const int next = k0 + kNb < a ? (tK + 1) * (tK + 2) / 2 + tK + 1 : -1;
  // linear block id -> (lower tile t, first matrix b0): the next pivot
  // blocks first, then every other tile, tiles fastest
  const int n_tiles = nt * (nt + 1) / 2;
  const int l = blockIdx.x + blockIdx.y * gridDim.x;
  int t = l % n_tiles, b0 = l / n_tiles;
  if (next >= 0) {
    const int q = l - gy;
    t = q < 0 ? next : q % (n_tiles - 1);
    t += q >= 0 && t >= next;
    b0 = q < 0 ? l : q / (n_tiles - 1);
  }
  // t = ti (ti + 1) / 2 + tk
  int ti = static_cast<int>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  if ((ti + 1) * (ti + 2) / 2 <= t) ++ti;  // guard sqrt's rounding
  if (ti * (ti + 1) / 2 > t) --ti;
  const int tk = t - ti * (ti + 1) / 2;
  const int i0 = ti * kTile, c0 = tk * kTile;
  const int rows = min(kTile, a - i0), cols = min(kTile, a - c0);
  for (int b = b0; b < B; b += gy) {
    const size_t off = static_cast<size_t>(b) * a * a;
    const float* Wb = W + static_cast<size_t>(b) * a * kNb;
    float* Xo = X + off + static_cast<size_t>(i0) * a + c0;
    if (ti == tK && tk == tK) {
      // m[K,K] = -B = P
      const float* Pb = P + static_cast<size_t>(b) * kNb * kNb;
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile;
        if (r < pw && c < pw)
          Xo[static_cast<size_t>(r) * a + c] = sign * Pb[r * kNb + c];
      }
    } else if (ti == tK || tk == tK) {
      // o: the other tile index; m[o0:, K] = W[o0:, :] and
      // m[K, o0:] = W[o0:, :]^T, the latter through shared memory
      const int o0 = ti == tK ? c0 : i0, on = min(kTile, a - o0);
      float* Xc = X + off + static_cast<size_t>(o0) * a + k0;
      float* Xr = X + off + static_cast<size_t>(k0) * a + o0;
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile;
        const float w =
            r < on ? sign * Wb[static_cast<size_t>(o0 + r) * kNb + c] : 0.f;
        As[r * kLdt + c] = w;
        if (r < on && c < pw) Xc[static_cast<size_t>(r) * a + c] = w;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile;
        if (r < pw && c < on)
          Xr[static_cast<size_t>(r) * a + c] = As[c * kLdt + r];
      }
    } else {
      // m[i, k] -= sum_j W[i, j] C[k, j]
      const float* S = src + off + static_cast<size_t>(i0) * a + c0;
      float acc[4][4], old[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = out_row(r), k = out_col(false, c);
          old[r][c] =
              (i < rows && k < cols) ? S[static_cast<size_t>(i) * a + k] : 0.f;
        }
      const float* Cb = C + static_cast<size_t>(b) * a * kNb;
      tile_gemm<V, false>(acc, As, Bs, Wb + static_cast<size_t>(i0) * kNb, kNb,
                          Cb + static_cast<size_t>(c0) * kNb, kNb, a - i0,
                          a - c0, 0, pw, nullptr);
      if (t == next) {
        // the next pivot block (zeros past its edge: old and acc are)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) old[r][c] -= acc[r][c];
        pivot_chain(old, v, pd, rows, d + static_cast<size_t>(b) * a + i0);
        float* O = Pn + static_cast<size_t>(b) * kNb * kNb;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (out_row(r) < rows && out_col(false, c) < rows)
              O[out_row(r) * kNb + out_col(false, c)] = old[r][c];
      } else {
        const bool mirror = ti != tk;
        if (mirror) __syncthreads();  // every thread is done with As
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = out_row(r), k = out_col(false, c);
            const float x = sign * (old[r][c] - acc[r][c]);
            if (mirror) As[k * kLdt + i] = x;
            if (i < rows && k < cols) Xo[static_cast<size_t>(i) * a + k] = x;
          }
        if (mirror) {
          // m[k, i] = m[i, k]
          __syncthreads();
          float* Xm = X + off + static_cast<size_t>(c0) * a + i0;
          for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
            const int r = e / kTile, c = e % kTile;
            if (r < cols && c < rows)
              Xm[static_cast<size_t>(r) * a + c] = As[r * kLdt + c];
          }
        }
      }
    }
    __syncthreads();  // the slots are restaged for the next matrix
  }
}

template <int V>
int run(const float* A, float* X, float* d, float* work, int B, int a,
        cudaStream_t s) {
  if (a <= kNb) {
    sweep_pivot_kernel<<<B, kThreads, 0, s>>>(A, X, d, a, a, -1.f);
    return static_cast<int>(cudaGetLastError());
  }
  float* P[2] = {work, work + static_cast<size_t>(B) * kNb * kNb};
  float* W = P[1] + static_cast<size_t>(B) * kNb * kNb;
  float* C = W + static_cast<size_t>(B) * a * kNb;
  const int gy = min(B, kMaxGridY);
  const int nt = (a + kTile - 1) / kTile;
  sweep_pivot_kernel<<<B, kThreads, 0, s>>>(A, P[0], d, a, kNb, 1.f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k0 = 0, p = 0; k0 < a; k0 += kNb, p ^= 1) {
    const float* src = k0 == 0 ? A : X;
    sweep_panel_kernel<V><<<dim3(nt - 1, gy), kThreads, 0, s>>>(
        src, P[p], W, C, B, a, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sweep_update_kernel<V><<<dim3(nt * (nt + 1) / 2, gy), kThreads, 0, s>>>(
        src, P[p], W, C, X, P[p ^ 1], d, B, a, k0,
        k0 + kNb >= a ? -1.f : 1.f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// CUDA launches one call makes at edge a: one for a <= 64, else the first
// pivot block and two per panel of 64 columns.
extern "C" int sweep_inverse_launches(int a) {
  if (a <= 0) return 0;
  if (a <= kNb) return 1;
  return 1 + 2 * ((a + kNb - 1) / kNb);
}

// Floats of scratch per matrix at edge a (two P, W and C): none for a <= 64.
extern "C" int sweep_inverse_workspace(int a) {
  return a <= kNb ? 0 : 2 * kNb * (kNb + a);
}

// A, X: [B, a, a] float32 row major on the device, a even; d: [B, a];
// work: B * sweep_inverse_workspace(a) floats of scratch, 16-byte aligned.
// Launches on `stream` and returns the first nonzero cudaGetLastError() of
// its launches, else 0.
extern "C" int sweep_inverse_f32(const float* A, float* X, float* d,
                                 float* work, int B, int a, void* stream) {
  if (B <= 0 || a <= 0) return 0;
  if (a % 2 || (a > kNb && !aligned16(work)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a % 4 == 0 && aligned16(A) && aligned16(X))
    return run<4>(A, X, d, work, B, a, s);
  return run<1>(A, X, d, work, B, a, s);
}
