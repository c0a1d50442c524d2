// 64 x 64 f32 FFMA output tiles of depth <= 64 with cp.async-staged
// operands, shared by the LDL (ldl_inverse.cu) and sweep (sweep_inverse.cu)
// kernels.
//
// A CTA of 256 threads (16 x 16) computes one tile, each thread a 4 x 4
// block of f32 sums, from two operands staged in shared memory in two
// slices of depth 32 with 16-byte cp.async (4-byte when the edge is not a
// multiple of 4 or a pointer is not 16-byte aligned): the second slice
// lands while the first is used.  Operands are read as float4.  All
// arithmetic is f32 FFMA: no TF32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNb = 64;            // panel width: the depth of the products
constexpr int kTile = 64;          // output tile edge
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kSlice = 32;         // depth of one cp.async stage
constexpr int kLds = kSlice + 4;   // stride of [row][depth] slots: float4
                                   // reads of 8 rows hit 32 banks
constexpr int kLdsKN = kTile + 4;  // stride of [depth][column] slots
constexpr int kSlot = kTile * kLds;  // floats per slot (>= kSlice * kLdsKN)
constexpr int kMaxGridY = 65535;
static_assert(kSlice * kLdsKN <= kSlot, "a [depth][column] slot fits");

__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         int bytes, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? bytes : 0;  // 0: fill the destination with zeros
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + R) x columns [c0, c0 + C) of the row-major block g
// (leading dimension ld) into sm (row stride LD) from its origin; rows >=
// nrows and columns >= ncols (of g) read as zeros.  V floats per copy.
template <int V, int R, int C, int LD>
__device__ __forceinline__ void stage(float* sm, const float* g, int ld,
                                      int r0, int c0, int nrows, int ncols) {
  constexpr int per_row = C / V;
  for (int t = threadIdx.x; t < R * per_row; t += kThreads) {
    const int r = t / per_row, c = (t % per_row) * V;
    const bool ok = r0 + r < nrows && c0 + c < ncols;
    cp_async(sm + r * LD + c,
             ok ? g + static_cast<size_t>(r0 + r) * ld + c0 + c : g, V * 4,
             ok);
  }
}
// Scale column c of the chunks that `stage` (same arguments) gave this
// thread by d[c0 + c]: after cp.async.wait_group they are visible to it.
template <int V, int R, int C, int LD>
__device__ __forceinline__ void scale_cols(float* sm, const float* d, int c0,
                                           int ncols) {
  constexpr int per_row = C / V;
  for (int t = threadIdx.x; t < R * per_row; t += kThreads) {
    const int r = t / per_row, c = (t % per_row) * V;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (c0 + c + v < ncols) sm[r * LD + c + v] *= d[c0 + c + v];
  }
}

// acc[r][c] += sum over the kSlice depths of a slot of
//   As[row r][kk] * Bs[col c][kk]   (NK: B holds rows of the column index)
//   As[row r][kk] * Bs[kk][col c]   (KN: B holds rows of the depth index)
// for rows ty + 16 r and columns tx + 16 c (NK) or 4 tx + c (KN).
template <bool kKN>
__device__ __forceinline__ void mma_slice(float (&acc)[4][4], const float* As,
                                          const float* Bs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int kk = 0; kk < kSlice; kk += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(As + (ty + 16 * r) * kLds + kk);
    if (kKN) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bv[q] =
            *reinterpret_cast<const float4*>(Bs + (kk + q) * kLdsKN + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a4[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] = fmaf(a4[q], bv[q].x, acc[r][0]);
          acc[r][1] = fmaf(a4[q], bv[q].y, acc[r][1]);
          acc[r][2] = fmaf(a4[q], bv[q].z, acc[r][2]);
          acc[r][3] = fmaf(a4[q], bv[q].w, acc[r][3]);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        bv[c] =
            *reinterpret_cast<const float4*>(Bs + (tx + 16 * c) * kLds + kk);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = acc[r][c];
          s = fmaf(av[r].x, bv[c].x, s);
          s = fmaf(av[r].y, bv[c].y, s);
          s = fmaf(av[r].z, bv[c].z, s);
          s = fmaf(av[r].w, bv[c].w, s);
          acc[r][c] = s;
        }
    }
  }
}

__device__ __forceinline__ int out_row(int r) {
  return threadIdx.x / 16 + 16 * r;
}
__device__ __forceinline__ int out_col(bool kn, int c) {
  const int tx = threadIdx.x % 16;
  return kn ? 4 * tx + c : tx + 16 * c;
}

// One 64 x 64 output tile of depth k_valid <= kNb:
//   acc = Ag[rows, :k] . (NK: Bg[cols, :k]^T  |  KN: Bg[:k, cols])
// Ag, Bg point at the tiles' first elements, with leading dimensions lda
// and ldb; an_rows / b_rows / b_cols bound the valid part (the rest reads
// as zeros).  If dscale is given, B's depth index is scaled by it (NK
// only).  The depth comes in two cp.async stages of kSlice, one slot of As
// and Bs each: the second stage lands while the first is used.
template <int V, bool kKN>
__device__ __forceinline__ void tile_gemm(float (&acc)[4][4], float* As,
                                          float* Bs, const float* Ag, int lda,
                                          const float* Bg, int ldb,
                                          int an_rows, int b_rows, int b_cols,
                                          int k_valid, const float* dscale) {
  static_assert(kNb == 2 * kSlice, "the depth is two stages");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* as = As + h * kSlot;
    float* bs = Bs + h * kSlot;
    stage<V, kTile, kSlice, kLds>(as, Ag, lda, 0, h * kSlice, an_rows,
                                  k_valid);
    if (kKN)
      stage<V, kSlice, kTile, kLdsKN>(bs, Bg, ldb, h * kSlice, 0,
                                      min(b_rows, k_valid), b_cols);
    else
      stage<V, kTile, kSlice, kLds>(bs, Bg, ldb, 0, h * kSlice, b_rows,
                                    k_valid);
    cp_async_commit();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    if (dscale)
      scale_cols<V, kTile, kSlice, kLds>(Bs + h * kSlot, dscale, h * kSlice,
                                         k_valid);
    __syncthreads();
    mma_slice<kKN>(acc, As + h * kSlot, Bs + h * kSlot);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
