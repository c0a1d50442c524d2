// Batched ELL sparse x dense product for Hopper (sm_90a).
//
// Replaces pips_ipmpp_tpu/linalg/pallas_spmv.py::tiled_spmv (the Pallas TPU
// kernel behind the sparse leaf's products) and the ELL gathers of
// pips_ipmpp_tpu/core/sparse.py (ell_mv, ell_mv_multi, ell_sq_diag).  For N
// blocks with val/col [N, m, K] and X [N, n, c] (c last, row major) it
// writes
//
//     Y[b, r, j] = sum_k val[b, r, k] * X[b, col[b, r, k], j]    Y [N, m, c].
//
// Padded entries carry val 0 and col 0, so nothing is masked.  Transpose
// products use the explicitly stored transpose (Bt, Dt), never a scatter: each
// output row has one writer, no atomics, and the result does not depend on
// the schedule.  The Jacobi diagonal diag(M E^-1 M') is this kernel on the
// squared values with X = E^-1 (c = 1).
//
// Layout.  val and col are stored K-major: slot k of all m rows of a block is
// contiguous, element (b, r, k) at b*m*K + k*m + r (a transposed copy the
// caller builds once).
//   c == 1: one thread per output row, so neighbouring threads (rows) read
//           neighbouring addresses for every k.
//   c > 1:  one warp per output row, lanes over the c right-hand sides (32 at
//           a time).  Lane k first loads slot k of the row (val and col, 32
//           slots at a time; the 8 warps of a CTA are 8 neighbouring rows,
//           so each slot's loads share their sectors); the products then
//           take each slot from its lane by shuffle, so the X loads of
//           successive slots depend on no memory read and are in flight
//           together.  X rows are c contiguous values.  Slots are summed in
//           order k = 0..K-1.
// The TPU kernel's 128x128 tiles and 128-lane passes answer the TPU's
// in-register gather; on Hopper the gather is an ordinary load and the tiles
// are not needed.
//
// What bounds it.  Bytes: every stored entry is read once (val + col, 8 B in
// f32 and 12 B in f64), X and Y once each.  At the 8 x 8192 sparse instance
// (merged [B; D]: [8, 8192, 10], c = 24, f32) that is 5.2 MB of entries +
// 6.3 MB of X + 6.3 MB of Y, ~18 MB, ~5 us at 3.35 TB/s: one launch's
// overhead is of the same size, so the number of launches per CG iteration
// matters more than this body.  The gathered X rows hit L2 (one block's X
// is 0.8 MB).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ell_spmv_kernel(const T* __restrict__ val, const int* __restrict__ col,
                    const T* __restrict__ x, T* __restrict__ y, int m, int K,
                    int n, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int64_t b = row / m, r = row - b * m;
  const T* xb = x + b * n;
  const int64_t base = b * m * K + r;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t e = base + static_cast<int64_t>(k) * m;
    acc = fma_t(val[e], xb[col[e]], acc);
  }
  y[row] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ell_spmm_kernel(const T* __restrict__ val, const int* __restrict__ col,
                    const T* __restrict__ x, T* __restrict__ y, int m, int K,
                    int n, int c, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (row >= rows) return;
  const int64_t b = row / m, r = row - b * m;
  const T* xb = x + b * n * static_cast<int64_t>(c);
  T* yr = y + row * c;
  const int64_t base = b * m * K + r;
  for (int j0 = 0; j0 < c; j0 += 32) {
    const int j = j0 + lane;
    const bool on = j < c;
    T acc = T(0);
    for (int k0 = 0; k0 < K; k0 += 32) {
      T v_lane = T(0);
      int c_lane = 0;
      if (k0 + lane < K) {
        const int64_t e = base + static_cast<int64_t>(k0 + lane) * m;
        v_lane = val[e];
        c_lane = col[e];
      }
      const int kn = min(32, K - k0);   // the same on every lane
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const T v = __shfl_sync(0xffffffffu, v_lane, k);
        const int64_t cc = __shfl_sync(0xffffffffu, c_lane, k);
        if (on) acc = fma_t(v, xb[cc * c + j], acc);
      }
    }
    if (on) yr[j] = acc;
  }
}

template <typename T>
int launch(const T* val, const int* col, const T* x, T* y, int N, int m,
           int K, int n, int c, void* stream) {
  const int64_t rows = static_cast<int64_t>(N) * m;
  if (rows <= 0 || c <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 1) {
    const int64_t grid = (rows + kThreads - 1) / kThreads;
    ell_spmv_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        val, col, x, y, m, K, n, rows);
  } else {
    const int64_t per_block = kThreads / 32;
    const int64_t grid = (rows + per_block - 1) / per_block;
    ell_spmm_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        val, col, x, y, m, K, n, c, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// val/col: [N, m, K] stored K-major; x: [N, n, c] and
// y: [N, m, c], contiguous, on the device.  Column ids must lie in [0, n).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ell_spmm_f32(const float* val, const int* col, const float* x,
                            float* y, int N, int m, int K, int n, int c,
                            void* stream) {
  return launch<float>(val, col, x, y, N, m, K, n, c, stream);
}

extern "C" int ell_spmm_f64(const double* val, const int* col,
                            const double* x, double* y, int N, int m, int K,
                            int n, int c, void* stream) {
  return launch<double>(val, col, x, y, N, m, K, n, c, stream);
}
