// Batched sliced-ELL sparse x dense product for Hopper (sm_90a), with a
// diagonal epilogue.
//
// Replaces pips_ipmpp_tpu/linalg/pallas_spmv.py::tiled_spmv (the Pallas TPU
// kernel behind the sparse leaf's products) and the ELL gathers of
// pips_ipmpp_tpu/core/sparse.py (ell_mv, ell_mv_multi, ell_sq_diag).  For N
// blocks of an m x n ELL matrix M and X [N, n, c] (c last, row major) it
// writes
//
//     Y[b, r, :] = alpha[b, r] * (sum_k val * X[b, col, :]) + beta[b, r] * Z[b, r, :]
//
// with alpha, beta [N, m] and Z [N, m, c] optional (absent alpha or beta is
// 1, absent Z adds nothing).  The epilogue is a rounded multiply and then a
// rounded add (__fmul_rn, __fadd_rn: no FMA contraction), so it gives what
// the separate elementwise operations give on the same product, bit for
// bit.  Transpose products use the explicitly stored transpose (Bt, Dt),
// never a scatter.  The Jacobi diagonal diag(M E^-1 M') is this kernel on
// the squared values with X = E^-1 (c = 1).
//
// Layout: sliced ELL (SELL-C-sigma, Kreutzer et al., SIAM J. Sci. Comput.
// 36(5), 2014), built once per operator by linalg/spmv.py::sell_from_ell.
// Within each block the rows are sorted by nonzero count inside windows of
// sigma rows and cut into slices of kC = 32 rows; slice g stores K_g =
// slice_k[g] slots per row (its longest row's count), K-major from
// slice_ptr[g]: slot k of row i at slice_ptr[g] + k*kC + i.  row[g*kC + i] is
// the row's index in its block (-1 past the block's end): each output row
// has one writer, no atomics, and the result does not depend on the
// schedule.  A row's nonzeros keep their stored order and are summed in
// that order (k = 0..K_g-1, one FMA each); the slots past a row's own count
// hold val 0, col 0.
//
// Mapping: one thread per (row, 16-byte chunk of the row's c values):
// float4 in f32, double2 in f64 when c is a multiple of the chunk and X, Y,
// Z are 16-byte aligned, else one value per thread.  The chunk is the
// fastest index, so the threads of a row read its val/col together (one
// broadcast) and the row's X gathers and Y stores are contiguous.  A CTA
// covers whole slices (one at c = 24 f32: 32 x 6 = 192 threads, every lane
// busy; eight at c = 1); rows wider than 16 chunks loop over them.  Every
// row of a slice runs the same K_g, so the slot loop does not diverge; it
// runs in rounds of U slots whose val, col and X loads are all in flight
// before their FMAs: U = 16 at one value per thread (a row of ~10
// nonzeros is one round, two dependent loads deep), U = 4 for 16-byte
// chunks (more rounds, but fewer registers and more threads in flight; 8
// was 10-13% slower at c = 24).  A slice's offset and slot count are one
// broadcast address for its threads, read before the loop; the row index
// is read then too but waited for only at the store; the block index is
// one 32-bit division per thread.  val/col/X go through the read-only path
// (__ldg); X stays in L2 (one block's X is 0.8 MB at n = 8192, c = 24).
//
// What bounds it: bytes.  Every nonzero is read once (val + col, 8 B in f32
// and 12 B in f64), X and Y once each.  At the 8 x 8192 sparse instance
// (M = [B; D] and its transpose, 655,360 nonzeros, c = 24 f32) that is
// 5.2 MB of entries + 6.3 MB of X + 6.3 MB of Y, ~5.3 us at 3.35 TB/s.  The
// padded K-major layout it replaces stored 2.16M slots for those 655,360
// nonzeros in the transpose (K = 33); the slices store ~1.12 slots per
// nonzero.  Below that bound sits the gather itself: each X row crosses
// from L2 to the SMs once per nonzero that names it, nnz * c values (63 MB
// at c = 24 f32, ten times X), so at c > 1 the kernel runs at the rate L2
// delivers gathers, not at HBM's (PERF.md, section 6).  At c = 1 it is latency
// bound: 65,536 threads, three dependent loads deep.  Tensor cores, TMA
// and wgmma do not fit a gather of ~10 nonzeros per row.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 32;               // rows per slice
constexpr int kCtaTarget = 256;      // threads a CTA aims for
constexpr int kMaxRowThreads = 16;   // threads per row (chunks beyond loop)
constexpr int kMaxThreads = kC * kMaxRowThreads;
constexpr int kUnroll = 4;           // slots in flight per thread, c > 1
constexpr int kUnrollScalar = 16;    // the same, one value per thread

template <typename T, int V> struct Pack;
template <> struct Pack<float, 1> { using type = float; };
template <> struct Pack<double, 1> { using type = double; };
template <> struct Pack<float, 4> { using type = float4; };
template <> struct Pack<double, 2> { using type = double2; };

__device__ __forceinline__ void unpack(float v, float* o) { o[0] = v; }
__device__ __forceinline__ void unpack(double v, double* o) { o[0] = v; }
__device__ __forceinline__ void unpack(float4 v, float* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void unpack(double2 v, double* o) {
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void pack(const float* i, float* v) { *v = i[0]; }
__device__ __forceinline__ void pack(const double* i, double* v) { *v = i[0]; }
__device__ __forceinline__ void pack(const float* i, float4* v) {
  *v = make_float4(i[0], i[1], i[2], i[3]);
}
__device__ __forceinline__ void pack(const double* i, double2* v) {
  *v = make_double2(i[0], i[1]);
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// V values per thread, U slots per round; tpr threads per row, spc slices
// per CTA (blockDim.x = spc * kC * tpr).
template <typename T, int V, int U>
__global__ void __launch_bounds__(kMaxThreads)
    sell_spmm_kernel(const T* __restrict__ val, const int* __restrict__ col,
                     const int64_t* __restrict__ slice_ptr,
                     const int* __restrict__ slice_k,
                     const int* __restrict__ row, const T* __restrict__ x,
                     T* __restrict__ y, const T* __restrict__ alpha,
                     const T* __restrict__ beta, const T* __restrict__ z,
                     int S, int m, int n, int c, int slices, int tpr,
                     int spc) {
  using P = typename Pack<T, V>::type;
  const int t = threadIdx.x;
  const int rr = t / tpr;              // row of the CTA
  const int jl = t - rr * tpr;         // first chunk of the row
  const int g = blockIdx.x * spc + rr / kC;
  const int i = rr % kC;
  if (g >= slices) return;
  // the slice's offsets: one address per slice, broadcast to its threads
  const int64_t p0 = __ldg(slice_ptr + g) + i;
  const int K = __ldg(slice_k + g);
  // the output row is needed only at the store: nothing waits for it
  const int orow = __ldg(row + static_cast<int64_t>(g) * kC + i);
  const int64_t b = g / S;
  const T* __restrict__ xb = x + b * n * static_cast<int64_t>(c);
  const int nch = c / V;
  for (int j = jl; j < nch; j += tpr) {
    const int off = j * V;
    T acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = T(0);
    for (int k = 0; k < K; k += U) {
      // U slots' val, col and X loads in flight, then their FMAs in slot
      // order.  Slots past K re-read slot K-1 (the same lines, no branch
      // around a load) and add nothing.
      T v[U];
      int cc[U];
      P xp[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t e =
            p0 + static_cast<int64_t>(min(k + u, K - 1)) * kC;
        v[u] = __ldg(val + e);
        cc[u] = __ldg(col + e);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        xp[u] = __ldg(reinterpret_cast<const P*>(
            xb + static_cast<int64_t>(cc[u]) * c + off));
#pragma unroll
      for (int u = 0; u < U; ++u) {
        T xv[V];
        unpack(xp[u], xv);
        const bool on = k + u < K;
#pragma unroll
        for (int q = 0; q < V; ++q)
          acc[q] = on ? fma_t(v[u], xv[q], acc[q]) : acc[q];
      }
    }
    if (orow < 0) continue;            // past the block's last row
    const int64_t yr = b * m + orow;   // output row, flat
    if (alpha != nullptr) {
      const T a = __ldg(alpha + yr);
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = mul_rn(a, acc[q]);
    }
    if (z != nullptr) {
      T zv[V];
      unpack(__ldg(reinterpret_cast<const P*>(z + yr * c + off)), zv);
      if (beta != nullptr) {
        const T bb = __ldg(beta + yr);
#pragma unroll
        for (int q = 0; q < V; ++q) zv[q] = mul_rn(bb, zv[q]);
      }
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = add_rn(acc[q], zv[q]);
    }
    P out;
    pack(acc, &out);
    *reinterpret_cast<P*>(y + yr * c + off) = out;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int V>
int launch_v(const T* val, const int* col, const int64_t* slice_ptr,
             const int* slice_k, const int* row, const T* x, T* y,
             const T* alpha, const T* beta, const T* z, int N, int S, int m,
             int n, int c, cudaStream_t s) {
  const int64_t slices = static_cast<int64_t>(N) * S;
  if (slices > INT32_MAX / kC) return static_cast<int>(cudaErrorInvalidValue);
  const int nch = c / V;
  const int tpr = nch < kMaxRowThreads ? nch : kMaxRowThreads;
  int spc = kCtaTarget / (kC * tpr);
  if (spc < 1) spc = 1;
  const int threads = spc * kC * tpr;
  const int64_t grid = (slices + spc - 1) / spc;
  constexpr int U = V == 1 ? kUnrollScalar : kUnroll;
  sell_spmm_kernel<T, V, U><<<static_cast<unsigned>(grid), threads, 0, s>>>(
      val, col, slice_ptr, slice_k, row, x, y, alpha, beta, z, S, m, n, c,
      static_cast<int>(slices), tpr, spc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* val, const int* col, const int64_t* slice_ptr,
           const int* slice_k, const int* row, const T* x, T* y,
           const T* alpha, const T* beta, const T* z, int N, int S, int m,
           int n, int c, void* stream) {
  if (N <= 0 || S <= 0 || m <= 0 || c <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int W = 16 / sizeof(T);
  const bool vec = c % W == 0 && aligned16(x) && aligned16(y) &&
                   (z == nullptr || aligned16(z));
  if (vec)
    return launch_v<T, W>(val, col, slice_ptr, slice_k, row, x, y, alpha,
                          beta, z, N, S, m, n, c, s);
  return launch_v<T, 1>(val, col, slice_ptr, slice_k, row, x, y, alpha, beta,
                        z, N, S, m, n, c, s);
}

}  // namespace

// val/col: the sliced slots; slice_ptr [N*S + 1] int64, slice_k [N*S] and
// row [N*S*32] int32 (linalg/spmv.py::SellEll); x [N, n, c], y [N, m, c],
// alpha/beta [N, m] and z [N, m, c] (each of these three may be null), all
// contiguous on the device.  Column ids must lie in [0, n).  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ell_spmm_f32(const float* val, const int* col,
                            const int64_t* slice_ptr, const int* slice_k,
                            const int* row, const float* x, float* y,
                            const float* alpha, const float* beta,
                            const float* z, int N, int S, int m, int n, int c,
                            void* stream) {
  return launch<float>(val, col, slice_ptr, slice_k, row, x, y, alpha, beta,
                       z, N, S, m, n, c, stream);
}

extern "C" int ell_spmm_f64(const double* val, const int* col,
                            const int64_t* slice_ptr, const int* slice_k,
                            const int* row, const double* x, double* y,
                            const double* alpha, const double* beta,
                            const double* z, int N, int S, int m, int n,
                            int c, void* stream) {
  return launch<double>(val, col, slice_ptr, slice_k, row, x, y, alpha, beta,
                        z, N, S, m, n, c, stream);
}
