// Batched blocked symmetric SWEEP inverse for Hopper (sm_90a).
//
// Replaces pips_ipmpp_tpu/linalg/pallas_sweep.py::_sweep_kernel (the Pallas
// TPU kernel behind sweep_inverse; panel inverse _small_sweep_inv).  For each
// symmetric quasidefinite A[b] (a x a, row major, a a multiple of the panel
// width 16; the wrapper identity-pads) it writes the explicit inverse
// X[b] = A[b]^{-1} and the LDL-style pivots d[b] of the 2x2 pivot blocks
// (d_2j = a, d_2j+1 = det / a), whose signs give the inertia.
//
// Per panel K of 16 columns (m is the working matrix, m = A at the start):
//     B = inv(m[K,K])          2x2-pivot Gauss-Jordan, 8 sequential steps
//     W = m[:,K] B
//     m -= W m[:,K]^T          rank-16 update of the full matrix
//     m[K,:] = W^T, m[:,K] = W, m[K,K] = -B
// and after the last panel X = -m.
//
// Design.  It follows the LDL kernel (ldl_inverse.cu): one CTA of 256
// threads per matrix (grid = B), the matrix in global memory (an f32
// 256x256 matrix is 256 KiB, above a CTA's 227 KB of shared memory; the
// flagship batch [64,256,256] is 16 MB and sits in the 50 MB L2), and per
// panel in shared memory: the panel columns m[:,K] (a x 17 floats), W
// (a x 17) and the 16x16 pivot block.  The pivot block's Gauss-Jordan runs
// there with one thread per entry and two barriers per step.  W and the
// rank-16 update of the full matrix are FFMA tiles, 64x64 per pass with a
// 4x4 register tile per thread; the update skips rows and columns of K,
// which the write-back overwrites, so the two share one phase.  The shared
// panel state caps a at sweep_inverse_max_dim() (1701).
// All arithmetic is f32 FFMA: no TF32 and no wgmma, matching the TPU
// kernel's Precision.HIGHEST.
//
// What bounds it.  Operations: the rank-16 update of the full a x a matrix
// once per panel is 2 a^3 flops per matrix, 2.1 GFLOP at [64,256,256], ~32
// us at 67 TFLOP/s f32.  As for the LDL kernel, the pivot chain (a/2 steps
// with barriers) and L2 latency on the update, with 64 of 132 SMs busy,
// keep it well above that bound.
//
// The sweep has no backward-stability guarantee: on IPM-conditioned
// matrices (diagonal spread 1e-6..1e6) its inverse is O(1) wrong even in
// f64.  ArrowBackend uses it only when asked (sweep_kernel=True).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = 16;           // panel width (columns)
constexpr int kLdp = kPanel + 1;     // padded row stride of the panel copies
constexpr int kTile = 64;            // update tile edge: 16x16 threads x 4x4
constexpr int kMaxSmem = 232448;     // bytes a CTA may opt in to on sm_90

__host__ __device__ constexpr size_t smem_bytes(int a) {
  return (2 * static_cast<size_t>(a) * kLdp +
          static_cast<size_t>(kPanel) * kLdp) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
    sweep_inverse_kernel(const float* __restrict__ A, float* __restrict__ X,
                         float* __restrict__ d, int a) {
  extern __shared__ float smem[];
  float* Cs = smem;                                 // [a][kLdp] m[:,K]
  float* Ws = Cs + static_cast<size_t>(a) * kLdp;   // [a][kLdp] W
  float* Ps = Ws + static_cast<size_t>(a) * kLdp;   // [kPanel][kLdp] pivot block

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t off = static_cast<size_t>(blockIdx.x) * a * a;
  const float* Ab = A + off;
  float* Xb = X + off;
  float* db = d + static_cast<size_t>(blockIdx.x) * a;

  const int aa = a * a;
  for (int idx = tid; idx < aa; idx += kThreads) Xb[idx] = Ab[idx];
  __syncthreads();

  for (int k0 = 0; k0 < a; k0 += kPanel) {
    const int k1 = k0 + kPanel;

    // 1. panel columns m[:,K] into shared memory, the pivot block beside
    for (int idx = tid; idx < a * kPanel; idx += kThreads) {
      const int i = idx / kPanel, j = idx % kPanel;
      const float v = Xb[static_cast<size_t>(i) * a + k0 + j];
      Cs[i * kLdp + j] = v;
      if (i >= k0 && i < k1) Ps[(i - k0) * kLdp + j] = v;
    }
    __syncthreads();

    // 2. B = inv(pivot block) by 2x2-pivot Gauss-Jordan (_small_sweep_inv);
    //    thread (ty, tx) owns entry (ty, tx); Ps ends as -B
    for (int s = 0; s < kPanel / 2; ++s) {
      const int j0 = 2 * s, j1 = j0 + 1;
      const float pa = Ps[j0 * kLdp + j0];
      const float pb = Ps[j1 * kLdp + j0];
      const float pc = Ps[j1 * kLdp + j1];
      const float det = pa * pc - pb * pb;
      const float idet = 1.f / det;
      const float e00 = pc * idet, e01 = -pb * idet, e11 = pa * idet;
      const int i = ty, k = tx;
      const float c0i = Ps[i * kLdp + j0], c1i = Ps[i * kLdp + j1];
      const float c0k = Ps[k * kLdp + j0], c1k = Ps[k * kLdp + j1];
      const float w0i = c0i * e00 + c1i * e01, w1i = c0i * e01 + c1i * e11;
      const float w0k = c0k * e00 + c1k * e01, w1k = c0k * e01 + c1k * e11;
      float v = Ps[i * kLdp + k] - w0i * c0k - w1i * c1k;
      // write-back: pivot columns <- W (the pivot rows of which hold -B's
      // 2x2), pivot rows <- W^T outside the pivot columns
      if (k == j0) v += (i == j0) ? -e00 : (i == j1) ? -e01 : w0i;
      else if (k == j1) v += (i == j0) ? -e01 : (i == j1) ? -e11 : w1i;
      else if (i == j0) v += w0k;
      else if (i == j1) v += w1k;
      __syncthreads();
      Ps[i * kLdp + k] = v;
      if (tid == 0) {
        db[k0 + j0] = pa;
        db[k0 + j1] = det / (pa == 0.f ? 1.f : pa);
      }
      __syncthreads();
    }

    // 3. W = m[:,K] B = -(m[:,K] Ps)
    for (int idx = tid; idx < a * kPanel; idx += kThreads) {
      const int i = idx / kPanel, j = idx % kPanel;
      float acc = 0.f;
#pragma unroll
      for (int l = 0; l < kPanel; ++l)
        acc = fmaf(Cs[i * kLdp + l], Ps[l * kLdp + j], acc);
      Ws[i * kLdp + j] = -acc;
    }
    __syncthreads();

    // 4a. m[i,k] -= sum_j W[i,j] m[k,j] outside the rows and columns of K
    const int nt = (a + kTile - 1) / kTile;
    for (int t = 0; t < nt * nt; ++t) {
      const int r0 = (t / nt) * kTile + ty, c0 = (t % nt) * kTile + tx;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int j = 0; j < kPanel; ++j) {
        float wv[4], cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r0 + 16 * r;
          wv[r] = i < a ? Ws[i * kLdp + j] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = c0 + 16 * c;
          cv[c] = k < a ? Cs[k * kLdp + j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wv[r], cv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + 16 * r;
        if (i >= a || (i >= k0 && i < k1)) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = c0 + 16 * c;
          if (k < a && (k < k0 || k >= k1))
            Xb[static_cast<size_t>(i) * a + k] -= acc[r][c];
        }
      }
    }
    // 4b. m[K,:] = W^T, m[:,K] = W, m[K,K] = -B
    for (int idx = tid; idx < a * kPanel; idx += kThreads) {
      const int i = idx / kPanel, j = idx % kPanel;
      const float v = (i >= k0 && i < k1) ? Ps[(i - k0) * kLdp + j]
                                          : Ws[i * kLdp + j];
      Xb[static_cast<size_t>(i) * a + k0 + j] = v;
      if (i < k0 || i >= k1) Xb[static_cast<size_t>(k0 + j) * a + i] = v;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < aa; idx += kThreads) Xb[idx] = -Xb[idx];
}

}  // namespace

// Largest matrix edge whose panel state fits in one CTA's shared memory.
extern "C" int sweep_inverse_max_dim() {
  int a = 1;
  while (smem_bytes(a + 1) <= kMaxSmem) ++a;
  return a;
}

// A, X: [B, a, a] float32 row major on the device, a a multiple of 16;
// d: [B, a].  Launches on `stream` and returns cudaGetLastError().
extern "C" int sweep_inverse_f32(const float* A, float* X, float* d, int B,
                                 int a, void* stream) {
  if (B <= 0 || a <= 0) return 0;
  if (a % kPanel) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_inverse_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(A, X, d, a);
  return static_cast<int>(cudaGetLastError());
}
