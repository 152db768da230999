// Block-sparse masked matmul for U users in one launch, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/masked_matmul.py:
// batched_masked_matmul (body _bmm_kernel) and, as its U=1 form,
// masked_matmul (body _mm_kernel).  For every user u:
//
//     y[u] = x[u] @ (w[u] * m[u])        x (U, M, K), w and m (U, K, N), fp32
//
// with fp32 accumulation.  A (MMK_BK, MMK_BN) weight tile whose mask is all
// zero contributes nothing and is skipped.
//
// Bound: HBM bytes at the serving shapes.  M is the rows of one request
// (1-16) while K and N are 32-128, so each weight and mask element feeds M
// FMAs: about M/4 flops per byte of w and m, far below the card's ~20
// flops/byte fp32 balance point.  Design for that:
//  * one CTA per (user, 32-column tile, 16-row tile) holds every row of a
//    request, so each w and m element is read from HBM once and a warp
//    reads 128 contiguous bytes of a weight row (no host padding: ragged
//    M, K and N edges are masked in the loads and the store);
//  * the per-user block mask is made on the device, in the K loop: the
//    CTA reads its (MMK_BK, MMK_BN) mask tile first and __syncthreads_or
//    says whether any element is set; an empty tile skips the weight and
//    x reads and the FMAs.  So an empty tile costs its mask bytes only;
//  * w*m is formed once per element in shared memory and every row of x
//    reuses it from there.
//
// Parity: each output is one fp32 FMA chain in ascending k over
// __fmul_rn(w, m), so a user's rows depend only on that user's operands:
// a user's output in a mixed batch is bit-equal to the same user served
// alone.  Against torch.matmul (cuBLAS, another summation order) it agrees
// to fp32 rounding.  No TF32 and no tensor cores: fp32 FMA on the CUDA
// cores keeps the fp32 tolerance against the reference.
#include <cuda_runtime.h>
#include <stdint.h>

#define MMK_BM 16        // rows of x per CTA
#define MMK_BN 32        // output columns per CTA (one per lane)
#define MMK_BK 32        // depth of one staged tile
#define MMK_WARPS 4
#define MMK_THREADS (32 * MMK_WARPS)
#define MMK_ROWS_PER_WARP (MMK_BM / MMK_WARPS)
#define MMK_KS_PER_WARP (MMK_BK / MMK_WARPS)

__global__ void __launch_bounds__(MMK_THREADS)
masked_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ m, float* __restrict__ y,
                     int M, int K, int N) {
  __shared__ float xs[MMK_BM][MMK_BK];
  __shared__ float ws[MMK_BK][MMK_BN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t u = blockIdx.z;
  const int m0 = blockIdx.y * MMK_BM;
  const int col = blockIdx.x * MMK_BN + lane;
  const bool col_ok = col < N;
  const int rows = min(MMK_BM, M - m0);

  const float* xu = x + u * M * K + (int64_t)m0 * K;
  const float* wu = w + u * K * N;
  const float* mu = m + u * K * N;

  float acc[MMK_ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < MMK_ROWS_PER_WARP; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += MMK_BK) {
    // the mask tile: rows k0 + warp + MMK_WARPS*i, this lane's column
    float mv[MMK_KS_PER_WARP];
    int any = 0;
#pragma unroll
    for (int i = 0; i < MMK_KS_PER_WARP; ++i) {
      const int k = k0 + warp + MMK_WARPS * i;
      mv[i] = (col_ok && k < K) ? mu[(int64_t)k * N + col] : 0.0f;
      any |= (mv[i] != 0.0f);
    }
    if (!__syncthreads_or(any)) continue;   // empty tile: uniform skip

#pragma unroll
    for (int i = 0; i < MMK_KS_PER_WARP; ++i) {
      const int kk = warp + MMK_WARPS * i;
      const int k = k0 + kk;
      const float wv = (col_ok && k < K) ? wu[(int64_t)k * N + col] : 0.0f;
      ws[kk][lane] = __fmul_rn(wv, mv[i]);
    }
#pragma unroll
    for (int i = 0; i < MMK_ROWS_PER_WARP; ++i) {
      const int r = warp + MMK_WARPS * i;
      const int k = k0 + lane;
      xs[r][lane] = (r < rows && k < K) ? xu[(int64_t)r * K + k] : 0.0f;
    }
    __syncthreads();

    const int kmax = min(MMK_BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float wv = ws[kk][lane];
#pragma unroll
      for (int i = 0; i < MMK_ROWS_PER_WARP; ++i)
        acc[i] = __fmaf_rn(xs[warp + MMK_WARPS * i][kk], wv, acc[i]);
    }
    __syncthreads();
  }

  if (!col_ok) return;
  float* yu = y + (u * M + m0) * (int64_t)N;
#pragma unroll
  for (int i = 0; i < MMK_ROWS_PER_WARP; ++i) {
    const int r = warp + MMK_WARPS * i;
    if (r < rows) yu[(int64_t)r * N + col] = acc[i];
  }
}

extern "C" {

// x (U, M, K), w and m (U, K, N), y (U, M, N): contiguous fp32 device
// buffers.  Launches on `stream`; returns the cudaError_t of the launch.
int batched_masked_matmul_f32(const void* x, const void* w, const void* m,
                              void* y, int U, int M, int K, int N,
                              void* stream) {
  if (U < 0 || M < 0 || K < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (U == 0 || M == 0 || N == 0) return 0;
  const unsigned n_tiles = (unsigned)((N + MMK_BN - 1) / MMK_BN);
  const unsigned m_tiles = (unsigned)((M + MMK_BM - 1) / MMK_BM);
  if (m_tiles > 65535u || (unsigned)U > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid(n_tiles, m_tiles, (unsigned)U);
  masked_matmul_kernel<<<grid, MMK_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(m), static_cast<float*>(y), M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
