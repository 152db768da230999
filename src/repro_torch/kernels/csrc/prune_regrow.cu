// Threshold prune + gradient regrow (the Alg. 2 apply), on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/prune_regrow.py:
// prune_regrow_flat (body _pr_kernel).  For K rows of N coordinates, with
// row k's thresholds th[k] = (w_th, g_th) chosen outside (kth order
// statistics by sort), elementwise:
//
//     keep   = m > 0  &  |w| >= w_th
//     grown  = m <= 0 &  |g| >= g_th  &  |g| > 0
//     new_m  = keep | grown           (1.0f / 0.0f)
//     new_w  = keep ? w : +0.0        (the reference writes w * keep, which
//                                      XLA folds to this select: a pruned
//                                      -0.0 or negative weight gives +0.0)
//
// The reference's flat form is K = 1; the thresholds stay on the device
// (a (K, 2) tensor read by each block), so no threshold goes through the
// host.
//
// Bound: HBM bytes.  Per coordinate it reads w, g, m and writes new_m and
// new_w (20 B) for about six comparisons — far below the balance point.
// Design: one pass, one coordinate per thread, neighbouring threads on
// neighbouring addresses (coalesced 128 B per warp per stream); grid
// (ceil(N / 256), K), so the ragged tail of each row is masked here and the
// caller pads nothing.  It only compares and selects, so the result equals
// the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_ROWS 65535                   // gridDim.y limit

__global__ void __launch_bounds__(THREADS)
prune_regrow_kernel(const float* __restrict__ w, const float* __restrict__ g,
                    const float* __restrict__ m,
                    const float* __restrict__ th, float* __restrict__ new_m,
                    float* __restrict__ new_w, int n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t row = blockIdx.y;
  const float w_th = th[2 * row], g_th = th[2 * row + 1];
  const int64_t c = row * n + i;
  const float wv = w[c], mv = m[c];
  const float ag = fabsf(g[c]);
  const bool keep = (mv > 0.0f) && (fabsf(wv) >= w_th);
  const bool grown = (mv <= 0.0f) && (ag >= g_th) && (ag > 0.0f);
  new_m[c] = (keep || grown) ? 1.0f : 0.0f;
  new_w[c] = keep ? wv : 0.0f;
}

extern "C" {

int prune_regrow_rows_f32(const void* w, const void* g, const void* m,
                          const void* th, void* new_m, void* new_w, int k,
                          int n, void* stream) {
  if (k < 0 || k > MAX_ROWS || n < 0) return (int)cudaErrorInvalidValue;
  if (k == 0 || n == 0) return 0;
  const int blocks = (int)(((int64_t)n + THREADS - 1) / THREADS);
  prune_regrow_kernel<<<dim3(blocks, k), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<const float*>(th),
      static_cast<float*>(new_m), static_cast<float*>(new_w), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
