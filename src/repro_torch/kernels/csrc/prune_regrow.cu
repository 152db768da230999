// Threshold prune + gradient regrow (the Alg. 2 apply), on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/prune_regrow.py:
// prune_regrow_flat (body _pr_kernel).  For K rows of N coordinates, with
// row k's thresholds th[k] = (w_th, g_th) chosen outside (kth order
// statistics by sort), elementwise:
//
//     keep   = m > 0  &  |w| >= w_th
//     grown  = m <= 0 &  |g| >= g_th  &  |g| > 0
//     new_m  = keep | grown           (1 / 0 in m's type)
//     new_w  = keep ? w : +0          (the reference writes w * keep, which
//                                      XLA folds to this select: a pruned
//                                      -0.0 or negative weight gives +0.0)
//
// The reference's flat form is K = 1; the thresholds stay on the device
// (a (K, 2) fp32 tensor read by each block), so no threshold goes through
// the host.
//
// Types, as the Pallas body takes them: w and g of one float type W, m of
// type M, every value widened to fp32 before it is compared (exact for
// every W and M instantiated), new_m written in M and new_w in W.  The
// instantiated (W, M) pairs are (fp32, fp32), the stacked engine's state;
// (fp32, int8) and (bf16, int8), the LM steps' params with int8 masks; and
// (bf16, bf16).  Each is one extern "C" entry.
//
// Bound: HBM bytes.  Per coordinate it reads w, g, m and writes new_m and
// new_w (20 B at (fp32, fp32), 10 B at (bf16, int8)) for about six
// comparisons — far below the balance point.  Design: one pass, one
// coordinate per thread, neighbouring threads on neighbouring addresses
// (coalesced per warp per stream); grid (ceil(N / 256), K), so the ragged
// tail of each row is masked here and the caller pads nothing.  It only
// widens, compares and selects, so the result equals the plain version bit
// for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_ROWS 65535                   // gridDim.y limit

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_bit(bool b);
template <> __device__ __forceinline__ float from_bit<float>(bool b) {
  return b ? 1.0f : 0.0f;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_bit<__nv_bfloat16>(bool b) {
  return __float2bfloat16_rn(b ? 1.0f : 0.0f);
}
template <> __device__ __forceinline__ int8_t from_bit<int8_t>(bool b) {
  return b ? 1 : 0;
}

template <typename W, typename M>
__global__ void __launch_bounds__(THREADS)
prune_regrow_kernel(const W* __restrict__ w, const W* __restrict__ g,
                    const M* __restrict__ m, const float* __restrict__ th,
                    M* __restrict__ new_m, W* __restrict__ new_w, int n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t row = blockIdx.y;
  const float w_th = th[2 * row], g_th = th[2 * row + 1];
  const int64_t c = row * n + i;
  const W wv = w[c];
  const float mv = widen(m[c]);
  const float ag = fabsf(widen(g[c]));
  const bool keep = (mv > 0.0f) && (fabsf(widen(wv)) >= w_th);
  const bool grown = (mv <= 0.0f) && (ag >= g_th) && (ag > 0.0f);
  new_m[c] = from_bit<M>(keep || grown);
  new_w[c] = keep ? wv : from_bit<W>(false);
}

template <typename W, typename M>
static int launch(const void* w, const void* g, const void* m, const void* th,
                  void* new_m, void* new_w, int k, int n, void* stream) {
  if (k < 0 || k > MAX_ROWS || n < 0) return (int)cudaErrorInvalidValue;
  if (k == 0 || n == 0) return 0;
  const int blocks = (int)(((int64_t)n + THREADS - 1) / THREADS);
  prune_regrow_kernel<W, M><<<dim3(blocks, k), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(w), static_cast<const W*>(g),
      static_cast<const M*>(m), static_cast<const float*>(th),
      static_cast<M*>(new_m), static_cast<W*>(new_w), n);
  return (int)cudaGetLastError();
}

extern "C" {

// w, g (K, n) of the entry's weight type, m and new_m (K, n) of its mask
// type, new_w like w, th (K, 2) fp32: contiguous device buffers.
int prune_regrow_rows_f32(const void* w, const void* g, const void* m,
                          const void* th, void* new_m, void* new_w, int k,
                          int n, void* stream) {
  return launch<float, float>(w, g, m, th, new_m, new_w, k, n, stream);
}

int prune_regrow_rows_f32_i8(const void* w, const void* g, const void* m,
                             const void* th, void* new_m, void* new_w, int k,
                             int n, void* stream) {
  return launch<float, int8_t>(w, g, m, th, new_m, new_w, k, n, stream);
}

int prune_regrow_rows_bf16_i8(const void* w, const void* g, const void* m,
                              const void* th, void* new_m, void* new_w, int k,
                              int n, void* stream) {
  return launch<__nv_bfloat16, int8_t>(w, g, m, th, new_m, new_w, k, n,
                                       stream);
}

int prune_regrow_rows_bf16(const void* w, const void* g, const void* m,
                           const void* th, void* new_m, void* new_w, int k,
                           int n, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(w, g, m, th, new_m, new_w, k, n,
                                              stream);
}

}  // extern "C"
