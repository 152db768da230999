// Intersection-weighted gossip average for one receiver, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/gossip_avg.py:gossip_avg_flat
// (body _gossip_kernel).  For J received models, self first:
//
//     out[i] = (sum_j W[j][i]) / max(sum_j M[j][i], 1) * own[i]
//
// The inputs are already masked (W[j] == W[j] * M[j], which masked SGD,
// evolve and the packed decode all keep), as the Pallas kernel assumes too.
//
// Bound: HBM bytes.  Per coordinate it reads 2J+1 values and writes one, and
// does about 2J+2 flops, far below the card's ~20 flops/byte balance point.
// Design for that: one pass, nothing materialised in between (num and den
// live in registers); each thread owns one coordinate of a grid-stride loop,
// so a warp reads 128 contiguous bytes per row; and the J rows are passed as
// a by-value array of row pointers, so the caller never copies its rows
// into a (J, N) stack before the launch.
//
// Parity: j runs 0..J-1 in stack order with fp32 adds, the same order as
// the reference's gossip_average_one loop, and the divide is IEEE
// (__fdiv_rn), so fp32 results equal the reference bit for bit.  bf16 rows
// are accumulated in fp32 and rounded to nearest even on store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define GOSSIP_MAX_J 32
#define GOSSIP_THREADS 256

template <typename T>
struct Rows {
  const T* p[GOSSIP_MAX_J];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void gossip_avg_kernel(Rows<T> w, Rows<T> m, int J,
                                  const T* __restrict__ own,
                                  T* __restrict__ out, int n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float num = to_f32(w.p[0][i]);
    float den = to_f32(m.p[0][i]);
    for (int j = 1; j < J; ++j) {
      num = __fadd_rn(num, to_f32(w.p[j][i]));
      den = __fadd_rn(den, to_f32(m.p[j][i]));
    }
    den = fmaxf(den, 1.0f);
    store(out + i, __fmul_rn(__fdiv_rn(num, den), to_f32(own[i])));
  }
}

template <typename T>
static int launch(const void* const* w_ptrs, const void* const* m_ptrs,
                  int J, const void* own, void* out, int n, void* stream) {
  if (J < 1 || J > GOSSIP_MAX_J || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Rows<T> w, m;
  for (int j = 0; j < J; ++j) {
    w.p[j] = static_cast<const T*>(w_ptrs[j]);
    m.p[j] = static_cast<const T*>(m_ptrs[j]);
  }
  int64_t blocks = ((int64_t)n + GOSSIP_THREADS - 1) / GOSSIP_THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond ~64 blocks/SM
  gossip_avg_kernel<T><<<(unsigned)blocks, GOSSIP_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      w, m, J, static_cast<const T*>(own), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" {

// w_ptrs, m_ptrs: host arrays of J device pointers, each to n elements.
int gossip_avg_f32(const void* const* w_ptrs, const void* const* m_ptrs,
                   int J, const void* own, void* out, int n, void* stream) {
  return launch<float>(w_ptrs, m_ptrs, J, own, out, n, stream);
}

int gossip_avg_bf16(const void* const* w_ptrs, const void* const* m_ptrs,
                    int J, const void* own, void* out, int n, void* stream) {
  return launch<__nv_bfloat16>(w_ptrs, m_ptrs, J, own, out, n, stream);
}

}  // extern "C"
