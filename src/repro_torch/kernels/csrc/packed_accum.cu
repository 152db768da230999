// Fused bitmap-expand + accumulate of packed payloads, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/packed_accum.py:
// packed_accum_flat (one payload) and packed_accum_rows (K payloads, one
// per accumulator row, in one launch; body _packed_accum_kernel).  The flat
// entry points are the K=1 case of the row kernels: blockIdx.y is the row,
// and every operand of row k starts at k times its row stride.  For a
// payload held as a little-endian bitmap (bit c%32 of word c/32 is
// coordinate c) and its nnz values in coordinate order, in place:
//
//     num[c] += alpha * (bit(c) ? values[rank(c)] : 0)
//     den[c] += bit(c)
//
// rank(c) = offsets[b] + popcount of the set bits before c in its
// 1024-coordinate block b; offsets is the exclusive prefix of the per-block
// popcounts, which block_popcount_kernel computes on the device (the
// reference did this on the host).
//
// Bound: HBM bytes.  Per coordinate it reads and writes num and den (16 B),
// reads 1/8 B of bitmap and, where the bit is set, one value — a handful of
// integer ops per coordinate, far below the balance point.  Design: one
// pass with no dense intermediate (the payload is never densified in HBM);
// a 1024-thread block covers one block of 32 words, each warp expands one
// word, and the ranks come from __popc plus a 32-entry warp scan in shared
// memory, so blocks are independent and need no second pass; values are
// read only where a bit is set, so they need no padding; the ragged last
// block is masked here, so the caller pads nothing either.
//
// Rows (packed_accum_rows_*): num, den are (K, n); words (K, n_words);
// values (K, vstride) with row k's values left-aligned; offsets (K,
// n_blocks) per-row prefixes.  Each row's ragged tail is masked here, so the
// caller pads neither n to whole blocks nor the values by a block.
//
// Parity: the multiply and the add are separately rounded (__fmul_rn,
// __fadd_rn — no FMA contraction), the same arithmetic as the plain
// version, so results equal it bit for bit for every alpha.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

#define BLOCK_N 1024
#define WORDS_PER_BLOCK (BLOCK_N / 32)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// One warp per 1024-coordinate block of row blockIdx.y: counts[row, b] =
// set bits in its 32 words.
__global__ void block_popcount_kernel(const uint32_t* __restrict__ words,
                                      int32_t* __restrict__ counts,
                                      int n_words, int n_blocks) {
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= n_blocks) return;             // whole warp leaves together
  words += (int64_t)blockIdx.y * n_words;
  counts += (int64_t)blockIdx.y * n_blocks;
  const int64_t wi = b * WORDS_PER_BLOCK + lane;
  int c = wi < n_words ? __popc(words[wi]) : 0;
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xffffffffu, c, d);
  if (lane == 0) counts[b] = c;
}

template <typename V>
__global__ void __launch_bounds__(BLOCK_N)
packed_accum_kernel(float* __restrict__ num, float* __restrict__ den,
                    const uint32_t* __restrict__ words,
                    const V* __restrict__ values,
                    const int32_t* __restrict__ offsets, float alpha, int n,
                    int n_words, int vstride) {
  __shared__ int warp_before[WORDS_PER_BLOCK];
  const int b = blockIdx.x;
  const int64_t row = blockIdx.y;
  num += row * n;
  den += row * n;
  words += row * n_words;
  values += row * vstride;
  offsets += row * gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t wi = (int64_t)b * WORDS_PER_BLOCK + warp;
  const uint32_t word = wi < n_words ? words[wi] : 0u;
  if (lane == 0) warp_before[warp] = __popc(word);
  __syncthreads();
  if (warp == 0) {                       // exclusive scan of 32 word counts
    const int own = warp_before[lane];
    int incl = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    warp_before[lane] = incl - own;
  }
  __syncthreads();
  const int64_t c = (int64_t)b * BLOCK_N + threadIdx.x;
  if (c >= n) return;
  const uint32_t bit = (word >> lane) & 1u;
  float v = 0.0f;
  if (bit) {
    const int idx = offsets[b] + warp_before[warp] +
                    __popc(word & ((1u << lane) - 1u));
    // the wrapper has checked that the row's bitmap holds its nnz set bits
    // and nnz <= vstride; this guard only keeps a malformed payload's reads
    // inside the row
    if (idx < vstride) v = to_f32(values[idx]);
  }
  num[c] = __fadd_rn(num[c], __fmul_rn(alpha, v));
  den[c] = __fadd_rn(den[c], bit ? 1.0f : 0.0f);
}

#define MAX_ROWS 65535                   // gridDim.y limit

template <typename V>
static int launch_accum(void* num, void* den, const void* words,
                        const void* values, const void* offsets, float alpha,
                        int k, int n, int n_words, int vstride, void* stream) {
  if (k < 0 || k > MAX_ROWS || n < 0 || n_words < (n + 31) / 32 ||
      vstride < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || k == 0) return 0;
  const int n_blocks = (n + BLOCK_N - 1) / BLOCK_N;
  packed_accum_kernel<V><<<dim3(n_blocks, k), BLOCK_N, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(num), static_cast<float*>(den),
      static_cast<const uint32_t*>(words), static_cast<const V*>(values),
      static_cast<const int32_t*>(offsets), alpha, n, n_words, vstride);
  return (int)cudaGetLastError();
}

extern "C" {

int block_popcount_rows(const void* words, void* counts, int k, int n_words,
                        int n_blocks, void* stream) {
  if (k < 0 || k > MAX_ROWS || n_words < 0 || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0 || k == 0) return 0;
  const int threads = 256;                        // 8 warps = 8 blocks of coords
  const int64_t grid = ((int64_t)n_blocks * 32 + threads - 1) / threads;
  block_popcount_kernel<<<dim3((unsigned)grid, k), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(counts),
      n_words, n_blocks);
  return (int)cudaGetLastError();
}

int block_popcount(const void* words, void* counts, int n_words,
                   int n_blocks, void* stream) {
  return block_popcount_rows(words, counts, 1, n_words, n_blocks, stream);
}

int packed_accum_f32(void* num, void* den, const void* words,
                     const void* values, const void* offsets, float alpha,
                     int n, int n_words, int nnz, void* stream) {
  return launch_accum<float>(num, den, words, values, offsets, alpha, 1, n,
                             n_words, nnz, stream);
}

int packed_accum_f16(void* num, void* den, const void* words,
                     const void* values, const void* offsets, float alpha,
                     int n, int n_words, int nnz, void* stream) {
  return launch_accum<__half>(num, den, words, values, offsets, alpha, 1, n,
                              n_words, nnz, stream);
}

int packed_accum_rows_f32(void* num, void* den, const void* words,
                          const void* values, const void* offsets,
                          float alpha, int k, int n, int n_words, int vstride,
                          void* stream) {
  return launch_accum<float>(num, den, words, values, offsets, alpha, k, n,
                             n_words, vstride, stream);
}

}  // extern "C"
