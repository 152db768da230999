// Fused bitmap-expand + accumulate of packed payloads, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/packed_accum.py:
// packed_accum_flat (one payload) and packed_accum_rows (K payloads, one
// per accumulator row, in one launch; body _packed_accum_kernel).  The flat
// entry points are the K=1 case of the row kernels: every operand of row k
// starts at k times its row stride.  For a payload held as a little-endian
// bitmap (bit c%32 of word c/32 is coordinate c) and its nnz values in
// coordinate order, in place:
//
//     num[c] += alpha * (bit(c) ? values[rank(c)] : 0)
//     den[c] += bit(c)
//
// rank(c) = offsets[g] + the set bits before c in its 128-coordinate group
// g; offsets is the exclusive prefix of the per-group popcounts along the
// row (the reference built its block offsets on the host).
//
// Two launches per fold, with the wrapper's one read-back between them:
//  * packed_scan_rows: a block of 256 threads takes 256 groups of a row,
//    one per thread: it popcounts the group's 4 words, scans the counts in
//    registers and shared memory, and finds the block's row prefix by a
//    decoupled look-back over the row's earlier blocks (one warp reads 32
//    of their status words at a time).  The block's index is an atomic
//    ticket, not blockIdx (CUDA does not schedule blocks in order), so a
//    block only ever waits on blocks that are already running.  Each block
//    publishes (flag, value) as one 64-bit store tagged with the launch's
//    epoch, so status words left by earlier launches read as "not yet" and
//    need no reset; the block that draws the last ticket resets the
//    ticket.  It writes the group offsets, and the row's last block writes
//    the row's total set bits and whether they disagree with the row's
//    value count, so the wrapper can refuse a malformed payload before
//    anything is folded.
//  * packed_accum_kernel: streams num and den.  A warp owns one 128-
//    coordinate group, a thread four coordinates: it issues its 128-bit
//    num/den loads first, then its word and the group's offset, ranks its
//    bits within the group by warp shuffles (no shared memory, no barrier),
//    and only then gathers its held values.  A row that is not 16-byte
//    aligned, and the ragged last group, take 4-byte loads instead (lane l
//    takes bit l of each word, so each warp access is one 128-byte row),
//    masked in the kernel.
//
// Bound: HBM bytes.  Per coordinate the fold reads and writes num and den
// (16 B), reads 1/8 B of bitmap and, where the bit is set, one value; the
// scan reads the bitmap once more and writes 1/32 B of offsets per
// coordinate.  A handful of integer ops per coordinate, far below the
// balance point.  ptxas (-O3, sm_90a): the fold 29-32 registers, the scan
// 29 registers and 40 B of shared memory, no spills.
//
// Values are fp32 or fp16 (the wire's two value types), in both the flat
// and the row entries; an fp16 value is widened to fp32 exactly before it
// is scaled.  num and den are fp32.
//
// Parity: the multiply and the add are separately rounded (__fmul_rn,
// __fadd_rn — no FMA contraction), the same arithmetic as the plain
// version, so results equal it bit for bit for every alpha.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <stdint.h>

#define BLOCK_N 1024                     // coordinates per fold CTA
#define GROUP_N 128                      // coordinates per offset (one fold warp)
#define GROUPS_PER_BLOCK (BLOCK_N / GROUP_N)
#define SCAN_THREADS 256                 // groups per scan block
#define SCAN_N (SCAN_THREADS * GROUP_N)  // coordinates per scan block
#define FULL_MASK 0xffffffffu
#define MAX_ROWS 65535                   // gridDim.y limit of the fold
// a status word: the launch's epoch in the high 32 bits; STATUS_PREFIX set
// when the low 31 bits hold the row's inclusive prefix up to this block,
// clear when they hold the block's own count
#define STATUS_PREFIX 0x80000000ull
#define STATUS_VALUE 0x7fffffffull

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  return *reinterpret_cast<const volatile uint64_t*>(p);
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  *reinterpret_cast<volatile uint64_t*>(p) = v;
}

// One CTA of SCAN_THREADS threads scans SCAN_THREADS groups (one per
// thread) of one row; blocks of the row are its CTAs in ticket order.
__global__ void __launch_bounds__(SCAN_THREADS)
packed_scan_kernel(const uint32_t* __restrict__ words,
                   int32_t* __restrict__ offsets, int32_t* __restrict__ res,
                   uint64_t* status, unsigned* ticket,
                   const int32_t* __restrict__ nnz, int expect, int vstride,
                   int k, int n_words, int n_groups, int n_blocks,
                   unsigned epoch) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  __shared__ unsigned t_s;
  __shared__ int prefix_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == (unsigned)(k * n_blocks) - 1u) atomicExch(ticket, 0u);
    t_s = t;
  }
  __syncthreads();
  const unsigned t = t_s;
  const int row = (int)(t / (unsigned)n_blocks);
  const int b = (int)(t % (unsigned)n_blocks);

  const int64_t g = (int64_t)b * SCAN_THREADS + threadIdx.x;
  const uint32_t* wr = words + (int64_t)row * n_words;
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < GROUP_N / 32; ++q) {
    const int64_t wi = g * (GROUP_N / 32) + q;
    if (wi < n_words) cnt += __popc(wr[wi]);
  }
  int incl = cnt;                        // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < SCAN_THREADS / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < SCAN_THREADS / 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, ws, d);
      if (lane >= d) ws += v;
    }
    const int agg = __shfl_sync(FULL_MASK, ws, SCAN_THREADS / 32 - 1);
    if (lane < SCAN_THREADS / 32) warp_sum[lane] = ws;   // now inclusive
    const uint64_t tag = (uint64_t)epoch << 32;
    if (lane == 0)
      store_status(status + t, tag | (b == 0 ? STATUS_PREFIX : 0ull) |
                                   (uint64_t)agg);
    int prefix = 0;
    if (b > 0) {                         // look back over this row's blocks
      const int64_t row_first = (int64_t)t - b;
      int64_t j = (int64_t)t - 1 - lane;
      while (true) {
        uint64_t s = tag | STATUS_PREFIX;  // before the row: a zero prefix
        if (j >= row_first) {
          do {
            s = load_status(status + j);
          } while ((s >> 32) != epoch);
        }
        const unsigned done =
            __ballot_sync(FULL_MASK, (s & STATUS_PREFIX) != 0ull);
        const int stop = done ? __ffs(done) - 1 : 31;   // nearest prefix
        int v = lane <= stop ? (int)(s & STATUS_VALUE) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL_MASK, v, d);
        prefix += v;
        if (done) break;
        j -= 32;
      }
      if (lane == 0)
        store_status(status + t,
                     tag | STATUS_PREFIX | (uint64_t)(prefix + agg));
    }
    if (lane == 0) {
      prefix_s = prefix;
      if (b == n_blocks - 1) {
        const int total = prefix + agg;
        const int want = nnz != nullptr ? nnz[row] : expect;
        res[row] = total;
        res[k + row] = total != want || want < 0 || want > vstride;
      }
    }
  }
  __syncthreads();
  if (g < n_groups)
    offsets[(int64_t)row * n_groups + g] =
        prefix_s + (warp > 0 ? warp_sum[warp - 1] : 0) + incl - cnt;
}

// num += alpha * v and den += bit at one coordinate, each rounded on its
// own; v is gathered only where the bit is set
template <typename V>
__device__ __forceinline__ void fold_one(float& a, float& d, uint32_t bit,
                                         int rank, const V* values,
                                         int vstride, float alpha) {
  float v = 0.0f;
  // the wrapper has checked that the row's bitmap holds its nnz set bits and
  // nnz <= vstride; this guard only keeps a malformed payload's reads inside
  // the row
  if (bit && rank < vstride) v = to_f32(values[rank]);
  a = __fadd_rn(a, __fmul_rn(alpha, v));
  d = __fadd_rn(d, bit ? 1.0f : 0.0f);
}

template <typename V, bool VEC>
__global__ void __launch_bounds__(32 * GROUPS_PER_BLOCK)
packed_accum_kernel(float* __restrict__ num, float* __restrict__ den,
                    const uint32_t* __restrict__ words,
                    const V* __restrict__ values,
                    const int32_t* __restrict__ offsets, float alpha, int n,
                    int n_words, int vstride) {
  const int lane = threadIdx.x & 31;
  const int64_t g = (int64_t)blockIdx.x * GROUPS_PER_BLOCK + (threadIdx.x >> 5);
  const int64_t g0 = g * GROUP_N;
  if (g0 >= n) return;                   // whole warp leaves together
  const int64_t row = blockIdx.y;
  const int n_groups = (n + GROUP_N - 1) / GROUP_N;
  num += row * n;
  den += row * n;
  words += row * n_words + g * (GROUP_N / 32);
  values += row * vstride;
  float a[4], d[4];

  if (VEC && g0 + GROUP_N <= n) {        // thread: 4 coordinates, 16 B each
    const int64_t c0 = g0 + 4 * lane;
    const float4 av = *reinterpret_cast<const float4*>(num + c0);
    const float4 dv = *reinterpret_cast<const float4*>(den + c0);
    const uint32_t word = words[lane >> 3];
    int rank = offsets[row * n_groups + g];
    a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
    d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
#pragma unroll
    for (int q = 0; q < GROUP_N / 32; ++q) {   // the group's earlier words
      const uint32_t wq = __shfl_sync(FULL_MASK, word, 8 * q);
      if (q < (lane >> 3)) rank += __popc(wq);
    }
    const int shift = 4 * (lane & 7);
    rank += __popc(word & ((1u << shift) - 1u));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t bit = (word >> (shift + j)) & 1u;
      fold_one(a[j], d[j], bit, rank, values, vstride, alpha);
      rank += bit;
    }
    *reinterpret_cast<float4*>(num + c0) = make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(den + c0) = make_float4(d[0], d[1], d[2], d[3]);
    return;
  }

  // 4-byte path (a row that is not 16-byte aligned, or the ragged last
  // group): lane l takes bit l of each of the group's 4 words, so every
  // load and store is one coalesced 128-byte row of the warp
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t c = g0 + 32 * q + lane;
    a[q] = c < n ? num[c] : 0.0f;
    d[q] = c < n ? den[c] : 0.0f;
  }
  uint32_t wq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wq[q] = g * (GROUP_N / 32) + q < n_words ? words[q] : 0u;
  int rank = offsets[row * n_groups + g];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t c = g0 + 32 * q + lane;
    const uint32_t bit = (wq[q] >> lane) & 1u;
    fold_one(a[q], d[q], bit, rank + __popc(wq[q] & ((1u << lane) - 1u)),
             values, vstride, alpha);
    rank += __popc(wq[q]);
    if (c < n) {
      num[c] = a[q];
      den[c] = d[q];
    }
  }
}

template <typename V>
static int launch_accum(void* num, void* den, const void* words,
                        const void* values, const void* offsets, float alpha,
                        int k, int n, int n_words, int vstride, void* stream) {
  if (k < 0 || k > MAX_ROWS || n < 0 || n_words < (n + 31) / 32 ||
      vstride < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || k == 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(num) |
                     reinterpret_cast<uintptr_t>(den)) & 15) == 0 &&
                   (k == 1 || n % 4 == 0);
  const dim3 grid((unsigned)((n + BLOCK_N - 1) / BLOCK_N), (unsigned)k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* nf = static_cast<float*>(num);
  float* df = static_cast<float*>(den);
  const uint32_t* wf = static_cast<const uint32_t*>(words);
  const V* vf = static_cast<const V*>(values);
  const int32_t* of = static_cast<const int32_t*>(offsets);
  if (vec)
    packed_accum_kernel<V, true><<<grid, 32 * GROUPS_PER_BLOCK, 0, s>>>(
        nf, df, wf, vf, of, alpha, n, n_words, vstride);
  else
    packed_accum_kernel<V, false><<<grid, 32 * GROUPS_PER_BLOCK, 0, s>>>(
        nf, df, wf, vf, of, alpha, n, n_words, vstride);
  return (int)cudaGetLastError();
}

extern "C" {

// The scan of K bitmaps (K, n_words) over n coordinates each: writes
// offsets (K, ceil(n / 128)) int32 and res (2K,) int32 — res[r] the set bits
// of row r, res[K + r] non-zero when they differ from the row's value count
// (nnz[r], or `expect` when nnz is null) or that count is outside
// [0, vstride].  `scratch` is int64 with `scratch_len` >= 1 + K *
// ceil(n / 32768) entries, zeroed when allocated and reused by later
// launches on the same stream with a larger `epoch` (>= 1) each time;
// ceil(n / 32768) blocks per row.
int packed_scan_rows(const void* words, void* offsets, void* res,
                     void* scratch, int64_t scratch_len, const void* nnz,
                     int expect, int vstride, int k, int n, int n_words,
                     int epoch, void* stream) {
  if (k < 0 || n < 0 || n_words < (n + 31) / 32 ||
      (int64_t)n_words * 32 > INT_MAX || epoch < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || k == 0) return 0;
  const int n_blocks = (n + SCAN_N - 1) / SCAN_N;
  const int n_groups = (n + GROUP_N - 1) / GROUP_N;
  const int64_t grid = (int64_t)k * n_blocks;
  if (grid > INT_MAX || scratch_len < 1 + grid)
    return (int)cudaErrorInvalidValue;
  uint64_t* status = static_cast<uint64_t*>(scratch);
  packed_scan_kernel<<<(unsigned)grid, SCAN_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(offsets),
      static_cast<int32_t*>(res), status + 1,
      reinterpret_cast<unsigned*>(status), static_cast<const int32_t*>(nnz),
      expect, vstride, k, n_words, n_groups, n_blocks, (unsigned)epoch);
  return (int)cudaGetLastError();
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

int packed_accum_rows_f16(void* num, void* den, const void* words,
                          const void* values, const void* offsets,
                          float alpha, int k, int n, int n_words, int vstride,
                          void* stream) {
  return launch_accum<__half>(num, den, words, values, offsets, alpha, k, n,
                              n_words, vstride, stream);
}

}  // extern "C"
