// Block-sparse masked matmul for U users in one launch, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/masked_matmul.py:
// batched_masked_matmul (body _bmm_kernel) and, as its U=1 form,
// masked_matmul (body _mm_kernel).  For every user u:
//
//     y[u] = x[u] @ (w[u] * m[u])        x (U, M, K), w and m (U, K, N), fp32
//
// with fp32 accumulation.  A (MMK_BK, MMK_BN) weight tile whose mask is all
// zero contributes nothing and is skipped: it costs its mask bytes only.
// The entries batched_masked_matmul_bf16[_mbf16] take bf16 x and w (the
// kernel at the end of this file); what follows describes the fp32 one.
//
// Bound: HBM bytes at the serving shapes.  M is the rows of one request
// (1-16) while K and N are 32-128, so each weight and mask element feeds M
// FMAs: about M/4 flops per byte of w and m, far below the card's ~20
// flops/byte fp32 balance point, so tensor cores would not help (and TF32
// would break the 1e-5 contract).  What the design does about the bytes:
//  * one CTA per (user, 32-column strip, 16-row tile); its K rows are
//    staged in chunks of MMK_CK = 128 (four 32-deep k tiles, one per warp).
//    The strip stays 32 columns, the skip unit's width: a whole 128-column
//    strip would stage 128 KB per chunk, one CTA per SM, while 32 columns
//    stage 34 KB at the serving shapes and 6 CTAs share an SM;
//  * two round trips per chunk, not two per k tile: each warp issues the
//    cp.async copies of its tile's mask, derives the tile's live flag from
//    shared memory once they land (__any_sync), and only then issues the
//    copies of a live tile's weights and x; nothing waits on a CTA barrier
//    before the weights are in flight;
//  * chunks are double-buffered: the next chunk's mask copies are in flight
//    while the current one is multiplied, and its weight copies while the
//    current one computes, so K is unbounded while the serving shapes
//    (K <= 128) are one chunk and exactly two round trips;
//  * 16-byte copies (cp.async.cg) where a row is 16-byte aligned (N % 4 ==
//    0 and aligned bases), 4-byte copies (cp.async.ca) otherwise, chosen per
//    launch; ragged K, N and M edges are zero-filled or masked in the
//    kernel, never padded on the host;
//  * w*m is formed once per element in shared memory (in place over w) and
//    every row of x reuses it from there;
//  * the FMA loop runs over the rows a warp owns and no others (a request
//    has 1-16 rows; at M=4 each warp owns one), reading x four k at a time.
//    Measured on the H100, this loop and not the copies was what held the
//    serving shapes back: a loop over all four row slots of a warp issued
//    some 15 instructions per useful FMA at M=4, and the kernel became
//    bound by instruction issue rather than bytes.
// ptxas (-O3, sm_90a): 46 registers (16-byte copies) and 63 (4-byte
// copies), no spills, 32 B of static shared memory; the dynamic stage is
// (2 * MMK_CK * MMK_BN + rows * MMK_CK) * 4 bytes per buffer: 34,816 B at
// the serving shapes (one buffer, 4 rows), so 6 CTAs fit on an SM.
//
// Parity: each output is one fp32 FMA chain in ascending k over
// __fmul_rn(w, m), skipping the empty (32, 32) tiles, so a
// user's rows depend only on that user's operands: a user's output in a
// mixed batch is bit-equal to the same user served alone.  Against
// torch.matmul (cuBLAS, another summation order) it agrees to fp32
// rounding.  No TF32 and no tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define MMK_BM 16                        // rows of x per CTA
#define MMK_BN 32                        // output columns per CTA (one per lane)
#define MMK_BK 32                        // depth of one k tile (the skip unit)
#define MMK_WARPS 4
#define MMK_THREADS (32 * MMK_WARPS)
#define MMK_CK (MMK_BK * MMK_WARPS)      // k rows per chunk: warp w owns tile w
#define MMK_ROWS_PER_WARP (MMK_BM / MMK_WARPS)
#define MMK_TILE (MMK_BK * MMK_BN)       // floats in one k tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy the (MMK_BK, MMK_BN) tile of a (K, N) matrix at rows k0.., columns
// n0.. into `dst` (row-major, MMK_BN wide); out-of-range elements are zero.
template <bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int k0, int n0, int K, int N,
                                           int lane) {
  if (VEC) {                             // 8 lanes per 128-byte row
    const int c = n0 + 4 * (lane & 7);
#pragma unroll
    for (int i = 0; i < MMK_BK / 4; ++i) {
      const int r = (lane >> 3) + 4 * i;
      const bool ok = k0 + r < K && c < N;
      cp_async16(dst + r * MMK_BN + 4 * (lane & 7),
                 ok ? src + (int64_t)(k0 + r) * N + c : src, ok);
    }
  } else {                               // one lane per column
    const int c = n0 + lane;
#pragma unroll 8
    for (int r = 0; r < MMK_BK; ++r) {
      const bool ok = k0 + r < K && c < N;
      cp_async4(dst + r * MMK_BN + lane,
                ok ? src + (int64_t)(k0 + r) * N + c : src, ok);
    }
  }
}

// Copy x[0:rows, k0:k0+MMK_BK] into column block `kt` of the (rows, MMK_CK)
// buffer `dst`.
__device__ __forceinline__ void stage_x(float* dst, const float* x, int kt,
                                        int k0, int rows, int K, bool vec,
                                        int lane) {
  if (vec) {
    for (int i = lane; i < rows * (MMK_BK / 4); i += 32) {
      const int r = i / (MMK_BK / 4), kk = 4 * (i % (MMK_BK / 4));
      const bool ok = k0 + kk < K;
      cp_async16(dst + r * MMK_CK + kt * MMK_BK + kk,
                 ok ? x + (int64_t)r * K + k0 + kk : x, ok);
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      const bool ok = k0 + lane < K;
      cp_async4(dst + r * MMK_CK + kt * MMK_BK + lane,
                ok ? x + (int64_t)r * K + k0 + lane : x, ok);
    }
  }
}

// acc[i] += x[warp + 4i, k] * wm[k, lane] for the k of one k tile (columns
// kbase.. of the staged x, rows kbase.. of the staged w*m), ascending k,
// for the NR rows this warp owns, so no instruction is spent on rows past
// M (a request has 1-16); x is read 4 k at a time (128-bit shared loads)
template <int NR>
__device__ __forceinline__ void fma_rows(float* acc, const float* wc,
                                         const float* xc, int kbase, int kmax,
                                         int warp, int lane) {
  int kk = 0;
  for (; kk + 4 <= kmax; kk += 4) {
    const float* wk = wc + (kbase + kk) * MMK_BN + lane;
    const float w0 = wk[0], w1 = wk[MMK_BN], w2 = wk[2 * MMK_BN],
                w3 = wk[3 * MMK_BN];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(
          xc + (warp + MMK_WARPS * i) * MMK_CK + kbase + kk);
      acc[i] = __fmaf_rn(xv.x, w0, acc[i]);
      acc[i] = __fmaf_rn(xv.y, w1, acc[i]);
      acc[i] = __fmaf_rn(xv.z, w2, acc[i]);
      acc[i] = __fmaf_rn(xv.w, w3, acc[i]);
    }
  }
  for (; kk < kmax; ++kk) {
    const float wv = wc[(kbase + kk) * MMK_BN + lane];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      acc[i] = __fmaf_rn(xc[(warp + MMK_WARPS * i) * MMK_CK + kbase + kk], wv,
                         acc[i]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(MMK_THREADS)
masked_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ m, float* __restrict__ y,
                     int M, int K, int N, int rows_alloc, bool vec_x) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int live_s[2][MMK_WARPS];
  const int n_chunks = (K + MMK_CK - 1) / MMK_CK;
  const int nbuf = n_chunks > 1 ? 2 : 1;
  float* ms = smem;                                  // [nbuf][MMK_CK][MMK_BN]
  float* ws = ms + nbuf * MMK_CK * MMK_BN;           // [nbuf][MMK_CK][MMK_BN]
  float* xs = ws + nbuf * MMK_CK * MMK_BN;           // [nbuf][rows_alloc][MMK_CK]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t u = blockIdx.z;
  const int m0 = blockIdx.y * MMK_BM;
  const int n0 = blockIdx.x * MMK_BN;
  const int rows = min(MMK_BM, M - m0);
  const int n_rows = rows > warp ? (rows - warp + MMK_WARPS - 1) / MMK_WARPS : 0;

  const float* xu = x + (u * M + m0) * (int64_t)K;
  const float* wu = w + u * K * (int64_t)N;
  const float* mu = m + u * K * (int64_t)N;

  // this warp's k tile of chunk c lives at rows warp*MMK_BK.. of buffer c&1
  auto tile_of = [&](float* base, int c) {
    return base + ((c & 1) * MMK_CK + warp * MMK_BK) * MMK_BN;
  };
  auto stage_mask = [&](int c) {
    stage_tile<VEC>(tile_of(ms, c), mu, c * MMK_CK + warp * MMK_BK, n0, K, N,
                    lane);
  };
  // the mask tile of chunk c has landed: flag it, and stage its weights and
  // x only if it holds a non-zero
  auto scan_and_stage = [&](int c) {
    const float4* mt = reinterpret_cast<const float4*>(tile_of(ms, c));
    bool any = false;
#pragma unroll
    for (int i = 0; i < MMK_TILE / 4 / 32; ++i) {
      const float4 v = mt[lane + 32 * i];
      any |= (v.x != 0.0f) | (v.y != 0.0f) | (v.z != 0.0f) | (v.w != 0.0f);
    }
    const bool live = __any_sync(0xffffffffu, any);
    if (lane == 0) live_s[c & 1][warp] = live;
    if (live) {
      const int k0 = c * MMK_CK + warp * MMK_BK;
      stage_tile<VEC>(tile_of(ws, c), wu, k0, n0, K, N, lane);
      stage_x(xs + (c & 1) * rows_alloc * MMK_CK, xu, warp, k0, rows, K, vec_x,
              lane);
    }
  };

  float acc[MMK_ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < MMK_ROWS_PER_WARP; ++i) acc[i] = 0.0f;

  if (n_chunks > 0) {
    stage_mask(0);
    cp_async_commit();
    if (n_chunks > 1) {
      stage_mask(1);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncwarp();
    scan_and_stage(0);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();                 // this chunk's w, x; the next mask
    __syncwarp();
    if (live_s[buf][warp]) {             // w <- w*m over this warp's tile
      float4* wt = reinterpret_cast<float4*>(tile_of(ws, c));
      const float4* mt = reinterpret_cast<const float4*>(tile_of(ms, c));
#pragma unroll
      for (int i = 0; i < MMK_TILE / 4 / 32; ++i) {
        float4 a = wt[lane + 32 * i];
        const float4 b = mt[lane + 32 * i];
        a.x = __fmul_rn(a.x, b.x);
        a.y = __fmul_rn(a.y, b.y);
        a.z = __fmul_rn(a.z, b.z);
        a.w = __fmul_rn(a.w, b.w);
        wt[lane + 32 * i] = a;
      }
    }
    __syncwarp();                        // the mask tile is free again
    if (c + 2 < n_chunks) stage_mask(c + 2);
    cp_async_commit();
    if (c + 1 < n_chunks) scan_and_stage(c + 1);
    cp_async_commit();
    __syncthreads();                     // every warp's w*m, x and flag

    const float* wc = ws + buf * MMK_CK * MMK_BN;
    const float* xc = xs + buf * rows_alloc * MMK_CK;
    for (int t = 0; t < MMK_WARPS; ++t) {
      const int kmax = min(MMK_BK, K - (c * MMK_CK + t * MMK_BK));
      if (kmax <= 0 || !live_s[buf][t]) continue;   // uniform per CTA
      switch (n_rows) {                  // only this warp's real rows
        case 1: fma_rows<1>(acc, wc, xc, t * MMK_BK, kmax, warp, lane); break;
        case 2: fma_rows<2>(acc, wc, xc, t * MMK_BK, kmax, warp, lane); break;
        case 3: fma_rows<3>(acc, wc, xc, t * MMK_BK, kmax, warp, lane); break;
        case 4: fma_rows<4>(acc, wc, xc, t * MMK_BK, kmax, warp, lane); break;
      }
    }
    __syncthreads();                     // done with buffer `buf`
  }

  const int col = n0 + lane;
  if (col >= N) return;
  float* yu = y + (u * M + m0) * (int64_t)N;
#pragma unroll
  for (int i = 0; i < MMK_ROWS_PER_WARP; ++i) {
    const int r = warp + MMK_WARPS * i;
    if (r < rows) yu[(int64_t)r * N + col] = acc[i];
  }
}

// Let `kernel` take up to `bytes` of dynamic shared memory on the current
// device, once per device (`opted_in`: the caller's flags, one per kernel);
// the cudaError_t of the attempt
template <typename Kernel>
static int allow_smem(Kernel kernel, int bytes, bool* opted_in) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  return 0;
}

template <bool VEC>
static int launch(const float* x, const float* w, const float* m, float* y,
                  int U, int M, int K, int N, cudaStream_t stream) {
  const int n_chunks = (K + MMK_CK - 1) / MMK_CK;
  const int nbuf = n_chunks > 1 ? 2 : 1;
  const int rows_alloc = M < MMK_BM ? M : MMK_BM;
  const int smem =
      nbuf * (2 * MMK_CK * MMK_BN + rows_alloc * MMK_CK) * (int)sizeof(float);
  if (smem > 48 * 1024) {                // opt in once per device
    static bool opted_in[64] = {};
    const int e = allow_smem(masked_matmul_kernel<VEC>,
                             2 * (2 * MMK_CK * MMK_BN + MMK_BM * MMK_CK) *
                                 (int)sizeof(float),
                             opted_in);
    if (e) return e;
  }
  const bool vec_x =
      K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  dim3 grid((unsigned)((N + MMK_BN - 1) / MMK_BN),
            (unsigned)((M + MMK_BM - 1) / MMK_BM), (unsigned)U);
  masked_matmul_kernel<VEC><<<grid, MMK_THREADS, smem, stream>>>(
      x, w, m, y, M, K, N, rows_alloc, vec_x);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 operands (the reference's bf16 path: x and w bf16, the mask cast to
// w's type, an fp32 accumulator, y in x's type):
//
//     y[u] = bf16(x[u] @ bf16(w[u] * bf16(m[u])))     accumulated in fp32
//
// m is fp32 (the serving pool's masks) or bf16.
//
// Bound: HBM bytes, as for fp32.  Each weight element costs 4 or 6 bytes
// (w and m) and feeds 2*M operations, M = 1-16 for a request: under 8
// operations a byte against the ~295 at which the bf16 tensor cores become
// the limit.  The tensor cores are used because they take the multiply-adds
// off the issue slots (a CUDA-core FMA per row, k and column is what held
// the first fp32 kernel back), and because bf16 in, fp32 accumulate is
// exactly what they compute.
//
// Design (one kernel for both mask types and every U, the U=1 form
// included):
//  * operands swapped for a skinny M: y^T = (w*m)^T x^T, one
//    mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 per 16 columns x 8
//    rows x 16 k.  The masked weight strip is the MMA's A operand (its 16
//    rows are output columns), the request's rows are its n8, so a request
//    of 1-8 rows pads to 8, not 16;
//  * the tile and grid are the fp32 kernel's: one CTA per (user, 32-column
//    strip, 16-row tile), K staged in chunks of MMK_CK = 128, double
//    buffered when K spans more than one chunk.  Warp w stages k tile w of
//    each chunk and computes output tile (columns 16 * (w & 1).., rows
//    8 * (w >> 1)..); a warp whose 8 rows all lie past M issues no ldmatrix
//    and no mma.  No warp splits K, so no sum crosses warps;
//  * the fp32 kernel's skip scheme: each warp issues the cp.async copies of
//    its tile's mask, flags the tile live once they land (__any_sync), and
//    only then issues the copies of a live tile's weights and x: two round
//    trips a chunk.  Both rings run a chunk ahead: the first two chunks'
//    masks are copied together and then both chunks' weights, so K <= 256
//    (the U=1 shape) costs two round trips, not three; later, chunk c + 1's
//    weights are in flight while chunk c is multiplied and chunk c + 2's
//    mask while it computes.  An empty (MMK_BK, MMK_BN) mask tile costs its
//    mask bytes;
//  * 16-byte cp.async.cg copies where w's and m's rows (N % 8 == 0) and x's
//    rows (K % 8 == 0) start on 16 bytes and the bases are aligned, chosen
//    per launch for (w, m) and for x; element copies (plain loads)
//    otherwise, which also take a bf16 base at an odd element offset.
//    Ragged K, N and M edges are zero-filled or masked in the kernel, never
//    padded on the host;
//  * w <- bf16(w * bf16(m)) once per element in shared memory, in place
//    over w (fp32 multiply, one rounding: the plain version's product),
//    before any fragment is loaded;
//  * A by ldmatrix.x4.trans from the (k, n) row-major w*m tile, B by
//    ldmatrix.x4 from the (row, k) x block (rows past M read row M-1's
//    address; their outputs are never stored).  Both stages are XOR-
//    swizzled in 16-byte chunks (w*m by (k / 2) % 4, x by row % 8), so
//    each ldmatrix phase hits eight distinct bank groups.
// ptxas (-O3, sm_90a, under __launch_bounds__(128, 8)): 62-64 registers,
// no spills, 32 B of static shared memory (chip_smoke.py logs each
// instantiation's line); the dynamic stage is (MMK_CK * MMK_BN * (m's
// size + 2) + rows * MMK_CK * 2) bytes a buffer: 25,600 B at the serving
// shape with an fp32 mask (one buffer, 4 rows), so 8 CTAs share an SM.
//
// Parity: the tensor cores multiply bf16 by bf16 exactly and add each
// 16-deep product into the fp32 accumulator; the order within one mma is
// the hardware's, the same for the same inputs, and the mma steps run in
// ascending k, skipping the empty mask tiles.  Every choice (strip, chunk,
// copy width, warp) depends on M, K and N only, never on U or on another
// user's operands: a user's rows in a mixed batch are bit-equal to the
// same user served alone, and two launches give the same bits.  Against
// the plain version (torch.matmul of the fp32 widenings, another summation
// order, then one rounding) the fp32 sums differ by a few fp32 roundings,
// so after the one rounding to bf16 each output is within one bf16 ulp
// (plus 1e-5 near zero) of plain: within_bf16_ulp in the wrapper.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float mask_f32(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));   // m.to(bf16)
}

// element (k, n) of a staged (MMK_CK, MMK_BN) mask: row-major
struct MaskAt {
  __device__ __forceinline__ int operator()(int k, int n) const {
    return k * MMK_BN + n;
  }
};

// element (k, n) of a staged (MMK_CK, MMK_BN) w*m tile: four 16-byte chunks
// of 8 columns a row, chunk c stored at c ^ ((k / 2) % 4)
struct WAt {
  __device__ __forceinline__ int operator()(int k, int n) const {
    return k * MMK_BN + ((((n >> 3) ^ (k >> 1)) & 3) << 3) + (n & 7);
  }
};

// element (r, k) of a staged (rows, MMK_CK) block of x: sixteen 16-byte
// chunks of 8 k a row, chunk c stored at c ^ (r % 8)
__device__ __forceinline__ int x_at(int r, int k) {
  return r * MMK_CK + (((k >> 3) ^ (r & 7)) << 3) + (k & 7);
}

// Copy the (MMK_BK, MMK_BN) tile at rows k0.., columns n0.. of a (K, N)
// matrix of T into dst, its row k0 + r at staged row kr + r (at() places
// each element); out-of-range elements are zero.
template <bool VEC, typename T, typename At>
__device__ __forceinline__ void stage_tile_bf16(T* dst, const T* src, int kr,
                                                int k0, int n0, int K, int N,
                                                int lane, At at) {
  if (VEC) {                           // 16-byte copies, N % 8 == 0
    constexpr int PER = 16 / (int)sizeof(T);     // elements a copy
    constexpr int LANES = MMK_BN / PER;          // copies a row (8 or 4)
    constexpr int STEP = 32 / LANES;             // rows a pass (4 or 8)
    const int cc = PER * (lane % LANES);
#pragma unroll
    for (int i = 0; i < MMK_BK / STEP; ++i) {
      const int r = lane / LANES + STEP * i;
      const bool ok = k0 + r < K && n0 + cc < N;
      cp_async16(dst + at(kr + r, cc),
                 ok ? src + (int64_t)(k0 + r) * N + n0 + cc : src, ok);
    }
  } else {                             // one lane per column
    const int c = n0 + lane;
#pragma unroll 8
    for (int r = 0; r < MMK_BK; ++r) {
      const bool ok = k0 + r < K && c < N;
      dst[at(kr + r, lane)] = ok ? src[(int64_t)(k0 + r) * N + c] : T{};
    }
  }
}

// Copy x[0:rows, k0:k0+MMK_BK] into columns kt*MMK_BK.. of the staged x
// block; out-of-range k are zero.
__device__ __forceinline__ void stage_x_bf16(__nv_bfloat16* dst,
                                             const __nv_bfloat16* x, int kt,
                                             int k0, int rows, int K,
                                             bool vec, int lane) {
  if (vec) {                           // 16-byte copies, K % 8 == 0
    for (int i = lane; i < rows * (MMK_BK / 8); i += 32) {
      const int r = i / (MMK_BK / 8), kk = 8 * (i % (MMK_BK / 8));
      const bool ok = k0 + kk < K;
      cp_async16(dst + x_at(r, kt * MMK_BK + kk),
                 ok ? x + (int64_t)r * K + k0 + kk : x, ok);
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      const bool ok = k0 + lane < K;
      dst[x_at(r, kt * MMK_BK + lane)] =
          ok ? x[(int64_t)r * K + k0 + lane] : __nv_bfloat16{};
    }
  }
}

// any non-zero value (a set bit other than the sign) among 16 staged bytes
__device__ __forceinline__ bool any_nonzero(uint4 v, float) {
  return ((v.x | v.y | v.z | v.w) & 0x7fffffffu) != 0;
}
__device__ __forceinline__ bool any_nonzero(uint4 v, __nv_bfloat16) {
  return ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) != 0;
}

// four consecutive staged mask values, rounded to bf16 and widened
__device__ __forceinline__ float4 mask4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return make_float4(mask_f32(v.x), mask_f32(v.y), mask_f32(v.z),
                     mask_f32(v.w));
}
__device__ __forceinline__ float4 mask4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// acc (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* acc, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 CTAs an SM: at most 64 registers a thread, so the serving shape's
// 1,024 CTAs (25.6 KB of shared memory each) run in one wave
template <bool VEC, typename MT>
__global__ void __launch_bounds__(MMK_THREADS, 8)
masked_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const MT* __restrict__ m,
                          __nv_bfloat16* __restrict__ y, int M, int K, int N,
                          int rows_alloc, bool vec_x) {
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __shared__ int live_s[2][MMK_WARPS];
  const int n_chunks = (K + MMK_CK - 1) / MMK_CK;
  const int nbuf = n_chunks > 1 ? 2 : 1;
  MT* ms = reinterpret_cast<MT*>(smem_bf16);         // [nbuf][MMK_CK][MMK_BN]
  __nv_bfloat16* ws =                                 // [nbuf][MMK_CK][MMK_BN]
      reinterpret_cast<__nv_bfloat16*>(ms + nbuf * MMK_CK * MMK_BN);
  __nv_bfloat16* xs =                                 // [nbuf][rows][MMK_CK]
      ws + nbuf * MMK_CK * MMK_BN;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t u = blockIdx.z;
  const int m0 = blockIdx.y * MMK_BM;
  const int n0 = blockIdx.x * MMK_BN;
  const int rows = min(MMK_BM, M - m0);
  const int slab = warp & 1, grp = warp >> 1;   // this warp's output tile
  const bool active = 8 * grp < rows;

  const __nv_bfloat16* xu = x + (u * M + m0) * (int64_t)K;
  const __nv_bfloat16* wu = w + u * K * (int64_t)N;
  const MT* mu = m + u * K * (int64_t)N;

  auto mbuf = [&](int c) { return ms + (c & 1) * MMK_CK * MMK_BN; };
  auto wbuf = [&](int c) { return ws + (c & 1) * MMK_CK * MMK_BN; };
  auto xbuf = [&](int c) { return xs + (c & 1) * rows_alloc * MMK_CK; };
  auto stage_mask = [&](int c) {
    stage_tile_bf16<VEC>(mbuf(c), mu, warp * MMK_BK,
                         c * MMK_CK + warp * MMK_BK, n0, K, N, lane, MaskAt{});
  };
  // the mask tile of chunk c has landed: flag it, and stage its weights and
  // x only if it holds a non-zero
  auto scan_and_stage = [&](int c) {
    const uint4* mt =
        reinterpret_cast<const uint4*>(mbuf(c) + warp * MMK_BK * MMK_BN);
    bool any = false;
#pragma unroll
    for (int i = 0; i < MMK_TILE * (int)sizeof(MT) / 16 / 32; ++i)
      any |= any_nonzero(mt[lane + 32 * i], MT{});
    const bool live = __any_sync(0xffffffffu, any);
    if (lane == 0) live_s[c & 1][warp] = live;
    if (live) {
      const int k0 = c * MMK_CK + warp * MMK_BK;
      stage_tile_bf16<VEC>(wbuf(c), wu, warp * MMK_BK, k0, n0, K, N, lane,
                           WAt{});
      stage_x_bf16(xbuf(c), xu, warp, k0, rows, K, vec_x, lane);
    }
  };
  // w <- bf16(w * bf16(m)) over this warp's k tile, four columns a step
  auto apply_mask = [&](int c) {
    const MT* mc = mbuf(c);
    __nv_bfloat16* wc = wbuf(c);
#pragma unroll
    for (int i = 0; i < MMK_TILE / 4 / 32; ++i) {
      const int q = lane + 32 * i;
      const int k = warp * MMK_BK + q / (MMK_BN / 4);
      const int n = 4 * (q % (MMK_BN / 4));
      const float4 mv = mask4(mc + MaskAt{}(k, n));
      __nv_bfloat162* wp = reinterpret_cast<__nv_bfloat162*>(wc + WAt{}(k, n));
      const float2 a = __bfloat1622float2(wp[0]), b = __bfloat1622float2(wp[1]);
      wp[0] = __floats2bfloat162_rn(__fmul_rn(a.x, mv.x), __fmul_rn(a.y, mv.y));
      wp[1] = __floats2bfloat162_rn(__fmul_rn(b.x, mv.z), __fmul_rn(b.y, mv.w));
    }
  };

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // this warp's 16 x 8 output tile over the live k tiles of chunk c, in
  // ascending k: per k tile one ldmatrix of x (two k16 steps), per k16 step
  // one ldmatrix of w*m and one mma
  auto multiply = [&](int c) {
    const __nv_bfloat16* wc = wbuf(c);
    const __nv_bfloat16* xc = xbuf(c);
    const int j = lane >> 3;             // the ldmatrix matrix it addresses
    const int r = min(8 * grp + (lane & 7), rows - 1);
    for (int t = 0; t < MMK_WARPS; ++t) {
      const int kmax = min(MMK_BK, K - (c * MMK_CK + t * MMK_BK));
      if (kmax <= 0 || !live_s[c & 1][t]) continue;   // uniform per CTA
      unsigned b[4];
      ldmatrix_x4(b, xc + x_at(r, t * MMK_BK + 8 * j));
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (16 * s >= kmax) break;
        unsigned a[4];
        ldmatrix_x4_trans(a, wc + WAt{}(t * MMK_BK + 16 * s + 8 * (j >> 1) +
                                             (lane & 7),
                                         16 * slab + 8 * (j & 1)));
        mma_bf16(acc, a, b[2 * s], b[2 * s + 1]);
      }
    }
  };

  // both rings run one chunk ahead: chunk c + 1's weights are in flight
  // while chunk c is multiplied, chunk c + 2's mask while it computes
  if (n_chunks > 0) {
    stage_mask(0);
    if (n_chunks > 1) stage_mask(1);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    scan_and_stage(0);
    cp_async_commit();
    if (n_chunks > 1) scan_and_stage(1);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_one();                 // this chunk's w, x (not the next's)
    __syncwarp();
    if (live_s[c & 1][warp]) apply_mask(c);
    __syncwarp();                        // the mask tile is free again
    if (c + 2 < n_chunks) stage_mask(c + 2);
    cp_async_commit();
    __syncthreads();                     // every warp's w*m, x and flag
    if (active) multiply(c);
    __syncthreads();                     // done with buffer c & 1
    if (c + 2 < n_chunks) {
      cp_async_wait_all();               // chunk c + 2's mask
      __syncwarp();
      scan_and_stage(c + 2);
    }
    cp_async_commit();
  }

  if (!active) return;
  // acc[2h + e]: column g + 8h of the slab, row 2 * (lane % 4) + e of the
  // warp's 8 (the mma's C fragment, transposed back)
  const int g = lane >> 2, tq = lane & 3;
  __nv_bfloat16* yu = y + (u * M + m0) * (int64_t)N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = n0 + 16 * slab + g + 8 * h;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * grp + 2 * tq + e;
      if (col < N && r < rows)
        yu[(int64_t)r * N + col] = __float2bfloat16_rn(acc[2 * h + e]);
    }
  }
}

// the shape checks of every entry: cudaErrorInvalidValue when a dimension
// is negative or exceeds int32 or the shapes do not chain,
// cudaErrorInvalidConfiguration when U or the row tiles exceed the grid, 0
// when they are fine
static int check_dims(int64_t U, int64_t M, int64_t K, int64_t wU, int64_t wK,
                      int64_t wN, int64_t mU, int64_t mK, int64_t mN) {
  const int64_t dims[] = {U, M, K, wU, wK, wN, mU, mK, mN};
  for (int64_t d : dims)
    if (d < 0 || d > INT_MAX) return (int)cudaErrorInvalidValue;
  if (wU != U || wK != K || mU != U || mK != K || mN != wN)
    return (int)cudaErrorInvalidValue;
  if ((M + MMK_BM - 1) / MMK_BM > 65535 || U > 65535)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
}

template <bool VEC, typename MT>
static int launch_bf16_kernel(const __nv_bfloat16* x, const __nv_bfloat16* w,
                              const MT* m, __nv_bfloat16* y, int U, int M,
                              int K, int N, cudaStream_t stream) {
  const int n_chunks = (K + MMK_CK - 1) / MMK_CK;
  const int nbuf = n_chunks > 1 ? 2 : 1;
  const int rows_alloc = M < MMK_BM ? M : MMK_BM;
  const int tile_bytes = MMK_CK * MMK_BN * ((int)sizeof(MT) + 2);  // m and w
  const int smem = nbuf * (tile_bytes + rows_alloc * MMK_CK * 2);
  if (smem > 48 * 1024) {                // opt in once per device
    static bool opted_in[64] = {};
    const int e = allow_smem(masked_matmul_bf16_kernel<VEC, MT>,
                             2 * (tile_bytes + MMK_BM * MMK_CK * 2), opted_in);
    if (e) return e;
  }
  const bool vec_x =
      K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  dim3 grid((unsigned)((N + MMK_BN - 1) / MMK_BN),
            (unsigned)((M + MMK_BM - 1) / MMK_BM), (unsigned)U);
  masked_matmul_bf16_kernel<VEC, MT><<<grid, MMK_THREADS, smem, stream>>>(
      x, w, m, y, M, K, N, rows_alloc, vec_x);
  return (int)cudaGetLastError();
}

template <typename MT>
static int launch_bf16(const void* x, const void* w, const void* m, void* y,
                       int64_t U, int64_t M, int64_t K, int64_t wU, int64_t wK,
                       int64_t wN, int64_t mU, int64_t mK, int64_t mN,
                       void* stream) {
  const int err = check_dims(U, M, K, wU, wK, wN, mU, mK, mN);
  if (err) return err;
  const int64_t N = wN;
  if (U == 0 || M == 0 || N == 0) return 0;
  const bool vec = N % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(m)) & 15) == 0;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const MT* mb = static_cast<const MT*>(m);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_bf16_kernel<true, MT>(xb, wb, mb, yb, (int)U, (int)M,
                                            (int)K, (int)N, s)
             : launch_bf16_kernel<false, MT>(xb, wb, mb, yb, (int)U, (int)M,
                                             (int)K, (int)N, s);
}

extern "C" {

// x (U, M, K), w (wU, wK, wN) and m (mU, mK, mN), y (U, M, N = wN):
// contiguous fp32 device buffers.  Returns cudaErrorInvalidValue when a
// dimension is negative or exceeds int32 or the shapes do not chain,
// cudaErrorInvalidConfiguration when U or the row tiles exceed the grid;
// otherwise launches on `stream` and returns the cudaError_t of the launch.
int batched_masked_matmul_f32(const void* x, const void* w, const void* m,
                              void* y, int64_t U, int64_t M, int64_t K,
                              int64_t wU, int64_t wK, int64_t wN, int64_t mU,
                              int64_t mK, int64_t mN, void* stream) {
  const int err = check_dims(U, M, K, wU, wK, wN, mU, mK, mN);
  if (err) return err;
  const int64_t N = wN;
  if (U == 0 || M == 0 || N == 0) return 0;
  const bool vec = N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(m)) & 15) == 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(m);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(xf, wf, mf, yf, (int)U, (int)M, (int)K, (int)N, s)
             : launch<false>(xf, wf, mf, yf, (int)U, (int)M, (int)K, (int)N, s);
}

// The same operands in bf16 (x, w, y) with an fp32 mask (the serving
// pool's), and with a bf16 mask; the same shape checks and return codes.
int batched_masked_matmul_bf16(const void* x, const void* w, const void* m,
                               void* y, int64_t U, int64_t M, int64_t K,
                               int64_t wU, int64_t wK, int64_t wN, int64_t mU,
                               int64_t mK, int64_t mN, void* stream) {
  return launch_bf16<float>(x, w, m, y, U, M, K, wU, wK, wN, mU, mK, mN,
                            stream);
}

int batched_masked_matmul_bf16_mbf16(const void* x, const void* w,
                                     const void* m, void* y, int64_t U,
                                     int64_t M, int64_t K, int64_t wU,
                                     int64_t wK, int64_t wN, int64_t mU,
                                     int64_t mK, int64_t mN, void* stream) {
  return launch_bf16<__nv_bfloat16>(x, w, m, y, U, M, K, wU, wK, wN, mU, mK,
                                    mN, stream);
}

}  // extern "C"
