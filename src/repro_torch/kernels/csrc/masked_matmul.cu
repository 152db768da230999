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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
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
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
      e = cudaFuncSetAttribute(masked_matmul_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * (2 * MMK_CK * MMK_BN + MMK_BM * MMK_CK) *
                                   (int)sizeof(float));
      if (e != cudaSuccess) return (int)e;
      opted_in[dev] = true;
    }
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
// m is fp32 (the serving pool's masks) or bf16.  w * m is rounded to bf16
// as the plain version's bf16 multiply rounds it (for m in {0, 1} it is
// exact), then widened to fp32, as is x; each output is one fp32 FMA chain
// in ascending k, skipping the empty (MMK_BK, MMK_BN) mask tiles, rounded
// to bf16 once at the end.  Against the plain version (torch.matmul of the
// fp32 widenings, another summation order, then one rounding) it agrees to
// fp32 rounding before the final rounding, so within one bf16 ulp.
//
// Design: a simple first kernel, not yet the card's tensor-core path.  One
// CTA per (user, 32-column strip, 16-row tile), as the fp32 kernel; per
// 32-deep k tile each thread loads 8 mask values (a lane per column, so a
// warp reads consecutive addresses), the CTA decides with one
// __syncthreads_or whether the tile holds a non-zero, and only a live tile
// has its weights and the x tile loaded, widened into shared memory as
// fp32, and multiplied.  Ragged M, K and N edges are masked in the loads
// and the stores, never padded on the host.  bf16 in, fp32 accumulate is
// what mma.sync / wgmma compute; that design is later work.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float mask_f32(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));   // m.to(bf16)
}
__device__ __forceinline__ float mask_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename MT>
__global__ void __launch_bounds__(MMK_THREADS)
masked_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const MT* __restrict__ m,
                          __nv_bfloat16* __restrict__ y, int M, int K,
                          int N) {
  __shared__ float ws[MMK_BK][MMK_BN];    // bf16(w * m) of one k tile, widened
  __shared__ float xs[MMK_BM][MMK_BK + 1];  // x tile, widened (+1: no conflicts)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t u = blockIdx.z;
  const int m0 = blockIdx.y * MMK_BM;
  const int n0 = blockIdx.x * MMK_BN;
  const int col = n0 + lane;
  const __nv_bfloat16* xu = x + u * M * (int64_t)K;
  const __nv_bfloat16* wu = w + u * K * (int64_t)N;
  const MT* mu = m + u * K * (int64_t)N;
  constexpr int TILE_ROWS = MMK_BK / MMK_WARPS;   // k rows a thread loads

  float acc[MMK_ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < MMK_ROWS_PER_WARP; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += MMK_BK) {
    float mv[TILE_ROWS];
    bool any = false;
#pragma unroll
    for (int i = 0; i < TILE_ROWS; ++i) {
      const int k = k0 + warp + MMK_WARPS * i;
      const bool ok = k < K && col < N;
      mv[i] = ok ? mask_f32(mu[(int64_t)k * N + col]) : 0.0f;
      any |= mv[i] != 0.0f;
    }
    if (!__syncthreads_or(any)) continue;          // an empty tile: skipped
#pragma unroll
    for (int i = 0; i < TILE_ROWS; ++i) {
      const int r = warp + MMK_WARPS * i;
      const int k = k0 + r;
      float wm = 0.0f;
      if (k < K && col < N)
        wm = __bfloat162float(__float2bfloat16_rn(__fmul_rn(
            __bfloat162float(wu[(int64_t)k * N + col]), mv[i])));
      ws[r][lane] = wm;
    }
    for (int i = threadIdx.x; i < MMK_BM * MMK_BK; i += MMK_THREADS) {
      const int r = i / MMK_BK, kk = i % MMK_BK;
      const bool ok = m0 + r < M && k0 + kk < K;
      xs[r][kk] = ok ? __bfloat162float(xu[(int64_t)(m0 + r) * K + k0 + kk])
                     : 0.0f;
    }
    __syncthreads();
    const int kmax = min(MMK_BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float wv = ws[kk][lane];
#pragma unroll
      for (int i = 0; i < MMK_ROWS_PER_WARP; ++i)
        acc[i] = __fmaf_rn(xs[warp + MMK_WARPS * i][kk], wv, acc[i]);
    }
    __syncthreads();                               // ws, xs free again
  }

  if (col >= N) return;
  __nv_bfloat16* yu = y + u * M * (int64_t)N;
#pragma unroll
  for (int i = 0; i < MMK_ROWS_PER_WARP; ++i) {
    const int r = m0 + warp + MMK_WARPS * i;
    if (r < M) yu[(int64_t)r * N + col] = __float2bfloat16_rn(acc[i]);
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

template <typename MT>
static int launch_bf16(const void* x, const void* w, const void* m, void* y,
                       int64_t U, int64_t M, int64_t K, int64_t wU, int64_t wK,
                       int64_t wN, int64_t mU, int64_t mK, int64_t mN,
                       void* stream) {
  const int err = check_dims(U, M, K, wU, wK, wN, mU, mK, mN);
  if (err) return err;
  const int64_t N = wN;
  if (U == 0 || M == 0 || N == 0) return 0;
  dim3 grid((unsigned)((N + MMK_BN - 1) / MMK_BN),
            (unsigned)((M + MMK_BM - 1) / MMK_BM), (unsigned)U);
  masked_matmul_bf16_kernel<MT><<<grid, MMK_THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const MT*>(m),
      static_cast<__nv_bfloat16*>(y), (int)M, (int)K, (int)N);
  return (int)cudaGetLastError();
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
