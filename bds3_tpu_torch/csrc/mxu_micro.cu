// Matrix-throughput microbenchmark for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/mxu_micro.py:make_bench (pallas_call
// at :53), which measured the TPU's matrix unit.  Its plain PyTorch
// version is bds3_tpu_torch/benchmarks/mxu_micro.py:mxu_micro_reference,
// and the wrapper is mxu_micro.py:mxu_micro.  For a (M, K) float32 and b
// (K, N) it computes one float32 scalar
//   out = sum over (m, n) of sum_{i < iters} (a_i @ b)[m, n],
//   a_i = a + (float)i * 1e-9f
// (the i * 1e-9 term keeps the product inside the loop, as on the TPU), in
// one of three variants:
//   FP32   the product in true float32 (FFMA, not TF32: TF32 would round
//          the inputs to 10 bits, and the reference does not);
//   BF16   a_i rounded to bfloat16 (round to nearest even, as astype), b in
//          bfloat16, float32 accumulation on the tensor cores;
//   SPLIT  hi = bf16(a_i), lo = bf16(a_i - hi), b in bfloat16: two
//          tensor-core products into one float32 accumulator.
//
// Design.  The TPU ran one program on its one core; the card's counterpart
// is the whole card, so the M x N output is tiled over thread blocks, each
// of which keeps its tile's accumulator in registers for all iterations:
//  * BF16 and SPLIT: 4 warps, a 16 x 64 tile (16 x 16 a warp: two
//    m16n8 accumulators), through mma.sync.aligned.m16n8k16 with bf16
//    inputs and float32 accumulation.  The block's a rows (float32) and b
//    columns (bfloat16, transposed to n-major, the layout of the B
//    fragment) are loaded to shared memory once; each iteration every warp
//    reads its A fragments, adds the offset, rounds them to bf16 and issues
//    the products over K in steps of 16.
//  * FP32: 16 x 16 threads, a 64 x 64 tile (4 x 4 a thread, strided by 16),
//    a and b in shared memory once; each iteration, for every k, a thread
//    adds the offset to its 4 a values and does 16 explicit fmaf (the
//    build's -fmad=false does not touch an explicit fma).
// Rows and columns past M and N are computed and left out of the sum.  Each
// block writes one float64 partial (its threads' sums, reduced in a fixed
// order), and a second one-thread pass adds the partials in block order and
// rounds once: the result is deterministic.
//
// What bounds it.  2 M K N iters operations (twice that for SPLIT) against
// the card's dense peak for the type: the bf16 tensor-core rate, or the
// float32 FFMA rate; the bytes (a and b once) are negligible.  This first
// version is simple: mma.sync rather than wgmma, no TMA, no tuning, and a
// 16-row tile that wastes half of every fragment at M = 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { VAR_FP32 = 0, VAR_BF16 = 1, VAR_SPLIT = 2 };

// BF16 / SPLIT geometry
#define MMA_WARPS 4
#define MMA_TM 16
#define MMA_TN (MMA_WARPS * 16)
#define A_PAD 8      // floats of padding per shared a row
#define B_PAD 8      // bf16 of padding per shared b^T row
// FP32 geometry
#define F_T 16       // threads per block side
#define F_R 4        // values per thread side
#define F_TILE (F_T * F_R)

// The block's sum of v, in a fixed order, returned to thread 0 (tid is the
// thread's linear index): warp sums by shuffle, then the warp sums in order.
__device__ __forceinline__ double block_sum(double v, int tid,
                                           double* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int n_warps = (blockDim.x * blockDim.y) >> 5;
  if ((tid & 31) == 0) s_warp[tid >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (tid == 0)
    for (int w = 0; w < n_warps; ++w) total += s_warp[w];
  return total;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool SPLIT>
__global__ void __launch_bounds__(MMA_WARPS * 32)
mxu_mma(const float* __restrict__ a,              // (M, K)
        const __nv_bfloat16* __restrict__ b,      // (K, N)
        int M, int K, int N, int iters, double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int a_ld = K + A_PAD, b_ld = K + B_PAD;
  float* s_a = reinterpret_cast<float*>(smem);                  // [TM][a_ld]
  __nv_bfloat16* s_bt =
      reinterpret_cast<__nv_bfloat16*>(s_a + MMA_TM * a_ld);    // [TN][b_ld]
  __shared__ double s_warp[MMA_WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * MMA_TM, n0 = blockIdx.x * MMA_TN;
  for (int idx = tid; idx < MMA_TM * K; idx += blockDim.x) {
    const int r = idx / K, k = idx % K;
    s_a[r * a_ld + k] = (m0 + r < M) ? a[(size_t)(m0 + r) * K + k] : 0.0f;
  }
  for (int idx = tid; idx < K * MMA_TN; idx += blockDim.x) {
    const int k = idx / MMA_TN, c = idx % MMA_TN;   // coalesced along n
    s_bt[c * b_ld + k] = (n0 + c < N) ? b[(size_t)k * N + n0 + c]
                                      : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;      // mma group and thread in it
  const int wn = warp * 16;                   // the warp's 16 columns
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int i = 0; i < iters; ++i) {
    const float off = (float)i * 1e-9f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      // A fragment: rows g and g + 8, columns k0 + 2t (+1) and +8
      const float2 x0 = *reinterpret_cast<const float2*>(
          &s_a[g * a_ld + k0 + 2 * t]);
      const float2 x1 = *reinterpret_cast<const float2*>(
          &s_a[(g + 8) * a_ld + k0 + 2 * t]);
      const float2 x2 = *reinterpret_cast<const float2*>(
          &s_a[g * a_ld + k0 + 8 + 2 * t]);
      const float2 x3 = *reinterpret_cast<const float2*>(
          &s_a[(g + 8) * a_ld + k0 + 8 + 2 * t]);
      const float v[8] = {x0.x + off, x0.y + off, x1.x + off, x1.y + off,
                          x2.x + off, x2.y + off, x3.x + off, x3.y + off};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[r] = pack_bf16(v[2 * r], v[2 * r + 1]);
        if (SPLIT) {
          const float2 h = unpack_bf16(hi[r]);
          lo[r] = pack_bf16(v[2 * r] - h.x, v[2 * r + 1] - h.y);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // B fragment: column wn + 8 nt + g, rows k0 + 2t (+1) and +8
        const __nv_bfloat16* col = &s_bt[(wn + 8 * nt + g) * b_ld + k0];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col + 2 * t);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(col + 8 + 2 * t);
        mma_bf16(acc[nt], hi, b0, b1);
        if (SPLIT) mma_bf16(acc[nt], lo, b0, b1);
      }
    }
  }

  // C fragment: rows g (c0, c1) and g + 8 (c2, c3), columns 2t and 2t + 1
  double sum = 0.0;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + g + (e >> 1) * 8;
      const int col = n0 + wn + 8 * nt + 2 * t + (e & 1);
      if (row < M && col < N) sum += (double)acc[nt][e];
    }
  const double total = block_sum(sum, tid, s_warp);
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(F_T * F_T)
mxu_fp32(const float* __restrict__ a,   // (M, K)
         const float* __restrict__ b,   // (K, N)
         int M, int K, int N, int iters, double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int a_ld = K + 1;                                   // odd: no conflicts
  float* s_a = reinterpret_cast<float*>(smem);              // [TILE][a_ld]
  float* s_b = s_a + F_TILE * a_ld;                         // [K][TILE]
  __shared__ double s_warp[F_T * F_T / 32];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * F_T + tx;
  const int m0 = blockIdx.y * F_TILE, n0 = blockIdx.x * F_TILE;
  for (int idx = tid; idx < F_TILE * K; idx += F_T * F_T) {
    const int r = idx / K, k = idx % K;
    s_a[r * a_ld + k] = (m0 + r < M) ? a[(size_t)(m0 + r) * K + k] : 0.0f;
  }
  for (int idx = tid; idx < K * F_TILE; idx += F_T * F_T) {
    const int k = idx / F_TILE, c = idx % F_TILE;
    s_b[k * F_TILE + c] = (n0 + c < N) ? b[(size_t)k * N + n0 + c] : 0.0f;
  }
  __syncthreads();

  float acc[F_R][F_R];
#pragma unroll
  for (int r = 0; r < F_R; ++r)
#pragma unroll
    for (int c = 0; c < F_R; ++c) acc[r][c] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float off = (float)i * 1e-9f;
    for (int k = 0; k < K; ++k) {
      float av[F_R], bv[F_R];
#pragma unroll
      for (int r = 0; r < F_R; ++r) av[r] = s_a[(ty + F_T * r) * a_ld + k] + off;
#pragma unroll
      for (int c = 0; c < F_R; ++c) bv[c] = s_b[k * F_TILE + tx + F_T * c];
#pragma unroll
      for (int r = 0; r < F_R; ++r)
#pragma unroll
        for (int c = 0; c < F_R; ++c)
          acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
    }
  }

  double sum = 0.0;
#pragma unroll
  for (int r = 0; r < F_R; ++r)
#pragma unroll
    for (int c = 0; c < F_R; ++c)
      if (m0 + ty + F_T * r < M && n0 + tx + F_T * c < N)
        sum += (double)acc[r][c];
  const double total = block_sum(sum, tid, s_warp);
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

__global__ void sum_partials(const double* __restrict__ partials, int n,
                             float* __restrict__ out) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += partials[i];
  out[0] = (float)s;
}

// Launches the variant's kernel over the (ceil(N / tile_n), ceil(M /
// tile_m)) grid, then the partials' sum, on `stream`.  partials holds one
// double per block (the wrapper sizes it, mxu_micro.py:grid).  Returns the
// first CUDA error, or 0.
extern "C" int bds3_mxu_micro(const void* a, const void* b, int M, int K,
                              int N, int variant, int iters, void* partials,
                              void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  int n_blocks;
  if (variant == VAR_FP32) {
    const dim3 grid((N + F_TILE - 1) / F_TILE, (M + F_TILE - 1) / F_TILE);
    const size_t smem = (size_t)(F_TILE * (K + 1) + K * F_TILE) * 4;
    err = cudaFuncSetAttribute(mxu_fp32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mxu_fp32<<<grid, dim3(F_T, F_T), smem, s>>>(
        (const float*)a, (const float*)b, M, K, N, iters, (double*)partials);
    n_blocks = grid.x * grid.y;
  } else if (variant == VAR_BF16 || variant == VAR_SPLIT) {
    const dim3 grid((N + MMA_TN - 1) / MMA_TN, (M + MMA_TM - 1) / MMA_TM);
    const size_t smem = (size_t)MMA_TM * (K + A_PAD) * 4
                        + (size_t)MMA_TN * (K + B_PAD) * 2;
    auto kern = variant == VAR_SPLIT ? mxu_mma<true> : mxu_mma<false>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, MMA_WARPS * 32, smem, s>>>(
        (const float*)a, (const __nv_bfloat16*)b, M, K, N, iters,
        (double*)partials);
    n_blocks = grid.x * grid.y;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, 1, 0, s>>>((const double*)partials, n_blocks,
                               (float*)out);
  return (int)cudaGetLastError();
}
