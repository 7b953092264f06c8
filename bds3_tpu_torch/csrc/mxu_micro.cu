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
// What bounds it.  2 M K N iters operations (twice that for SPLIT) at the
// card's dense peak for the type (mxu_micro.py:PEAK_OPS): the bf16
// tensor-core rate, or the float32 FFMA rate.  The bytes (a and b once)
// bound no shape.
//
// Design.  The sum is one product of depth iters * K, [a_0 | ... |
// a_{iters-1}] @ [b; ...; b], whose A operand is generated on the fly:
// every multiply-add is done, nothing is folded (no (sum_i a_i) @ b).  The
// grid is output tiles x iteration chunks (the wrapper's planner,
// mxu_micro.py:plan, picks the tile and enough chunks to fill the 132 SMs
// at every shape, M = 8 included); chunk c covers iterations
// [c iters / chunks, (c + 1) iters / chunks).  A block loads its b tile and
// a rows once (per 16-deep k slab for FP32), runs its chunk with the sum in
// float32 registers and writes one float64 partial; a second pass adds the
// partials in block order on one thread and rounds once, so the result is
// deterministic.  Rows past M are computed and left out of the sum; b's
// columns past N are zero.
//  * BF16 and SPLIT: one warpgroup a block, a 64 x 256 tile, through
//    wgmma.mma_async.m64n256k16 with A from registers and B from shared
//    memory.  B is b^T in the no-swizzle K-major core-matrix layout (8 n
//    rows of 16 bytes each; LBO = the next 8 k, SBO = the next 8 n).  The A
//    fragment of warp w is the m16n8k16 A fragment of rows 16w..16w+15:
//    each warp reads its rows (float32, shared memory), adds the offset and
//    rounds with __floats2bfloat162_rn (hi, and lo for SPLIT) in
//    registers, once a warpgroup.  Each iteration runs in batches of KB
//    k steps (8, 4, 2 or 1, the most that divides K / 16, a template
//    parameter): the batch's fragments are built while no product is in
//    flight, then its KB (SPLIT: 2 KB, hi then lo) products are issued
//    without a branch, committed and waited for; the other block on the
//    SM fills the tensor cores meanwhile.  ptxas serializes every wgmma
//    of a kernel that writes a fragment register under a running product
//    (C7513) or puts a wgmma under a branch (C7520).
//    M < 64 (the M = 32 shapes) pads the rows with zeros instead of
//    swapping operands: those shapes waste half of every product.
//  * FP32: 64 or 128 threads of 8 x 8 outputs each (two float4 of rows and
//    two of columns, strided so a warp's 16-byte loads do not conflict), a
//    block tile of 8 TY x 8 TX chosen by the planner (8 x 512 at M = 8,
//    16 x 512 at M = 16: no wasted rows).  a and b come in 16-deep k slabs
//    through shared memory, and the block runs its whole chunk on each
//    slab; per k a thread does 4 LDS.128, 8 FADD (a + off, rounded as the
//    plain version rounds it) and 64 explicit __fmaf_rn (the build's
//    -fmad=false does not touch an explicit fma).
// Left for later: TMA loads, persistent blocks over the tiles, warp
// specialisation (building the next batch's fragments while this one
// runs), a swizzled B layout and operand swapping at M < 64.  Two
// warpgroups of n128 a block, and 8 x 16 FP32 outputs a thread, were
// slower (PERF.md, K3 findings).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { VAR_FP32 = 0, VAR_BF16 = 1, VAR_SPLIT = 2 };

// BF16 / SPLIT geometry: one warpgroup, a 64 x 256 tile
#define WG_THREADS 128
#define WG_TM 64
#define WG_TN 256
#define A_PAD 8      // floats of padding per shared a row
// FP32 geometry: 8 x 8 outputs a thread, 16-deep k slabs
#define F_R 8
#define F_KS 16
#define F_MAX_THREADS 128
// the partials' sum
#define SUM_THREADS 256
#define SUM_SLAB 2048

// The block's sum of v, in a fixed order, returned to thread 0 (tid is the
// thread's linear index): warp sums by shuffle, then the warp sums in order.
__device__ __forceinline__ double block_sum(double v, int tid,
                                           double* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int n_warps = blockDim.x >> 5;
  if ((tid & 31) == 0) s_warp[tid >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (tid == 0)
    for (int w = 0; w < n_warps; ++w) total += s_warp[w];
  return total;
}

// The first iteration of chunk c of `chunks` over [0, iters).
__device__ __forceinline__ int chunk_start(int c, int chunks, int iters) {
  return (int)((long long)c * iters / chunks);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of r across a wgmma
// fence, commit or wait (it sees no dependency through the asm above).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor, no swizzle (layout type 0): start
// address, LBO (leading: the next 8 k) and SBO (stride: the next 8 rows),
// each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                             uint32_t sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)

// d (64 x 256, float32, this thread's 128) += A (64 x 16, bf16, this
// thread's fragment a) @ B (16 x 256, bf16, K-major in shared memory).
__device__ __forceinline__ void wgmma_m64n256k16(float* d, const uint32_t* a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : D16(0), D16(16), D16(32), D16(48), D16(64), D16(80), D16(96),
        D16(112)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// This thread's A fragment of k step k0 of iteration offset off (rows g
// and g + 8 of the warp's 16, columns k0 + 2t (+1) and k0 + 8 + 2t (+1)),
// rounded to bf16: hi, and for SPLIT lo = bf16(a_i - hi).
template <bool SPLIT>
__device__ __forceinline__ void a_fragment(const float* s_a_rows, int a_ld,
                                           int k0, float off, uint32_t* hi,
                                           uint32_t* lo) {
  const float2 x0 = *reinterpret_cast<const float2*>(&s_a_rows[k0]);
  const float2 x1 =
      *reinterpret_cast<const float2*>(&s_a_rows[8 * a_ld + k0]);
  const float2 x2 = *reinterpret_cast<const float2*>(&s_a_rows[k0 + 8]);
  const float2 x3 =
      *reinterpret_cast<const float2*>(&s_a_rows[8 * a_ld + k0 + 8]);
  const float v[8] = {x0.x + off, x0.y + off, x1.x + off, x1.y + off,
                      x2.x + off, x2.y + off, x3.x + off, x3.y + off};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    hi[r] = pack_bf16(v[2 * r], v[2 * r + 1]);
    if (SPLIT) {
      const float2 h = unpack_bf16(hi[r]);
      lo[r] = pack_bf16(v[2 * r] - h.x, v[2 * r + 1] - h.y);
    }
  }
}

template <bool SPLIT, int KB>
__global__ void __launch_bounds__(WG_THREADS, 1)
mxu_wgmma(const float* __restrict__ a,              // (M, K)
          const __nv_bfloat16* __restrict__ b,      // (K, N)
          int M, int K, int N, int iters, int tiles_n,
          double* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  // b^T tile: core matrix (n / 8, k / 8) at 128 ((n / 8) (K / 8) + k / 8)
  // bytes, row n % 8 at 16 (n % 8), element k % 8 at 2 (k % 8)
  unsigned char* s_bt = smem;
  const int a_ld = K + A_PAD;
  float* s_a = reinterpret_cast<float*>(s_bt + (size_t)WG_TN * K * 2);
  __shared__ double s_warp[WG_THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (blockIdx.x / tiles_n) * WG_TM;
  const int n0 = (blockIdx.x % tiles_n) * WG_TN;
  const int lo_i = chunk_start(blockIdx.y, gridDim.y, iters);
  const int hi_i = chunk_start(blockIdx.y + 1, gridDim.y, iters);

  // b^T: thread task c is core matrix (n group c % 32, k chunk c / 32):
  // 8 rows of b, 16 bytes each, transposed in registers to 8 n rows
  const bool b_vec = N % 8 == 0 && ((uintptr_t)b & 15) == 0;
  const unsigned short* bh = reinterpret_cast<const unsigned short*>(b);
  for (int c = tid; c < (WG_TN / 8) * (K >> 3); c += WG_THREADS) {
    const int gn = c % (WG_TN / 8), kc = c / (WG_TN / 8);
    const int n = n0 + 8 * gn;
    uint32_t in[8][4];   // [k row][pair of n]
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const unsigned short* src = bh + (size_t)(8 * kc + r) * N + n;
      if (b_vec) {   // N % 8 == 0: the group is wholly in or out
        const uint4 v = n < N ? *reinterpret_cast<const uint4*>(src)
                              : make_uint4(0u, 0u, 0u, 0u);
        in[r][0] = v.x, in[r][1] = v.y, in[r][2] = v.z, in[r][3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          in[r][q] = (n + 2 * q < N ? (uint32_t)src[2 * q] : 0u)
                     | (n + 2 * q + 1 < N ? (uint32_t)src[2 * q + 1] << 16
                                          : 0u);
      }
    }
    unsigned char* dst = s_bt + (size_t)(gn * (K >> 3) + kc) * 128;
#pragma unroll
    for (int j = 0; j < 8; ++j) {   // row n + j: k pairs from rows 2q, 2q+1
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = __byte_perm(in[2 * q][j >> 1], in[2 * q + 1][j >> 1], sel);
      *reinterpret_cast<uint4*>(dst + 16 * j) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  const bool a_vec = ((uintptr_t)a & 15) == 0;
#pragma unroll 4
  for (int idx = tid; idx < WG_TM * (K >> 2); idx += WG_THREADS) {
    const int r = idx / (K >> 2), k = 4 * (idx % (K >> 2));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < M) {
      const float* src = a + (size_t)(m0 + r) * K + k;
      v = a_vec ? *reinterpret_cast<const float4*>(src)
                : make_float4(src[0], src[1], src[2], src[3]);
    }
    *reinterpret_cast<float4*>(&s_a[r * a_ld + k]) = v;
  }
  // the b^T writes are read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const float* s_a_rows = s_a + (16 * warp + g) * a_ld + 2 * t;
  const uint64_t desc0 = smem_desc(s_bt, 128, 128 * (K >> 3));
  float d[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) {
    d[j] = 0.0f;
    fence_operand(d[j]);
  }
  const int ksteps = K >> 4;
  // per iteration, batches of KB k steps (KB divides K / 16): build every
  // fragment of the batch, then issue its products (hi, then lo), commit
  // and wait.  Fragments are written only while no product is in flight,
  // and no product sits under a branch, so ptxas need not serialize the
  // wgmma; a k step's B starts 256 bytes (two core matrices along k, 16
  // descriptor units) after the previous one's.
#pragma unroll 1
  for (int i = lo_i; i < hi_i; ++i) {
    const float off = (float)i * 1e-9f;
#pragma unroll 1
    for (int kb = 0; kb < ksteps; kb += KB) {
      uint32_t hi[KB][4], lo[KB][4];
#pragma unroll
      for (int j = 0; j < KB; ++j)
        a_fragment<SPLIT>(s_a_rows, a_ld, 16 * (kb + j), off, hi[j], lo[j]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const uint64_t desc = desc0 + (uint64_t)(16 * (kb + j));
        wgmma_m64n256k16(d, hi[j], desc);
        if (SPLIT) wgmma_m64n256k16(d, lo[j], desc);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
#pragma unroll
  for (int j = 0; j < 128; ++j) fence_operand(d[j]);

  // accumulator: d[4 j + e] at row 16 warp + g + 8 (e >> 1), column
  // 8 j + 2 t + (e & 1)
  double sum = 0.0;
  const int row0 = m0 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1);
      const int col = n0 + 8 * j + 2 * t + (e & 1);
      if (row < M && col < N) sum += (double)d[4 * j + e];
    }
  const double total = block_sum(sum, tid, s_warp);
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// ---------------------------------------------------------------- FFMA

// TX threads along n (fastest), TY = blockDim.x / TX along m; the block
// tile is 8 TY x 8 TX.  Thread (ty, tx) owns rows 4 ty + {0..3} and
// 4 TY + 4 ty + {0..3}, columns 4 tx + {0..3} and 4 TX + 4 tx + {0..3}.
__global__ void __launch_bounds__(F_MAX_THREADS, 4)
mxu_fp32(const float* __restrict__ a,   // (M, K)
         const float* __restrict__ b,   // (K, N)
         int M, int K, int N, int iters, int tiles_n, int TX,
         double* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x, TY = nt / TX, BM = F_R * TY, BN = F_R * TX;
  float* s_a = reinterpret_cast<float*>(smem);   // [F_KS][BM]
  float* s_b = s_a + F_KS * BM;                  // [F_KS][BN]
  __shared__ double s_warp[F_MAX_THREADS / 32];

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int lo_i = chunk_start(blockIdx.y, gridDim.y, iters);
  const int hi_i = chunk_start(blockIdx.y + 1, gridDim.y, iters);

  const bool a_vec = ((uintptr_t)a & 15) == 0;
  const bool b_vec = N % 4 == 0 && ((uintptr_t)b & 15) == 0;
  float acc[F_R][F_R];
#pragma unroll
  for (int r = 0; r < F_R; ++r)
#pragma unroll
    for (int c = 0; c < F_R; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += F_KS) {
    __syncthreads();
    // 16-byte loads: 4 k of a row of a (stored k-major), 4 n of b
#pragma unroll 4
    for (int idx = tid; idx < BM * (F_KS / 4); idx += nt) {
      const int r = idx / (F_KS / 4), k = 4 * (idx % (F_KS / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M) {
        const float* src = a + (size_t)(m0 + r) * K + k0 + k;
        v = a_vec ? *reinterpret_cast<const float4*>(src)
                  : make_float4(src[0], src[1], src[2], src[3]);
      }
      s_a[k * BM + r] = v.x, s_a[(k + 1) * BM + r] = v.y;
      s_a[(k + 2) * BM + r] = v.z, s_a[(k + 3) * BM + r] = v.w;
    }
#pragma unroll 4
    for (int idx = tid; idx < F_KS * (BN / 4); idx += nt) {
      const int k = idx / (BN / 4), c = 4 * (idx % (BN / 4));
      const float* src = b + (size_t)(k0 + k) * N + n0 + c;
      float4 v;
      if (b_vec && n0 + c < N) {   // N % 4 == 0: all 4 in or out
        v = *reinterpret_cast<const float4*>(src);
      } else {
        v.x = n0 + c < N ? src[0] : 0.f;
        v.y = n0 + c + 1 < N ? src[1] : 0.f;
        v.z = n0 + c + 2 < N ? src[2] : 0.f;
        v.w = n0 + c + 3 < N ? src[3] : 0.f;
      }
      *reinterpret_cast<float4*>(&s_b[k * BN + c]) = v;
    }
    __syncthreads();
    const float* pa = s_a + 4 * ty;
    const float* pb = s_b + 4 * tx;
    for (int i = lo_i; i < hi_i; ++i) {
      const float off = (float)i * 1e-9f;
#pragma unroll 4
      for (int k = 0; k < F_KS; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(pa + k * BM);
        const float4 a1 =
            *reinterpret_cast<const float4*>(pa + k * BM + 4 * TY);
        const float4 b0 = *reinterpret_cast<const float4*>(pb + k * BN);
        const float4 b1 =
            *reinterpret_cast<const float4*>(pb + k * BN + 4 * TX);
        const float av[F_R] = {a0.x + off, a0.y + off, a0.z + off,
                               a0.w + off, a1.x + off, a1.y + off,
                               a1.z + off, a1.w + off};
        const float bv[F_R] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < F_R; ++r)
#pragma unroll
          for (int c = 0; c < F_R; ++c)
            acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
      }
    }
  }

  double sum = 0.0;
#pragma unroll
  for (int r = 0; r < F_R; ++r) {
    const int row = m0 + 4 * ty + (r & 3) + (r >> 2) * 4 * TY;
#pragma unroll
    for (int c = 0; c < F_R; ++c) {
      const int col = n0 + 4 * tx + (c & 3) + (c >> 2) * 4 * TX;
      if (row < M && col < N) sum += (double)acc[r][c];
    }
  }
  const double total = block_sum(sum, tid, s_warp);
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// The partials' sum: the block stages them in shared memory, SUM_SLAB at
// a time, and thread 0 adds them in block order (a dependent global load
// per partial would cost ~0.5 us each).
__global__ void __launch_bounds__(SUM_THREADS)
sum_partials(const double* __restrict__ partials, int n,
             float* __restrict__ out) {
  __shared__ double s_p[SUM_SLAB];
  double s = 0.0;
  for (int base = 0; base < n; base += SUM_SLAB) {
    const int m = min(SUM_SLAB, n - base);
    for (int i = threadIdx.x; i < m; i += SUM_THREADS)
      s_p[i] = partials[base + i];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < m; ++i) s += s_p[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)s;
}

// Raises kernel `slot`'s dynamic shared-memory limit to at least `bytes`,
// once per device and size (the call costs microseconds of host time).
static cudaError_t allow_smem(const void* kern, int slot, int bytes) {
  static int allowed[64][9];   // [device][slot]: bytes already allowed
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev][slot] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev][slot] = bytes;
  return err;
}

// Launches the variant's kernel over the (ceil(M / tile_m) ceil(N /
// tile_n), chunks) grid, then the partials' sum, on `stream`.  The tile is
// the planner's (mxu_micro.py:plan): 64 x 256 for BF16 and SPLIT; for FP32
// multiples of 8 with (tile_m / 8) (tile_n / 8) threads, a multiple of 32
// and at most 128.  partials holds one double per block.  Returns the
// first CUDA error, or 0.
extern "C" int bds3_mxu_micro(const void* a, const void* b, int M, int K,
                              int N, int variant, int iters, int tile_m,
                              int tile_n, int chunks, void* partials,
                              void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 16 || K % 16 || iters < 0 || chunks < 1
      || tile_m < 1 || tile_n < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (N + tile_n - 1) / tile_n;
  const dim3 grid(((M + tile_m - 1) / tile_m) * tiles_n, chunks);
  cudaError_t err;
  if (variant == VAR_FP32) {
    const int threads = (tile_m / F_R) * (tile_n / F_R);
    if (tile_m % F_R || tile_n % F_R || threads % 32
        || threads > F_MAX_THREADS)
      return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)F_KS * (tile_m + tile_n) * 4;
    err = allow_smem((const void*)mxu_fp32, 0, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mxu_fp32<<<grid, threads, smem, s>>>(
        (const float*)a, (const float*)b, M, K, N, iters, tiles_n,
        tile_n / F_R, (double*)partials);
  } else if (variant == VAR_BF16 || variant == VAR_SPLIT) {
    if (tile_m != WG_TM || tile_n != WG_TN) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)WG_TN * K * 2
                        + (size_t)WG_TM * (K + A_PAD) * 4;
    // the batch: the most of 8, 4, 2 and 1 k steps that divides K / 16
    const int ks = K / 16;
    const int kb = ks % 8 == 0 ? 8 : ks % 4 == 0 ? 4 : ks % 2 == 0 ? 2 : 1;
    const bool sp = variant == VAR_SPLIT;
    void (*kern)(const float*, const __nv_bfloat16*, int, int, int, int, int,
                 double*) =
        kb == 8   ? (sp ? mxu_wgmma<true, 8> : mxu_wgmma<false, 8>)
        : kb == 4 ? (sp ? mxu_wgmma<true, 4> : mxu_wgmma<false, 4>)
        : kb == 2 ? (sp ? mxu_wgmma<true, 2> : mxu_wgmma<false, 2>)
                  : (sp ? mxu_wgmma<true, 1> : mxu_wgmma<false, 1>);
    err = allow_smem((const void*)kern,
                     1 + 4 * sp + (kb == 8 ? 0 : kb == 4 ? 1 : kb == 2 ? 2 : 3),
                     (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, WG_THREADS, smem, s>>>(
        (const float*)a, (const __nv_bfloat16*)b, M, K, N, iters, tiles_n,
        (double*)partials);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, SUM_THREADS, 0, s>>>((const double*)partials,
                               (int)(grid.x * grid.y), (float*)out);
  return (int)cudaGetLastError();
}
