// Fused carrier mix, mask and exclusive I/Q prefix sums for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel bds3_tpu/track/pallas_prefix.py:_mix_prefix
// (pallas_call at :106; body _kernel at :52, in-tile scan
// _tile_exclusive_prefix at :31).  Its plain PyTorch version is
// bds3_tpu_torch/track/prefix.py:mix_prefix_reference, and the wrapper is
// prefix.py:mix_prefix.  For channel c and sample j < n of the epoch window
// that starts at the absolute capture index cursor[c]:
//   x   = capture[cursor[c] + j] if j < blk[c] and inside the capture, else 0
//   cyc = mod1(base[c, j / 4096] + (j % 4096) * slope[c])
//   i   = x * cos(2 pi cyc),  q = -(x * sin(2 pi cyc))
//   P[c, x] = sum_{j < x} (i, q) for x = 0 .. n  (P[c, n] is the total).
//
// Design.  Two launches on the caller's stream.
//  1. mix_prefix_tiles: one thread block per (4096-sample tile, channel),
//     the TPU kernel's grid (C, T) with the phase tile as the block: each
//     tile has one `base`.  512 threads each mix 8 samples (loads of
//     neighbouring samples by neighbouring threads), stage them in shared
//     memory, and scan: a serial scan of the thread's 8 contiguous samples,
//     a warp-shuffle scan of the thread totals, and a scan of the 16 warp
//     totals.  The tile's exclusive prefix (without the carry from earlier
//     tiles) goes to P and the tile's total to tile_tot.
//  2. add_carry: one block per (tile, channel) again; the block sums the
//     totals of the earlier tiles in float64 (a block reduction in a fixed
//     order) and adds that carry to its 4096 entries (rounding once to
//     float32); the last tile's block writes P[c, n].  The reduction is
//     spread over the block because a serial sum by one thread (up to 242
//     dependent loads and adds at the B1C width) made this pass 2/3 of
//     the kernel's time.
// On the TPU the grid ran in order and carried the sums in SMEM scratch;
// here blocks run in no order, so the carry is a second pass.  No library
// scan (cub, thrust, torch.cumsum) is used.
//
// What bounds it.  Per sample one accurate sincosf and a few adds; the
// int8 capture is read once and P (8 bytes a sample) is written twice and
// read once.  At the B1C reference rate one epoch of 10 channels is
// 10 x 993,754 samples, ~2,400 blocks (~18 per SM): enough to fill the card,
// and ~240 MB of traffic.  So the kernel is bound by memory traffic and
// the sincosf, not by the scan.
//
// Exactness.  Built with -fmad=false (bds3_tpu_torch/_build.py) and never
// with --use_fast_math: the phase is rounded as the plain version rounds
// it, base + (float)(j % 4096) * slope, then a floor-mod into [0, 1), and
// sincosf is the accurate one.  The sums are taken in another order than
// torch.cumsum's, so the two agree to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define SPLIT 4096
#define THREADS 512
#define PER_THREAD (SPLIT / THREADS)   // 8
#define WARPS (THREADS / 32)           // 16

__device__ __forceinline__ float mod1(float x) {
  float r = fmodf(x, 1.0f);
  return r < 0.0f ? r + 1.0f : r;
}

// Exclusive scan of one tile; s holds the tile's values on entry and its
// exclusive prefixes on exit.  Returns the tile total to every thread.
__device__ __forceinline__ float tile_exclusive_scan(float* s,
                                                     float* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v[PER_THREAD];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    v[k] = run;                       // exclusive within the thread
    run += s[tid * PER_THREAD + k];
  }
  // inclusive scan of the thread totals across the warp
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (tid == 0) {                     // exclusive scan of the warp totals
    float acc = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      const float t = s_warp[w];
      s_warp[w] = acc;
      acc += t;
    }
    s_warp[WARPS] = acc;
  }
  __syncthreads();
  const float offset = s_warp[warp] + excl;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k)
    s[tid * PER_THREAD + k] = offset + v[k];
  const float total = s_warp[WARPS];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(THREADS)
mix_prefix_tiles(const int8_t* __restrict__ capture, long long total,
                 const long long* __restrict__ cursor,  // (C,)
                 const long long* __restrict__ blk,     // (C,)
                 const float* __restrict__ base,        // (C, T)
                 const float* __restrict__ slope,       // (C,)
                 int n, int n_tiles,
                 float* __restrict__ p_i,               // (C, n + 1)
                 float* __restrict__ p_q,               // (C, n + 1)
                 float* __restrict__ tile_tot) {        // (C, T, 2)
  __shared__ float s_i[SPLIT];
  __shared__ float s_q[SPLIT];
  __shared__ float s_warp[WARPS + 1];
  const int t = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const long long cur = cursor[c];
  const long long lim = blk[c] < (long long)n ? blk[c] : (long long)n;
  const float b = base[(size_t)c * n_tiles + t];
  const float sl = slope[c];
  const float two_pi = 6.283185307179586f;   // float32(2 pi), as in prefix.py

#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int lin = k * THREADS + tid;
    const long long j = (long long)t * SPLIT + lin;
    const long long g = cur + j;
    const float x =
        (j < lim && g >= 0 && g < total) ? (float)capture[g] : 0.0f;
    const float cyc = mod1(b + (float)lin * sl);
    float sn, cs;
    sincosf(two_pi * cyc, &sn, &cs);
    s_i[lin] = x * cs;
    s_q[lin] = -(x * sn);
  }
  __syncthreads();
  const float tot_i = tile_exclusive_scan(s_i, s_warp);
  const float tot_q = tile_exclusive_scan(s_q, s_warp);

  const size_t row = (size_t)c * (n + 1);
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int lin = k * THREADS + tid;
    const long long j = (long long)t * SPLIT + lin;
    if (j < n) {
      p_i[row + j] = s_i[lin];
      p_q[row + j] = s_q[lin];
    }
  }
  if (tid == 0) {
    tile_tot[((size_t)c * n_tiles + t) * 2] = tot_i;
    tile_tot[((size_t)c * n_tiles + t) * 2 + 1] = tot_q;
  }
}

__global__ void __launch_bounds__(THREADS)
add_carry(float* __restrict__ p_i, float* __restrict__ p_q,
          const float* __restrict__ tile_tot, int n, int n_tiles) {
  __shared__ double s_part[2][WARPS];
  __shared__ double s_carry[2];
  const int t = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)c * (n + 1);
  const float* tot = tile_tot + (size_t)c * n_tiles * 2;
  // carry = sum of the earlier tiles' totals, in float64: a strided sum
  // per thread, then a fixed shuffle tree, so the order never changes
  double ci = 0.0, cq = 0.0;
  for (int u = tid; u < t; u += THREADS) {
    ci += (double)tot[2 * u];
    cq += (double)tot[2 * u + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ci += __shfl_down_sync(0xffffffffu, ci, o);
    cq += __shfl_down_sync(0xffffffffu, cq, o);
  }
  if (lane == 0) {
    s_part[0][warp] = ci;
    s_part[1][warp] = cq;
  }
  __syncthreads();
  if (tid == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      a += s_part[0][w];
      b += s_part[1][w];
    }
    s_carry[0] = a;
    s_carry[1] = b;
    if (t == n_tiles - 1) {           // the window total
      p_i[row + n] = (float)(a + (double)tot[2 * t]);
      p_q[row + n] = (float)(b + (double)tot[2 * t + 1]);
    }
  }
  __syncthreads();
  if (t == 0) return;                 // carry 0: the tile is final
  const double carry_i = s_carry[0], carry_q = s_carry[1];
  // all 16 loads of a thread first, so that they are in flight together
  float vi[PER_THREAD], vq[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long j = (long long)t * SPLIT + k * THREADS + tid;
    vi[k] = j < n ? p_i[row + j] : 0.0f;
    vq[k] = j < n ? p_q[row + j] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long j = (long long)t * SPLIT + k * THREADS + tid;
    if (j < n) {
      p_i[row + j] = (float)((double)vi[k] + carry_i);
      p_q[row + j] = (float)((double)vq[k] + carry_q);
    }
  }
}

// Host entry point, called through ctypes.  Launches both passes on
// `stream` and does not synchronize; returns cudaGetLastError() (0 on
// success).  tile_tot is (C, ceil(n / 4096), 2) float32 scratch.
extern "C" int bds3_mix_prefix(const void* capture, long long total,
                               const void* cursor, const void* blk,
                               const void* base, const void* slope,
                               int n_channels, int n, void* p_i, void* p_q,
                               void* tile_tot, void* stream) {
  const int n_tiles = (n + SPLIT - 1) / SPLIT;
  const dim3 grid(n_tiles, n_channels);
  cudaStream_t s = (cudaStream_t)stream;
  mix_prefix_tiles<<<grid, THREADS, 0, s>>>(
      (const int8_t*)capture, total, (const long long*)cursor,
      (const long long*)blk, (const float*)base, (const float*)slope, n,
      n_tiles, (float*)p_i, (float*)p_q, (float*)tile_tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  add_carry<<<grid, THREADS, 0, s>>>((float*)p_i, (float*)p_q,
                                     (const float*)tile_tot, n, n_tiles);
  return (int)cudaGetLastError();
}
