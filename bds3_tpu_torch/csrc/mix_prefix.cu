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
// Design.  One launch on the caller's stream, one thread block of 512
// threads per (4096-sample tile, channel): the TPU kernel's grid (C, T),
// whose phase tile is the block (each tile has one `base`).  On the TPU the
// grid ran in order and carried the sums in SMEM scratch; here blocks run
// in no order, so each block looks back at the totals that the earlier
// tiles of its channel publish:
//  1. Thread 0 takes a tile ticket from an atomic counter in the scratch.
//     Tickets run tile by tile across the channels, so a tile's
//     predecessors took their tickets at least C tickets earlier.  A block
//     waits only on tiles with smaller tickets, whose blocks have started
//     and publish without waiting: the kernel makes progress in any
//     schedule.
//  2. Each thread mixes 8 contiguous samples and scans them serially,
//     writing each exclusive prefix straight to shared memory (padded one
//     word in 32, so that neither this layout nor the coalesced one of the
//     stores conflicts on a bank; the registers left free let 4 blocks share
//     an SM).  The thread totals are scanned by warp shuffles, the 16 warp
//     totals serially; all in float32.
//  3. Thread 0 publishes the tile's float32 (I, Q) total, each in one
//     64-bit word beside the call's generation number (st.release.gpu).
//  4. The block polls the words of every earlier tile of its channel until
//     they carry this call's generation, and sums the totals in float64: a
//     strided sum per thread, a fixed shuffle tree, then the 16 warp sums
//     in order.  The order never depends on the schedule, so P is the same
//     bit for bit from run to run.
//  5. It writes its 4096 prefixes once, each the float32 rounding of the
//     float64 sum of carry and in-tile prefix, in coalesced rows; the last
//     tile also writes P[c, n].  P is never read back.
// The block that takes the last ticket resets the counter and advances the
// generation, so the scratch is ready for the next call on the stream with
// no memset and no second kernel; totals left by an earlier call, of any
// shape, carry an older generation and are never taken.  A wait that
// outlasts 2 s (a scratch not made by prefix.buffers, or shared by two
// calls at once) traps, an error rather than a hang.  No library scan
// (cub, thrust, torch.cumsum) is used.
//
// What bounds it.  Per sample one accurate sincosf and a few adds; the
// int8 capture is read once and P (8 bytes a sample) written once: 9 bytes
// a sample, ~89 MB for one B1C epoch of 10 x 993,754 samples (2,430
// blocks): 26 us at an H100 SXM's 3.35 TB/s (700 W).  What holds it back
// is the look-back: each block waits for the slowest earlier tile of its
// channel while it holds one of the SM's 4 block slots (see PERF.md).
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
#define MIN_BLOCKS 4                   // 4 x 512 threads: 32 registers
#define PADDED (SPLIT + SPLIT / 32)    // shared words of one padded tile
// scratch, in 64-bit words: the ticket counter, the generation, then for
// each (channel, tile) the I and Q totals as (generation << 32 | bits)
#define HEADER 2
#define WAIT_LIMIT_NS 2000000000ull

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// floor-mod into [0, 1), as torch.remainder(x, 1.0) rounds it
__device__ __forceinline__ float mod1(float x) { return x - floorf(x); }

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long take_ticket(
    unsigned long long* counter) {
  unsigned long long v;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
               : "=l"(v) : "l"(counter) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long published(unsigned gen,
                                                        float v) {
  return ((unsigned long long)gen << 32) | __float_as_uint(v);
}

// A total an earlier tile published in this call (generation `gen`).  The
// total travels in the same 64-bit word as its generation, so a relaxed
// load that sees the generation sees the total: no acquire is needed (and
// on this card an acquire load invalidates the SM's L1 at every poll).
__device__ __forceinline__ float wait_total(const unsigned long long* p,
                                            unsigned gen) {
  unsigned long long w = ld_relaxed(p);
  if ((unsigned)(w >> 32) != gen) {
    const unsigned long long t0 = globaltimer();
    do {
      __nanosleep(64);
      w = ld_relaxed(p);
      if ((unsigned)(w >> 32) != gen && globaltimer() - t0 > WAIT_LIMIT_NS)
        __trap();
    } while ((unsigned)(w >> 32) != gen);
  }
  return __uint_as_float((unsigned)w);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mix_prefix_kernel(const int8_t* __restrict__ capture, long long total,
                  const long long* __restrict__ cursor,  // (C,)
                  const long long* __restrict__ blk,     // (C,)
                  const float* __restrict__ base,        // (C, T)
                  const float* __restrict__ slope,       // (C,)
                  int n, int n_tiles, int n_channels,
                  float* __restrict__ p_i,               // (C, n + 1)
                  float* __restrict__ p_q,               // (C, n + 1)
                  unsigned long long* scratch) {
  // the tile's prefixes within each thread, then each thread's offset
  __shared__ float s_i[PADDED];
  __shared__ float s_q[PADDED];
  __shared__ float s_off[2][THREADS];
  __shared__ float s_warp[2][WARPS + 1];
  __shared__ double s_part[2][WARPS];
  __shared__ double s_carry[2];
  __shared__ unsigned long long s_ticket;
  __shared__ unsigned s_gen;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long n_blocks =
      (unsigned long long)n_tiles * n_channels;

  if (tid == 0) {
    unsigned long long* counter = scratch;
    unsigned long long* epoch = scratch + 1;
    const unsigned e = (unsigned)ld_relaxed(epoch);
    const unsigned long long k = take_ticket(counter);
    if (k >= n_blocks) __trap();                   // a foreign scratch
    if (k == n_blocks - 1) {
      // the last ticket: every block has read the generation, so ready
      // the scratch for the next call (generations 1 .. 2^32 - 1)
      st_relaxed(counter, 0ull);
      st_relaxed(epoch, e + 1u == 0xffffffffu ? 0ull : e + 1ull);
    }
    s_ticket = k;
    s_gen = e + 1u;
  }
  __syncthreads();
  // tickets run tile by tile across the channels: a tile's predecessors
  // started n_channels tickets or more before it
  const int c = (int)(s_ticket % n_channels);
  const int t = (int)(s_ticket / n_channels);
  const unsigned gen = s_gen;
  unsigned long long* tot = scratch + HEADER + 2 * (size_t)c * n_tiles;

  // mix this thread's 8 contiguous samples and scan them, each sample's
  // exclusive prefix within the thread going to shared memory
  const long long cur = cursor[c];
  const long long lim = blk[c] < (long long)n ? blk[c] : (long long)n;
  const float b = base[(size_t)c * n_tiles + t];
  const float sl = slope[c];
  const float two_pi = 6.283185307179586f;   // float32(2 pi), as in prefix.py
  const long long j0 = (long long)t * SPLIT + tid * PER_THREAD;
  float run_i = 0.0f, run_q = 0.0f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int lin = tid * PER_THREAD + k;
    const long long j = j0 + k, g = cur + j;
    const float x =
        (j < lim && g >= 0 && g < total) ? (float)capture[g] : 0.0f;
    const float cyc = mod1(b + (float)lin * sl);
    float sn, cs;
    sincosf(two_pi * cyc, &sn, &cs);
    s_i[padded(lin)] = run_i;
    s_q[padded(lin)] = run_q;
    run_i += x * cs;
    run_q += -(x * sn);
  }

  // the thread totals across the warp, then the warp totals in order
  float inc_i = run_i, inc_q = run_q;  // inclusive across the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float yi = __shfl_up_sync(0xffffffffu, inc_i, o);
    const float yq = __shfl_up_sync(0xffffffffu, inc_q, o);
    if (lane >= o) {
      inc_i += yi;
      inc_q += yq;
    }
  }
  float ex_i = __shfl_up_sync(0xffffffffu, inc_i, 1);
  float ex_q = __shfl_up_sync(0xffffffffu, inc_q, 1);
  if (lane == 0) ex_i = ex_q = 0.0f;
  if (lane == 31) {
    s_warp[0][warp] = inc_i;
    s_warp[1][warp] = inc_q;
  }
  __syncthreads();
  if (tid == 0 || tid == 32) {        // exclusive scan of the warp totals
    float* sw = s_warp[tid >> 5];
    float acc = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      const float v = sw[w];
      sw[w] = acc;
      acc += v;
    }
    sw[WARPS] = acc;
  }
  __syncthreads();
  const float tot_i = s_warp[0][WARPS], tot_q = s_warp[1][WARPS];
  if (tid == 0) {
    st_release(tot + 2 * t, published(gen, tot_i));
    st_release(tot + 2 * t + 1, published(gen, tot_q));
  }
  s_off[0][tid] = s_warp[0][warp] + ex_i;
  s_off[1][tid] = s_warp[1][warp] + ex_q;

  // carry = sum of the earlier tiles' totals, in float64: a strided sum
  // per thread, then a fixed shuffle tree, so the order never changes
  double ci = 0.0, cq = 0.0;
  for (int u = tid; u < t; u += THREADS) {
    ci += (double)wait_total(tot + 2 * u, gen);
    cq += (double)wait_total(tot + 2 * u + 1, gen);
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
  float* out_i = p_i + (size_t)c * (n + 1);
  float* out_q = p_q + (size_t)c * (n + 1);
  if (tid == 0) {
    double a = 0.0, d = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      a += s_part[0][w];
      d += s_part[1][w];
    }
    s_carry[0] = a;
    s_carry[1] = d;
    if (t == n_tiles - 1) {           // the window total
      out_i[n] = (float)(a + (double)tot_i);
      out_q[n] = (float)(d + (double)tot_q);
    }
  }
  __syncthreads();

  // the prefixes, once, in coalesced rows
  const double carry_i = s_carry[0], carry_q = s_carry[1];
  const int left = n - t * SPLIT;     // samples of this tile in the window
  out_i += (size_t)t * SPLIT;
  out_q += (size_t)t * SPLIT;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int lin = k * THREADS + tid;
    if (lin < left) {
      float a = s_off[0][lin >> 3] + s_i[padded(lin)];
      float d = s_off[1][lin >> 3] + s_q[padded(lin)];
      if (t > 0) {                    // carry 0: the tile is final
        a = (float)((double)a + carry_i);
        d = (float)((double)d + carry_q);
      }
      out_i[lin] = a;
      out_q[lin] = d;
    }
  }
}

// Host entry point, called through ctypes.  One launch on `stream`, not
// synchronized; returns cudaGetLastError() (0 on success).  scratch is
// prefix.buffers' int64 words, at least 2 + 2 * C * ceil(n / 4096), zero
// before the first call and left ready for the next by each call.
extern "C" int bds3_mix_prefix(const void* capture, long long total,
                               const void* cursor, const void* blk,
                               const void* base, const void* slope,
                               int n_channels, int n, void* p_i, void* p_q,
                               void* scratch, void* stream) {
  const int n_tiles = (n + SPLIT - 1) / SPLIT;
  const long long n_blocks = (long long)n_tiles * n_channels;
  mix_prefix_kernel<<<(unsigned)n_blocks, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int8_t*)capture, total, (const long long*)cursor,
      (const long long*)blk, (const float*)base, (const float*)slope, n,
      n_tiles, n_channels, (float*)p_i, (float*)p_q,
      (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}
