// Closed-loop tracking epochs for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel bds3_tpu/track/pallas_fused.py:fused_track_block
// (pallas_call at :1254).  One launch runs W closed-loop epochs for C
// channels; its plain PyTorch version is
// bds3_tpu_torch/track/scan.py:track_block_reference, and the wrapper is
// bds3_tpu_torch/track/fused.py:fused_track_block.
//
// Design.  One thread block per channel.  The W epochs are a loop inside
// the block: every epoch's window and chip indices depend on the previous
// epoch's loop-filter output, so the epochs of a channel cannot run in
// parallel (on the TPU they were the sequential grid axis).  The loop state
// (8 floats and an int64 absolute cursor) lives in shared memory.  Per
// epoch, every thread computes the epoch length from that state, then the
// threads stride over the epoch's samples: load the int8 sample (the
// warp's loads are coalesced), mix it with the local carrier, and add it,
// weighted by its chip, into 12 sums (I/Q x early/prompt/late x data/pilot).
// A warp-shuffle and shared-memory reduction gives thread 0 the 12 sums; it
// runs the discriminators, the 3rd-order PLL and 2nd-order DLL and the phase
// remainders, writes the packed output row, and updates the shared state.
// The code tables and the coarse phase tables sit in shared memory
// (2 x 10262 int8 plus under 1 KB at the B2a reference rate).
//
// What bounds it.  Each sample costs one sincosf, three chip-index
// computations and twelve multiply-adds; the int8 capture is read once
// (about 10^8 bytes per second of signal, far below the card's bandwidth).
// With one block per channel only C of the 132 SMs work, and each epoch
// ends in a block-wide reduction and a serial scalar tail, so the kernel is
// bound by latency, not by bytes or FLOPs.  Spreading an epoch over a
// thread-block cluster, staging the window with cp.async and capturing
// the block loop in a CUDA graph are later work.  None of the TPU
// kernel's machinery is carried over (prefix scratch, MXU one-hot
// selects, boundary tiles, the 4096-aligned DMA ring): the direct sum here
// is the same sum as its bucket form, regrouped (scan.py:171-173).
//
// Exactness.  The epoch length blksize = q0_int + ceil(resid) and each
// sample's chip index ceil(frac) must take the same branch as the plain
// version.  So:
//  * the file is compiled with -fmad=false (bds3_tpu_torch/_build.py):
//    nvcc would otherwise fuse a*b+c into one FMA and move the float32
//    rounding of `resid` (scan.py:128-130) and of `frac` (scan.py:87) off
//    PyTorch's, which runs each operation on its own.  Never build with
//    --use_fast_math;
//  * every expression keeps the reference's operation order, and divisions
//    by configuration constants are multiplications by the float32
//    reciprocal, as the plain version writes them;
//  * jnp.mod is a floor-mod: mod1() adds 1 to a negative fmodf result;
//  * the cursor is an absolute int64 sample index; the reference's cursor
//    is block-relative and shifted each block (driver.py:59,353), and only
//    cursor - start enters the math;
//  * atanf, as scan.py:223,232 call arctan (the TPU kernel's atan_poly
//    exists only because Mosaic has no atan).

#include <cuda_runtime.h>
#include <stdint.h>

#define N_CANON 29   // values one epoch produces (see TrackParams.slot)
#define MAX_TAPS 2   // data, pilot
#define N_ACC (MAX_TAPS * 6)
#define THREADS 512
#define SPLIT 4096
#define CODE_PAD 16

// Mirrors bds3_tpu_torch/track/fused.py:_Params field for field.
struct TrackParams {
  int n_channels, n_epochs, n_taps, m, lm, table_len, k_max, q0_int, n_max,
      n_slots;
  // Output column of each produced value, -1 where the config has none:
  // 0-5 data I_E I_P I_L Q_E Q_P Q_L, 6-11 the same for the pilot,
  // 12 carr_err 13 code_err 14 carr_nco 15 code_nco 16 d_cyc 17 d_step
  // 18 rem_code_phase 19 rem_carr_cyc 20 blksize, 21-28 the new state.
  int slot[N_CANON];
  float step_base, inv_step_base, inv_fs, q0_frac, q0_sum, q0_step_minus_l,
      sm, spacing, inv2pi, two_pi, pf1, pf2, pf3, dll_c1, dll_c2;
};

__device__ __forceinline__ float mod1(float x) {
  float r = fmodf(x, 1.0f);
  return r < 0.0f ? r + 1.0f : r;
}

__device__ __forceinline__ float eml(float ie, float qe, float il, float ql) {
  const float e = sqrtf(ie * ie + qe * qe);
  const float l = sqrtf(il * il + ql * ql);
  return (e - l) / (e + l);
}

__global__ void __launch_bounds__(THREADS)
track_fused_kernel(const int8_t* __restrict__ capture, long long total,
                   const int8_t* __restrict__ code,    // (C, taps, table_len)
                   const int* __restrict__ ck_int,     // (k_max,)
                   const float* __restrict__ ck_frac,  // (k_max,)
                   const float* __restrict__ carr_t,   // (C, k_max)
                   const float* __restrict__ a_base,   // (C,)
                   const float* __restrict__ q0_cyc,   // (C,)
                   const float* __restrict__ init_dstep,  // (C,)
                   const float* __restrict__ state_in,    // (C, 8)
                   const long long* __restrict__ cursor_in,  // (C,)
                   float* __restrict__ out,               // (W, C, n_slots)
                   float* __restrict__ state_out,         // (C, 8)
                   long long* __restrict__ cursor_out,    // (C,)
                   const TrackParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_ck_int = reinterpret_cast<int*>(smem);
  float* s_ck_frac = reinterpret_cast<float*>(s_ck_int + p.k_max);
  float* s_carr = s_ck_frac + p.k_max;
  int8_t* s_code = reinterpret_cast<int8_t*>(s_carr + p.k_max);

  __shared__ float s_state[8];
  __shared__ long long s_cursor;
  __shared__ float s_part[THREADS / 32][N_ACC];
  __shared__ float s_sum[N_ACC];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_warps = blockDim.x / 32;

  for (int i = tid; i < p.k_max; i += blockDim.x) {
    s_ck_int[i] = ck_int[i];
    s_ck_frac[i] = ck_frac[i];
    s_carr[i] = carr_t[(size_t)c * p.k_max + i];
  }
  const int8_t* code_c = code + (size_t)c * p.n_taps * p.table_len;
  for (int i = tid; i < p.n_taps * p.table_len; i += blockDim.x)
    s_code[i] = code_c[i];
  if (tid < 8) s_state[tid] = state_in[c * 8 + tid];
  if (tid == 0) s_cursor = cursor_in[c];
  const float ab = a_base[c];
  __syncthreads();

  const float mf = (float)p.m;
  for (int w = 0; w < p.n_epochs; ++w) {
    const float rem_code = s_state[0], rem_cyc = s_state[1];
    const float d_cyc = s_state[2], d_step = s_state[3];
    const long long cursor = s_cursor;

    // blksize = ceil((L - rem)/step) (scan.py:125-131)
    const float e_rel = d_step * p.inv_step_base;
    const float corr = (1.0f - e_rel) + e_rel * e_rel;
    const float resid =
        p.q0_frac - (rem_code * p.inv_step_base + p.q0_sum * e_rel) * corr;
    const int delta = (int)ceilf(resid);
    const int blksize = p.q0_int + delta;
    const int n = min(blksize, p.n_max);

    // early / prompt / late code phase at the epoch start, times m
    const float base[3] = {(rem_code + (-p.spacing)) * mf,
                           (rem_code + 0.0f) * mf,
                           (rem_code + p.spacing) * mf};
    const float dsm = d_step * mf;

    float acc[N_ACC];
#pragma unroll
    for (int i = 0; i < N_ACC; ++i) acc[i] = 0.0f;

    for (int j = tid; j < n; j += blockDim.x) {
      const long long g = cursor + j;
      const float x = (g >= 0 && g < total) ? (float)capture[g] : 0.0f;
      const int k = j / SPLIT;
      const float r_f = (float)(j % SPLIT);
      const float j_f = (float)j;
      // local carrier e^{-j theta} (scan.py:140-152)
      const float cyc = mod1(((s_carr[k] + rem_cyc) + r_f * ab) + j_f * d_cyc);
      float sn, cs;
      sincosf(p.two_pi * cyc, &sn, &cs);
      const float ib = x * cs;
      const float qb = -(x * sn);
      const float rsm = r_f * p.sm;
      const float jd = j_f * dsm;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        // chip index (scan.py:85-89): (ceil(chi*m) - 1) mod (L*m)
        const float frac = ((base[e] + s_ck_frac[k]) + rsm) + jd;
        int idx = (s_ck_int[k] + (int)ceilf(frac) - 1) % p.lm;
        if (idx < 0) idx += p.lm;
#pragma unroll
        for (int t = 0; t < MAX_TAPS; ++t) {
          if (t < p.n_taps) {
            const float cv = (float)s_code[t * p.table_len + idx + CODE_PAD];
            acc[t * 6 + e] += cv * ib;
            acc[t * 6 + 3 + e] += cv * qb;
          }
        }
      }
    }

    // block reduction: warp shuffles, then one partial per warp
#pragma unroll
    for (int i = 0; i < N_ACC; ++i) {
      float v = acc[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if ((tid & 31) == 0) s_part[tid >> 5][i] = v;
    }
    __syncthreads();
    if (tid < N_ACC) {
      float v = 0.0f;
      for (int wi = 0; wi < n_warps; ++wi) v += s_part[wi][tid];
      s_sum[tid] = v;
    }
    __syncthreads();

    if (tid == 0) {
      const float* o = s_sum;  // data I_E I_P I_L Q_E Q_P Q_L
      // discriminators (scan.py:216-235)
      const float carr_d = atanf(o[4] / o[1]) * p.inv2pi;
      const float code_d = eml(o[0], o[3], o[2], o[5]);
      float carr_err = carr_d, code_err = code_d;
      if (p.n_taps == 2) {
        // pilot pi/2 ahead of data; rotate back (tracking.m:341-353)
        const float* q = o + 6;
        const float carr_p = atanf(-q[1] / q[4]) * p.inv2pi;
        const float code_p = eml(q[0], q[3], q[2], q[5]);
        carr_err = 0.5f * (carr_d + carr_p);
        code_err = 0.5f * (code_d + code_p);
      }
      const float code_nco = s_state[4], code_error = s_state[5];
      const float d1_carr = s_state[6], d2_carr = s_state[7];

      // loop filters (scan.py:298-306)
      const float d2_new = d2_carr + carr_err * p.pf3;
      const float d1_new = (d2_new + carr_err * p.pf2) + d1_carr;
      const float carr_nco = d1_new + carr_err * p.pf1;
      const float d_cyc_new = carr_nco * p.inv_fs;
      const float code_nco_new =
          (code_nco + p.dll_c1 * (code_err - code_error)) + code_err * p.dll_c2;
      const float d_step_new = init_dstep[c] - code_nco_new * p.inv_fs;

      // phase remainders (scan.py:308-317)
      const float delta_f = (float)delta, blk_f = (float)blksize;
      const float rem_cyc_new =
          mod1(((rem_cyc + q0_cyc[c]) + delta_f * ab) + blk_f * d_cyc);
      const float rem_code_new =
          ((rem_code + p.q0_step_minus_l) + delta_f * p.step_base) +
          blk_f * d_step;

      float v[N_CANON];
#pragma unroll
      for (int i = 0; i < N_ACC; ++i) v[i] = o[i];
      v[12] = carr_err;
      v[13] = code_err;
      v[14] = carr_nco;
      v[15] = code_nco_new;
      v[16] = d_cyc;
      v[17] = d_step;
      v[18] = rem_code;
      v[19] = rem_cyc;
      v[20] = blk_f;
      v[21] = rem_code_new;
      v[22] = rem_cyc_new;
      v[23] = d_cyc_new;
      v[24] = d_step_new;
      v[25] = code_nco_new;
      v[26] = code_err;
      v[27] = d1_new;
      v[28] = d2_new;
      float* row = out + ((size_t)w * p.n_channels + c) * p.n_slots;
#pragma unroll
      for (int i = 0; i < N_CANON; ++i)
        if (p.slot[i] >= 0) row[p.slot[i]] = v[i];
#pragma unroll
      for (int i = 0; i < 8; ++i) s_state[i] = v[21 + i];
      s_cursor = cursor + blksize;
    }
    __syncthreads();
  }

  if (tid < 8) state_out[c * 8 + tid] = s_state[tid];
  if (tid == 0) cursor_out[c] = s_cursor;
}

// Host entry point, called through ctypes.  Launches on `stream` and does
// not synchronize; returns cudaGetLastError() (0 on success).
extern "C" int bds3_track_fused(const void* capture, long long total,
                                const void* code, const void* ck_int,
                                const void* ck_frac, const void* carr_t,
                                const void* a_base, const void* q0_cyc,
                                const void* init_dstep, const void* state_in,
                                const void* cursor_in, void* out,
                                void* state_out, void* cursor_out,
                                const TrackParams* params, void* stream) {
  const TrackParams p = *params;
  const size_t smem = (size_t)p.k_max * 12 + (size_t)p.n_taps * p.table_len;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        track_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  track_fused_kernel<<<p.n_channels, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)capture, total, (const int8_t*)code, (const int*)ck_int,
      (const float*)ck_frac, (const float*)carr_t, (const float*)a_base,
      (const float*)q0_cyc, (const float*)init_dstep, (const float*)state_in,
      (const long long*)cursor_in, (float*)out, (float*)state_out,
      (long long*)cursor_out, p);
  return (int)cudaGetLastError();
}
