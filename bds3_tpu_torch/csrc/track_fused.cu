// Closed-loop tracking epochs for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel bds3_tpu/track/pallas_fused.py:fused_track_block
// (pallas_call at :1254).  One launch runs W closed-loop epochs for C
// channels; its plain PyTorch version is
// bds3_tpu_torch/track/scan.py:track_block_reference, and the wrapper is
// bds3_tpu_torch/track/fused.py:fused_track_block.
//
// It takes B2a in every track mode and B1C in every track mode: data-only,
// narrowband (data and pilot BOC(1,1) at m = 2 table entries per chip) and
// wideband QMBOC (those two, plus the pilot's BOC(6,1) component at m = 12
// with its own coarse code-phase table and, for the "split" blend, its own
// E-L spacing), with the composite pilot and the four code blends
// (pallas_fused.py:1019-1073, scan.py:243-296).
//
// Design.  One thread block per channel.  The W epochs are a loop inside
// the block: every epoch's window and chip indices depend on the previous
// epoch's loop-filter output, so the epochs of a channel cannot run in
// parallel (on the TPU they were the sequential grid axis).  The loop state
// (8 floats and an int64 absolute cursor) lives in shared memory.  Per
// epoch, every thread computes the epoch length from that state, then the
// threads stride over the epoch's samples: load the int8 sample (the
// warp's loads are coalesced), mix it with the local carrier, and add it,
// weighted by its chip, into up to 18 sums (I/Q x early/prompt/late x
// data/pilot BOC(1,1)/pilot BOC(6,1)).  A warp-shuffle and shared-memory
// reduction gives thread 0 the sums; it runs the discriminators, the
// 3rd-order PLL and 2nd-order DLL and the phase remainders, writes the
// packed output row, and updates the shared state.  Each thread's sums
// are compensated (Kahan) and the block reduces them in float64, so a
// correlator is its exact sum rounded once to float32, as the plain
// version's float64 sum is.  The two then agree to float32 rounding, not
// to the ~1e-3 of mean|Q| that two float32 summation orders of ~1e6
// samples leave on B1C's small BOC(6,1) Q correlators; and over a long
// closed loop they stay together (a sum that rounds to another float32
// moves the loop state, and 250 epochs amplify that to ~5e-3: measured
// with float32 runs of 32 samples added in float64, which were 15%
// faster on B2a but not exact enough).  The code tables and
// the coarse phase tables sit in shared memory: 2 x 10262 int8 plus under
// 1 KB at the B2a reference rate; at the B1C preset (99.375 Msps) 2 x 20492
// int8 for the BOC(1,1) tables, 122792 int8 for BOC(6,1) and 245 x 20 bytes
// of coarse tables, 168676 bytes of the 232448 a block may opt in to.
//
// What bounds it.  Each sample costs one sincosf, three chip-index
// computations (six for B1C wideband) and up to twelve multiply-adds
// (eighteen); the int8 capture is read once (about 10^8 bytes per second
// of signal, far below the card's bandwidth).
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
//    exists only because Mosaic has no atan);
//  * the constants the reference writes as Python expressions (1 - f, g61,
//    W11, W61) arrive in the parameter block as the float32 values JAX
//    casts them to (scan.py:loop_constants), never formed here in float32.
//    At 99.375 Msps the BOC(6,1) index `frac` (m = 12) reaches about 500,
//    where one float32 ulp is 6e-5 of a table entry, so it must round as the
//    plain version's does: the same operations in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#define N_CANON 41   // values one epoch produces (see TrackParams.slot)
#define MAX_TAPS 3   // data, pilot BOC(1,1), pilot BOC(6,1)
#define N_ACC (MAX_TAPS * 6)
#define THREADS 512
#define SPLIT 4096
#define CODE_PAD 16

// canonical value indices (fused.py:_CANON)
#define V_D 0        // data I_E I_P I_L Q_E Q_P Q_L
#define V_P11 6      // pilot BOC(1,1), same order
#define V_P61 12     // pilot BOC(6,1), same order
#define V_PC 18      // QMBOC composite pilot, same order
#define V_TAIL 24    // carr_err code_err carr_nco code_nco d_cyc d_step
                     // rem_code_phase rem_carr_cyc blksize
#define V_STATE 33   // the new state, STATE_FIELDS order

// wb_code_blend codes (fused.py:_BLENDS)
#define BLEND_COMPOSITE 0
#define BLEND_NB 1
#define BLEND_SPLIT 2
#define BLEND_DOTPROD 3

// Mirrors bds3_tpu_torch/track/fused.py:_Params field for field.
struct TrackParams {
  int n_channels, n_epochs, n_taps, m, lm, table_len, k_max, q0_int, n_max,
      n_slots, b1c, wideband, blend, m61, lm61, table_len61;
  // Output column of each produced value (the V_* indices above), -1
  // where the config has none.
  int slot[N_CANON];
  float step_base, inv_step_base, inv_fs, q0_frac, q0_sum, q0_step_minus_l,
      sm, spacing, inv2pi, two_pi, pf1, pf2, pf3, dll_c1, dll_c2,
      one_minus_spacing, inv40, w11, w61, spacing61, dll_f, one_minus_dll_f,
      g61, sm61;
};

// sum += v with the rounding error carried in c (Kahan); -fmad=false and
// nvcc's IEEE defaults keep the compensation from being folded away
__device__ __forceinline__ void kahan_add(float& sum, float& c, float v) {
  const float y = v - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

__device__ __forceinline__ float mod1(float x) {
  float r = fmodf(x, 1.0f);
  return r < 0.0f ? r + 1.0f : r;
}

__device__ __forceinline__ float eml(float ie, float qe, float il, float ql) {
  const float e = sqrtf(ie * ie + qe * qe);
  const float l = sqrtf(il * il + ql * ql);
  return (e - l) / (e + l);
}

// eml over one tap's six sums, I_E I_P I_L Q_E Q_P Q_L
__device__ __forceinline__ float eml6(const float* a) {
  return eml(a[0], a[3], a[2], a[5]);
}

// (carr_err, code_err) of one epoch from its sums v[0, V_PC) (scan.py:
// 223-296); B1C wideband also writes the composite pilot to v[V_PC..].
__device__ void discriminators(const TrackParams& p, float* v,
                               float* carr_err, float* code_err) {
  const float* d = v + V_D;
  const float* q11 = v + V_P11;
  const float carr_d = atanf(d[4] / d[1]) * p.inv2pi;
  float code_d = eml6(d);
  if (p.b1c) code_d = code_d * p.one_minus_spacing;  // WB_tracking.m:409-410
  if (p.n_taps == 1) {
    *carr_err = carr_d;
    *code_err = code_d;
    return;
  }
  if (!p.wideband) {
    // pilot pi/2 ahead of data; rotate back (tracking.m:341-353)
    const float carr_p = atanf(-q11[1] / q11[4]) * p.inv2pi;
    float code_p = eml6(q11);
    if (p.b1c) {
      // narrowband 11/29 power weighting (NB_tracking.m:353-384)
      code_p = code_p * p.one_minus_spacing;
      *carr_err = (carr_d * 11.0f + carr_p * 29.0f) * p.inv40;
      *code_err = (code_d * 11.0f + code_p * 29.0f) * p.inv40;
    } else {
      *carr_err = 0.5f * (carr_d + carr_p);
      *code_err = 0.5f * (code_d + code_p);
    }
    return;
  }
  // B1C wideband QMBOC composite pilot (WB_tracking.m:374-396,414-419)
  const float* q61 = v + V_P61;
  float* pc = v + V_PC;
  for (int e = 0; e < 3; ++e) {
    pc[e] = (-p.w61) * q61[e] + p.w11 * q11[3 + e];
    pc[3 + e] = (-p.w61) * q61[3 + e] - p.w11 * q11[e];
  }
  const float carr_p = atanf(pc[4] / pc[1]) * p.inv2pi;
  *carr_err = (carr_d + 3.0f * carr_p) * 0.25f;
  float code_p;
  if (p.blend == BLEND_NB) {
    const float code_p11 = eml6(q11) * p.one_minus_spacing;
    *code_err = (code_d * 11.0f + code_p11 * 29.0f) * p.inv40;
    return;
  } else if (p.blend == BLEND_SPLIT) {
    const float code_p11 = eml6(q11) * p.one_minus_spacing;
    const float code_p61 = eml6(q61) * p.g61;
    code_p = 0.3f * code_p11 + 0.7f * code_p61;
  } else if (p.blend == BLEND_DOTPROD) {
    const float dp_num = (pc[0] - pc[2]) * pc[1] + (pc[3] - pc[5]) * pc[4];
    const float dp_den = pc[1] * pc[1] + pc[4] * pc[4];
    code_p = 0.25f * dp_num / dp_den * p.one_minus_spacing;
  } else {
    code_p = eml6(pc) * p.one_minus_spacing;
  }
  *code_err = code_d * p.dll_f + code_p * p.one_minus_dll_f;
}

// Chip index (scan.py:85-89): (ck_int + ceil(chi*m) - 1) mod (L*m).
__device__ __forceinline__ int chip_index(float base_m, float ck_frac,
                                          int ck_int, float rsm, float jd,
                                          int lm) {
  const float frac = ((base_m + ck_frac) + rsm) + jd;
  int idx = (ck_int + (int)ceilf(frac) - 1) % lm;
  return idx < 0 ? idx + lm : idx;
}

__global__ void __launch_bounds__(THREADS)
track_fused_kernel(const int8_t* __restrict__ capture, long long total,
                   const int8_t* __restrict__ code,    // (C, taps, table_len)
                   const int* __restrict__ ck_int,     // (k_max,)
                   const float* __restrict__ ck_frac,  // (k_max,)
                   const int8_t* __restrict__ code61,  // (C, table_len61)
                   const int* __restrict__ ck61_int,     // (k_max,)
                   const float* __restrict__ ck61_frac,  // (k_max,)
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
  const int k_wb = p.wideband ? p.k_max : 0;
  int* s_ck_int = reinterpret_cast<int*>(smem);
  float* s_ck_frac = reinterpret_cast<float*>(s_ck_int + p.k_max);
  float* s_carr = s_ck_frac + p.k_max;
  int* s_ck61_int = reinterpret_cast<int*>(s_carr + p.k_max);
  float* s_ck61_frac = reinterpret_cast<float*>(s_ck61_int + k_wb);
  int8_t* s_code = reinterpret_cast<int8_t*>(s_ck61_frac + k_wb);
  int8_t* s_code61 = s_code + p.n_taps * p.table_len;

  __shared__ float s_state[8];
  __shared__ long long s_cursor;
  __shared__ double s_part[THREADS / 32][N_ACC];
  __shared__ float s_sum[N_ACC];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_warps = blockDim.x / 32;

  for (int i = tid; i < p.k_max; i += blockDim.x) {
    s_ck_int[i] = ck_int[i];
    s_ck_frac[i] = ck_frac[i];
    s_carr[i] = carr_t[(size_t)c * p.k_max + i];
  }
  for (int i = tid; i < k_wb; i += blockDim.x) {
    s_ck61_int[i] = ck61_int[i];
    s_ck61_frac[i] = ck61_frac[i];
  }
  const int8_t* code_c = code + (size_t)c * p.n_taps * p.table_len;
  for (int i = tid; i < p.n_taps * p.table_len; i += blockDim.x)
    s_code[i] = code_c[i];
  if (p.wideband) {
    const int8_t* code61_c = code61 + (size_t)c * p.table_len61;
    for (int i = tid; i < p.table_len61; i += blockDim.x)
      s_code61[i] = code61_c[i];
  }
  if (tid < 8) s_state[tid] = state_in[c * 8 + tid];
  if (tid == 0) s_cursor = cursor_in[c];
  const float ab = a_base[c];
  __syncthreads();

  const float mf = (float)p.m, m61f = (float)p.m61;
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
    const float base61[3] = {(rem_code + (-p.spacing61)) * m61f,
                             (rem_code + 0.0f) * m61f,
                             (rem_code + p.spacing61) * m61f};
    const float dsm = d_step * mf;
    const float dsm61 = d_step * m61f;

    float acc[N_ACC], comp[N_ACC];
#pragma unroll
    for (int i = 0; i < N_ACC; ++i) acc[i] = comp[i] = 0.0f;

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
        const int idx = chip_index(base[e], s_ck_frac[k], s_ck_int[k], rsm,
                                   jd, p.lm);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t < p.n_taps) {
            const float cv = (float)s_code[t * p.table_len + idx + CODE_PAD];
            kahan_add(acc[t * 6 + e], comp[t * 6 + e], cv * ib);
            kahan_add(acc[t * 6 + 3 + e], comp[t * 6 + 3 + e], cv * qb);
          }
        }
      }
      if (p.wideband) {
        // the BOC(6,1) pilot at m = 12, its own coarse table and spacing
        const float rsm61 = r_f * p.sm61;
        const float jd61 = j_f * dsm61;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const int idx = chip_index(base61[e], s_ck61_frac[k], s_ck61_int[k],
                                     rsm61, jd61, p.lm61);
          const float cv = (float)s_code61[idx + CODE_PAD];
          kahan_add(acc[12 + e], comp[12 + e], cv * ib);
          kahan_add(acc[15 + e], comp[15 + e], cv * qb);
        }
      }
    }

    // block reduction in float64: warp shuffles, then one partial per
    // warp; each sum is rounded to float32 once, at the end
#pragma unroll
    for (int i = 0; i < N_ACC; ++i) {
      double v = (double)acc[i] - (double)comp[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if ((tid & 31) == 0) s_part[tid >> 5][i] = v;
    }
    __syncthreads();
    if (tid < N_ACC) {
      double v = 0.0;
      for (int wi = 0; wi < n_warps; ++wi) v += s_part[wi][tid];
      s_sum[tid] = (float)v;
    }
    __syncthreads();

    if (tid == 0) {
      float v[N_CANON];
#pragma unroll
      for (int i = 0; i < N_ACC; ++i) v[i] = s_sum[i];
      float carr_err, code_err;
      discriminators(p, v, &carr_err, &code_err);
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

      float* t = v + V_TAIL;
      t[0] = carr_err;
      t[1] = code_err;
      t[2] = carr_nco;
      t[3] = code_nco_new;
      t[4] = d_cyc;
      t[5] = d_step;
      t[6] = rem_code;
      t[7] = rem_cyc;
      t[8] = blk_f;
      float* s = v + V_STATE;
      s[0] = rem_code_new;
      s[1] = rem_cyc_new;
      s[2] = d_cyc_new;
      s[3] = d_step_new;
      s[4] = code_nco_new;
      s[5] = code_err;
      s[6] = d1_new;
      s[7] = d2_new;
      float* row = out + ((size_t)w * p.n_channels + c) * p.n_slots;
#pragma unroll
      for (int i = 0; i < N_CANON; ++i)
        if (p.slot[i] >= 0) row[p.slot[i]] = v[i];
#pragma unroll
      for (int i = 0; i < 8; ++i) s_state[i] = s[i];
      s_cursor = cursor + blksize;
    }
    __syncthreads();
  }

  if (tid < 8) state_out[c * 8 + tid] = s_state[tid];
  if (tid == 0) cursor_out[c] = s_cursor;
}

// Dynamic shared memory of one block: the coarse tables and the carrier
// table (int32 + 2 float32 per entry), the BOC(6,1) coarse tables where
// wideband, and the int8 chip tables.
static size_t smem_bytes(const TrackParams& p) {
  size_t b = (size_t)p.k_max * 12 + (size_t)p.n_taps * p.table_len;
  if (p.wideband) b += (size_t)p.k_max * 8 + (size_t)p.table_len61;
  return b;
}

// Host entry point, called through ctypes.  Launches on `stream` and does
// not synchronize; returns cudaGetLastError() (0 on success).
extern "C" int bds3_track_fused(const void* capture, long long total,
                                const void* code, const void* ck_int,
                                const void* ck_frac, const void* code61,
                                const void* ck61_int, const void* ck61_frac,
                                const void* carr_t, const void* a_base,
                                const void* q0_cyc, const void* init_dstep,
                                const void* state_in, const void* cursor_in,
                                void* out, void* state_out, void* cursor_out,
                                const TrackParams* params, void* stream) {
  const TrackParams p = *params;
  const size_t smem = smem_bytes(p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        track_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  track_fused_kernel<<<p.n_channels, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)capture, total, (const int8_t*)code, (const int*)ck_int,
      (const float*)ck_frac, (const int8_t*)code61, (const int*)ck61_int,
      (const float*)ck61_frac, (const float*)carr_t, (const float*)a_base,
      (const float*)q0_cyc, (const float*)init_dstep, (const float*)state_in,
      (const long long*)cursor_in, (float*)out, (float*)state_out,
      (long long*)cursor_out, p);
  return (int)cudaGetLastError();
}
