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
// (pallas_fused.py:1019-1073, scan.py:243-296).  The capture is real int8,
// real float32 or complex64 (pallas_fused.py:1221-1229 hands the TPU
// kernel the last as two float32 planes); the kernel is a template on the
// sample's load and mix (struct Capture below), with one instance of each,
// chosen by the dtype code the wrapper passes.  Everything after the mix
// is the same for the three.
//
// Design.  One thread-block cluster of S blocks per channel, S chosen on
// the host (fused.py:cluster_size): the largest of 16, 8, 4, 2, 1 for which
// the card holds all C clusters at once, so no epoch waits for a second
// wave.  The W epochs are a loop inside every block: each epoch's window
// and chip indices depend on the previous epoch's loop-filter output, so
// the epochs of a channel are a chain (on the TPU they were the sequential
// grid axis); the samples within an epoch are not, and the cluster splits
// them.  Every block loads its channel's chip tables and coarse tables
// into its own shared memory and keeps its own copy of the loop state (8
// floats and an int64 absolute cursor).  Per epoch, every block computes
// the epoch length n from that state, and cluster rank r takes the
// contiguous slice [r*ceil(n/S), min(n, (r+1)*ceil(n/S))) of the epoch's
// samples (fused.py:rank_slice), which keeps the capture reads coalesced.
// Its threads stride over the slice: load the sample, mix it with the
// local carrier, and add it, signed by its chip, into up to 18 sums
// (I/Q x early/prompt/late x data/pilot BOC(1,1)/pilot BOC(6,1)).  The
// block reduces its threads' sums in float64 (warp shuffles, then one
// partial per warp) and writes its 18 partials into its own shared memory,
// double-buffered by epoch parity; then one cluster barrier.  After it,
// threads 0..17 of every block read the S blocks' partials through
// distributed shared memory, in rank order, and add them in float64; each
// sum is rounded to float32 once.  Thread 0 of every block then runs the
// discriminators, the 3rd-order PLL and 2nd-order DLL and the phase
// remainders on the same values in the same order, so every block holds
// bit-identical state without a broadcast or a second cluster barrier;
// rank 0 alone writes the packed output row, the final state and the
// cursor.  One barrier per epoch is safe because of the double buffer: a
// block overwrites parity p in epoch w+2 only after every block has passed
// the barrier of epoch w+1, which each reaches after its reads of epoch w.
// A last cluster barrier keeps every block alive until the others have
// read its shared memory.  S = 1 is one block per channel.
//
// Sums.  Every chip table entry is +1 or -1 (the tables are checked by
// tests/test_torch_fused_geometry.py), so a product cv*x is exactly +-x:
// each sample's mixed I and Q are converted to float64 once, and each
// correlator is a float64 running sum to which the sample is added with
// cv's sign xored into its sign bit (one LOP3 and one DADD; the H100 runs
// float64 adds at half the float32 rate, against the four float32 adds of
// a compensated (Kahan) sum: 2-7% faster a block, PERF.md).  The sums of
// ~1e6 float32 terms then carry float64 rounding only, and each
// correlator is rounded to float32 once, as the plain version's float64
// sum of the same terms is: the two agree bit for bit on the card, where
// two float32 summation orders differ by ~1e-3 of mean|Q| on B1C's small
// BOC(6,1) Q correlators and 250 closed-loop epochs amplify that.
// tools/k1_sum_ab.py builds the kernel with compensated float32 sums in
// place of these (the block marked <acc>) and times both.
//
// Chip index.  raw = ck_int + ceil(frac) - 1 lies in (-L*m, 2*L*m) while
// the loop state is in its normal range (|rem_code| < 1 chip, the code
// rate within 1e-4 of nominal: fused.py:chip_index_bound), so one
// conditional add or subtract of L*m replaces the modulo.  Each epoch
// every block checks from its state that all of the epoch's raw indices
// are in that range (wraps_once, fused.py:wraps_once mirrors it) and
// takes the modulo where they may not be: the same result, by a uniform
// branch.
//
// What bounds it.  Each sample costs one sincosf, three chip-index
// computations (six for B1C wideband) and up to twelve signed float64 adds
// (eighteen), and a complex sample four more multiplies and adds; the
// capture is read once (1, 4 or 8 bytes a sample: at most about 8 x 10^8
// bytes per second of signal, far below the card's bandwidth).  Spread
// over C*S SMs, the per-sample work shrinks by S; what does not shrink is
// the per-epoch chain: one block reduction, one cluster barrier, the
// distributed partial reads and the scalar tail, W times per launch (4-10
// us an epoch on the H100, PERF.md).  Staging the window with cp.async
// and capturing short blocks in a CUDA graph are later work.  None of the
// TPU kernel's machinery is carried over (prefix scratch, MXU one-hot
// selects, boundary tiles, the 4096-aligned DMA ring): the direct sum
// here is the same sum as its bucket form,
// regrouped (scan.py:171-173).
//
// Shared memory of one block (fused.py:_smem_bytes mirrors it): the warp
// partials (16 x 18 float64), the cluster partials (2 x 18 float64), the
// cursor, the state and the 18 rounded sums (2,704 bytes in all), then
// the coarse tables and the carrier table (int32 + 2 float32 per entry),
// the BOC(6,1) coarse tables where wideband, and the int8 chip tables: at
// the B1C preset (99.375 Msps, wideband) about 171,000 of the 232,448
// bytes a block may opt in to.  128 registers a thread allow one block of
// 512 threads per SM whatever the tables take.
//
// Exactness.  The epoch length blksize = q0_int + ceil(resid) and each
// sample's chip index ceil(frac) must take the same branch as the plain
// version.  So:
//  * the file is compiled with -fmad=false (bds3_tpu_torch/_build.py):
//    nvcc would otherwise fuse a*b+c into one FMA and move the float32
//    rounding of `resid` (scan.py:128-130), of `frac` (scan.py:87) and of
//    the complex mix (xr*c + xi*s) off PyTorch's, which runs each
//    operation on its own.  Never build with --use_fast_math;
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define N_CANON 41   // values one epoch produces (see TrackParams.slot)
#define MAX_TAPS 3   // data, pilot BOC(1,1), pilot BOC(6,1)
#define N_ACC (MAX_TAPS * 6)
#define THREADS 512
#define N_WARPS (THREADS / 32)
#define SPLIT 4096
#define CODE_PAD 16
// the block's bookkeeping at the front of its shared memory: warp
// partials, cluster partials by epoch parity (float64), the cursor, the
// state and the rounded sums
#define HEAD_BYTES (N_WARPS * N_ACC * 8 + 2 * N_ACC * 8 + 8 + 8 * 4 + N_ACC * 4)

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

// <acc>
// One correlator's running sum of cv * x over a thread's samples, cv = +-1:
// x's float64 copy xd with cv's sign bit xored into its own, added in
// float64.  (x itself is for tools/k1_sum_ab.py's compensated float32
// variant of this block, which adds cv * x.)
struct Acc {
  double s;
  __device__ __forceinline__ void zero() { s = 0.0; }
  __device__ __forceinline__ void add(int cv, float x, double xd) {
    const int hi = __double2hiint(xd) ^ (cv & (int)0x80000000);
    s += __hiloint2double(hi, __double2loint(xd));
  }
  __device__ __forceinline__ double value() const { return s; }
};
// </acc>

// The capture kinds (fused.py:CAPTURE_KINDS), each a load of sample g
// (zero outside [0, total)) and its mix with the local carrier e^{-j
// theta}, cs = cos(theta) and sn = sin(theta) (scan.py:_mix): a real
// sample x gives (x cs, -(x sn)); a complex one, stored as interleaved
// (I, Q) float pairs (torch.view_as_real's layout), gives (I cs + Q sn,
// Q cs - I sn), four products and two sums each rounded on its own.
#define CAPTURE_INT8 0
#define CAPTURE_FLOAT32 1
#define CAPTURE_COMPLEX64 2

struct RealMix {
  using S = float;
  static __device__ __forceinline__ void mix(S x, float cs, float sn,
                                            float* ib, float* qb) {
    *ib = x * cs;
    *qb = -(x * sn);
  }
};

template <int KIND> struct Capture;

template <> struct Capture<CAPTURE_INT8> : RealMix {
  using T = int8_t;
  static __device__ __forceinline__ S load(const T* cap, long long g,
                                           long long total) {
    return (g >= 0 && g < total) ? (float)cap[g] : 0.0f;
  }
};

template <> struct Capture<CAPTURE_FLOAT32> : RealMix {
  using T = float;
  static __device__ __forceinline__ S load(const T* cap, long long g,
                                           long long total) {
    return (g >= 0 && g < total) ? cap[g] : 0.0f;
  }
};

template <> struct Capture<CAPTURE_COMPLEX64> {
  using T = float2;
  using S = float2;
  static __device__ __forceinline__ S load(const T* cap, long long g,
                                           long long total) {
    return (g >= 0 && g < total) ? cap[g] : make_float2(0.0f, 0.0f);
  }
  static __device__ __forceinline__ void mix(S x, float cs, float sn,
                                            float* ib, float* qb) {
    *ib = x.x * cs + x.y * sn;
    *qb = x.y * cs - x.x * sn;
  }
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

// Whether every raw chip index of an epoch of n samples lies in
// (-lm, 2*lm), for a bank whose early and late phases times m are lo_m and
// hi_m: frac ranges over [lo_m + min(0, (n-1)*dsm), hi_m + 1 +
// (SPLIT-1)*sm + max(0, (n-1)*dsm)] (ck_frac < 1, r < SPLIT), widened by
// 2 for the rounding of the per-sample sums; raw >= ceil(frac_lo) - 1 and
// raw <= lm - 2 + ceil(frac_hi), ck_int being in [0, lm).
// fused.py:wraps_once mirrors it.
__device__ __forceinline__ bool wraps_once(float lo_m, float hi_m, float dsm,
                                           int n, float sm, int lm) {
  const float dj = (float)(n - 1) * dsm;
  const float f_lo = (lo_m + fminf(dj, 0.0f)) - 2.0f;
  const float f_hi =
      (((hi_m + 1.0f) + (float)(SPLIT - 1) * sm) + fmaxf(dj, 0.0f)) + 2.0f;
  return f_lo >= (float)(1 - lm) && f_hi <= (float)(lm + 1);
}

// Chip index (scan.py:85-89): (ck_int + ceil(chi*m) - 1) mod (L*m), with
// one conditional add or subtract where wraps_once holds.
__device__ __forceinline__ int chip_index(float base_m, float ck_frac,
                                          int ck_int, float rsm, float jd,
                                          int lm, bool once) {
  const float frac = ((base_m + ck_frac) + rsm) + jd;
  const int raw = ck_int + (int)ceilf(frac) - 1;
  if (once) return raw < 0 ? raw + lm : (raw >= lm ? raw - lm : raw);
  const int idx = raw % lm;
  return idx < 0 ? idx + lm : idx;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
track_fused_kernel(const typename Capture<KIND>::T* __restrict__ capture,
                   long long total,
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
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / S;
  const int tid = threadIdx.x;

  double* s_part = reinterpret_cast<double*>(smem);    // [N_WARPS][N_ACC]
  double* s_rank = s_part + N_WARPS * N_ACC;           // [2][N_ACC]
  long long* s_cursor = reinterpret_cast<long long*>(s_rank + 2 * N_ACC);
  float* s_state = reinterpret_cast<float*>(s_cursor + 1);   // [8]
  float* s_sum = s_state + 8;                                // [N_ACC]
  const int k_wb = p.wideband ? p.k_max : 0;
  int* s_ck_int = reinterpret_cast<int*>(smem + HEAD_BYTES);
  float* s_ck_frac = reinterpret_cast<float*>(s_ck_int + p.k_max);
  float* s_carr = s_ck_frac + p.k_max;
  int* s_ck61_int = reinterpret_cast<int*>(s_carr + p.k_max);
  float* s_ck61_frac = reinterpret_cast<float*>(s_ck61_int + k_wb);
  int8_t* s_code = reinterpret_cast<int8_t*>(s_ck61_frac + k_wb);
  int8_t* s_code61 = s_code + p.n_taps * p.table_len;

  for (int i = tid; i < p.k_max; i += THREADS) {
    s_ck_int[i] = ck_int[i];
    s_ck_frac[i] = ck_frac[i];
    s_carr[i] = carr_t[(size_t)c * p.k_max + i];
  }
  for (int i = tid; i < k_wb; i += THREADS) {
    s_ck61_int[i] = ck61_int[i];
    s_ck61_frac[i] = ck61_frac[i];
  }
  const int8_t* code_c = code + (size_t)c * p.n_taps * p.table_len;
  for (int i = tid; i < p.n_taps * p.table_len; i += THREADS)
    s_code[i] = code_c[i];
  if (p.wideband) {
    const int8_t* code61_c = code61 + (size_t)c * p.table_len61;
    for (int i = tid; i < p.table_len61; i += THREADS)
      s_code61[i] = code61_c[i];
  }
  if (tid < 8) s_state[tid] = state_in[c * 8 + tid];
  if (tid == 0) *s_cursor = cursor_in[c];
  const float ab = a_base[c];
  __syncthreads();

  const float mf = (float)p.m, m61f = (float)p.m61;
  for (int w = 0; w < p.n_epochs; ++w) {
    const float rem_code = s_state[0], rem_cyc = s_state[1];
    const float d_cyc = s_state[2], d_step = s_state[3];
    const long long cursor = *s_cursor;

    // blksize = ceil((L - rem)/step) (scan.py:125-131)
    const float e_rel = d_step * p.inv_step_base;
    const float corr = (1.0f - e_rel) + e_rel * e_rel;
    const float resid =
        p.q0_frac - (rem_code * p.inv_step_base + p.q0_sum * e_rel) * corr;
    const int delta = (int)ceilf(resid);
    const int blksize = p.q0_int + delta;
    const int n = min(blksize, p.n_max);
    // this rank's slice of the epoch (fused.py:rank_slice)
    const int chunk = (max(n, 0) + S - 1) / S;
    const int lo = min(max(n, 0), rank * chunk);
    const int hi = min(max(n, 0), lo + chunk);

    // early / prompt / late code phase at the epoch start, times m
    const float base[3] = {(rem_code + (-p.spacing)) * mf,
                           (rem_code + 0.0f) * mf,
                           (rem_code + p.spacing) * mf};
    const float base61[3] = {(rem_code + (-p.spacing61)) * m61f,
                             (rem_code + 0.0f) * m61f,
                             (rem_code + p.spacing61) * m61f};
    const float dsm = d_step * mf;
    const float dsm61 = d_step * m61f;
    const bool once =
        wraps_once(base[0], base[2], dsm, n, p.sm, p.lm) &&
        (!p.wideband ||
         wraps_once(base61[0], base61[2], dsm61, n, p.sm61, p.lm61));

    Acc acc[N_ACC];
#pragma unroll
    for (int i = 0; i < N_ACC; ++i) acc[i].zero();

    for (int j = lo + tid; j < hi; j += THREADS) {
      const typename Capture<KIND>::S x =
          Capture<KIND>::load(capture, cursor + j, total);
      const int k = j / SPLIT;
      const float r_f = (float)(j % SPLIT);
      const float j_f = (float)j;
      // local carrier e^{-j theta} (scan.py:140-152)
      const float cyc = mod1(((s_carr[k] + rem_cyc) + r_f * ab) + j_f * d_cyc);
      float sn, cs;
      sincosf(p.two_pi * cyc, &sn, &cs);
      float ib, qb;
      Capture<KIND>::mix(x, cs, sn, &ib, &qb);
      const double ib_d = (double)ib, qb_d = (double)qb;
      const float rsm = r_f * p.sm;
      const float jd = j_f * dsm;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int idx = chip_index(base[e], s_ck_frac[k], s_ck_int[k], rsm,
                                   jd, p.lm, once);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t < p.n_taps) {
            const int cv = s_code[t * p.table_len + idx + CODE_PAD];
            acc[t * 6 + e].add(cv, ib, ib_d);
            acc[t * 6 + 3 + e].add(cv, qb, qb_d);
          }
        }
      }
      if (p.wideband) {
        // the BOC(6,1) pilot at m = 12, its own coarse table and spacing
        const float rsm61 = r_f * p.sm61;
        const float jd61 = j_f * dsm61;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const int idx = chip_index(base61[e], s_ck61_frac[k],
                                     s_ck61_int[k], rsm61, jd61, p.lm61,
                                     once);
          const int cv = s_code61[idx + CODE_PAD];
          acc[12 + e].add(cv, ib, ib_d);
          acc[15 + e].add(cv, qb, qb_d);
        }
      }
    }

    // the block's partials in float64: warp shuffles, then one partial
    // per warp, summed in warp order into this epoch's parity buffer
#pragma unroll
    for (int i = 0; i < N_ACC; ++i) {
      double v = acc[i].value();
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if ((tid & 31) == 0) s_part[(tid >> 5) * N_ACC + i] = v;
    }
    __syncthreads();
    double* mine = s_rank + (w & 1) * N_ACC;
    if (tid < N_ACC) {
      double v = 0.0;
      for (int wi = 0; wi < N_WARPS; ++wi) v += s_part[wi * N_ACC + tid];
      mine[tid] = v;
    }
    cluster.sync();

    if (tid < 32) {
      // the cluster's partials in rank order, rounded once
      if (tid < N_ACC) {
        double v = 0.0;
        for (int q = 0; q < S; ++q) v += cluster.map_shared_rank(mine, q)[tid];
        s_sum[tid] = (float)v;
      }
      __syncwarp();
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
            (code_nco + p.dll_c1 * (code_err - code_error)) +
            code_err * p.dll_c2;
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
        if (rank == 0) {
          float* row = out + ((size_t)w * p.n_channels + c) * p.n_slots;
#pragma unroll
          for (int i = 0; i < N_CANON; ++i)
            if (p.slot[i] >= 0) row[p.slot[i]] = v[i];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) s_state[i] = s[i];
        *s_cursor = cursor + blksize;
      }
    }
    __syncthreads();
  }

  // no block leaves while another may still read its partials
  cluster.sync();
  if (rank == 0) {
    if (tid < 8) state_out[c * 8 + tid] = s_state[tid];
    if (tid == 0) cursor_out[c] = *s_cursor;
  }
}

// Dynamic shared memory of one block (the kernel has no static shared
// memory): the bookkeeping, the coarse tables and the carrier table
// (int32 + 2 float32 per entry), the BOC(6,1) coarse tables where
// wideband, and the int8 chip tables.
static size_t smem_bytes(const TrackParams& p) {
  size_t b = HEAD_BYTES + (size_t)p.k_max * 12 +
             (size_t)p.n_taps * p.table_len;
  if (p.wideband) b += (size_t)p.k_max * 8 + (size_t)p.table_len61;
  return b;
}

template <int KIND>
static cudaError_t set_attributes(size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      track_fused_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // clusters of 16 are beyond the portable 8
  return cudaFuncSetAttribute(track_fused_kernel<KIND>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

// C*S blocks of THREADS threads as C clusters of S blocks.
static cudaLaunchConfig_t launch_config(const TrackParams& p, int cluster,
                                        size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_channels * cluster, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int KIND>
static int occupancy(const TrackParams& p, int n_sizes, const int* sizes,
                     int* counts) {
  const size_t smem = smem_bytes(p);
  const cudaError_t err = set_attributes<KIND>(smem);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n_sizes; ++i) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(p, sizes[i], smem, 0, &attr);
    int n = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&n, track_fused_kernel<KIND>, &cfg);
    counts[i] = e == cudaSuccess ? n : -(int)e;
    cudaGetLastError();   // a refused size is an answer, not a fault
  }
  return 0;
}

// For each cluster size sizes[i], how many clusters of it the card holds
// at once with this config's shared memory and block size for the
// instance of capture kind `kind` (cudaOccupancyMaxActiveClusters);
// -(error code) where the query fails (a size the card does not take).
// Returns 0, or the error of setting the kernel's attributes.
extern "C" int bds3_track_cluster_occupancy(const TrackParams* params,
                                            int kind, int n_sizes,
                                            const int* sizes, int* counts) {
  switch (kind) {
    case CAPTURE_INT8:
      return occupancy<CAPTURE_INT8>(*params, n_sizes, sizes, counts);
    case CAPTURE_FLOAT32:
      return occupancy<CAPTURE_FLOAT32>(*params, n_sizes, sizes, counts);
    case CAPTURE_COMPLEX64:
      return occupancy<CAPTURE_COMPLEX64>(*params, n_sizes, sizes, counts);
  }
  return (int)cudaErrorInvalidValue;
}

template <int KIND>
static int launch(const void* capture, long long total, const void* code,
                  const void* ck_int, const void* ck_frac, const void* code61,
                  const void* ck61_int, const void* ck61_frac,
                  const void* carr_t, const void* a_base, const void* q0_cyc,
                  const void* init_dstep, const void* state_in,
                  const void* cursor_in, void* out, void* state_out,
                  void* cursor_out, int cluster, const TrackParams& p,
                  void* stream) {
  const size_t smem = smem_bytes(p);
  cudaError_t err = set_attributes<KIND>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(p, cluster, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, track_fused_kernel<KIND>,
      (const typename Capture<KIND>::T*)capture, total, (const int8_t*)code,
      (const int*)ck_int, (const float*)ck_frac, (const int8_t*)code61,
      (const int*)ck61_int, (const float*)ck61_frac, (const float*)carr_t,
      (const float*)a_base, (const float*)q0_cyc, (const float*)init_dstep,
      (const float*)state_in, (const long long*)cursor_in, (float*)out,
      (float*)state_out, (long long*)cursor_out, p);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported here; not left for the next launch
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Host entry point, called through ctypes.  Launches the instance of
// capture kind `kind` as C clusters of `cluster` blocks on `stream` and
// does not synchronize; returns the launch's error, else
// cudaGetLastError() (0 on success).
extern "C" int bds3_track_fused(const void* capture, long long total,
                                int kind, const void* code,
                                const void* ck_int, const void* ck_frac,
                                const void* code61, const void* ck61_int,
                                const void* ck61_frac, const void* carr_t,
                                const void* a_base, const void* q0_cyc,
                                const void* init_dstep, const void* state_in,
                                const void* cursor_in, void* out,
                                void* state_out, void* cursor_out,
                                int cluster, const TrackParams* params,
                                void* stream) {
  switch (kind) {
#define LAUNCH(K)                                                          \
  case K:                                                                  \
    return launch<K>(capture, total, code, ck_int, ck_frac, code61,        \
                     ck61_int, ck61_frac, carr_t, a_base, q0_cyc,          \
                     init_dstep, state_in, cursor_in, out, state_out,      \
                     cursor_out, cluster, *params, stream);
    LAUNCH(CAPTURE_INT8)
    LAUNCH(CAPTURE_FLOAT32)
    LAUNCH(CAPTURE_COMPLEX64)
#undef LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}
