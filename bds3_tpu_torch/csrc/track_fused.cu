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
// Design.  S = floor(B / C) blocks per channel (fused.py:choose_blocks),
// B the blocks of this instance the card holds at once (one an SM; 13 a
// channel for 10 channels on the H100's 132 SMs), all resident at once so
// that no epoch waits for a second wave: where S >= 2 the grid is launched
// with the cooperative attribute, so the launch fails rather than hangs
// if they cannot all be resident.  Where C > B/2, S = 1: one block a
// channel, no launch attribute, and no block waits for another.  Block b
// is rank b % S of channel b / S.  The W epochs are a loop inside every
// block: each epoch's window and chip indices depend on the previous
// epoch's loop-filter output, so the epochs of a channel are a chain (on
// the TPU they were the sequential grid axis); the samples within an
// epoch are not, and the channel's S blocks split them.  Every block
// loads its channel's chip tables and coarse tables into its own shared
// memory and keeps its own copy of the loop state (8 floats and an int64
// absolute cursor).  Per epoch, every block computes the epoch length n
// from that state, and rank r takes the contiguous slice [r*ceil(n/S),
// min(n, (r+1)*ceil(n/S))) of the epoch's samples (fused.py:rank_slice),
// which keeps the capture reads coalesced.
// Its threads walk the slice in runs: run i holds the samples [i*R,
// (i+1)*R) of the epoch, R = 16 bytes of capture (16 int8, 4 float32 or 2
// complex64 samples, Capture<KIND>::RUN), so no run crosses a SPLIT
// segment of the coarse tables, and the slice's whole runs go to the
// threads in turn (a warp reads 512 consecutive bytes).  A run is one
// 16-byte vector load, read as two aligned loads and a word select and
// byte funnel shift where the cursor leaves it unaligned (a float32 or
// complex64 run, 4 or 2 samples, is cheaper read sample by sample).  What
// the run's samples share is taken once a run: the coarse
// carrier, code-phase and chip-index entries, and one wrap of the chip
// indices (below).  The samples at j0 + i then take j_f and r_f as exact
// float adds of i, and each is mixed with the local carrier and added,
// signed by its chip, into up to 18 sums (I/Q x early/prompt/late x
// data/pilot BOC(1,1)/pilot BOC(6,1)), the run body specialised on the
// taps and the BOC(6,1) bank by a uniform branch an epoch.  The slice's
// ragged head and tail (under R samples each) and runs at the capture's
// edges are read sample by sample, zero outside [0, total).  The
// block reduces its threads' sums in float64 (warp shuffles, then one
// partial per warp) and writes its 18 partials to a global buffer (C, 2,
// S, 18), double-buffered by epoch parity, for the epoch's one exchange:
// thread 0 makes a release increment of the channel's arrival counter
// and spins with acquire loads until it reaches S * (w + 1) (the wrapper
// zeroes the counters for each launch; exchange(), below, on the wait's
// limit), and threads 0..17 read the S partials, with loads that bypass
// L1, in rank order and add them in float64; each sum is rounded to
// float32 once.  Thread 0 of every block then runs the discriminators,
// the 3rd-order PLL and 2nd-order DLL and the phase remainders on the
// same values in the same order, so every block holds bit-identical state
// without a broadcast or a second exchange; rank 0 alone writes the
// packed output row, the final state and the cursor.  One exchange per
// epoch is safe because of the double buffer: a block overwrites parity p
// in epoch w+2 only after every block has passed the exchange of epoch
// w+1, which each reaches after its reads of epoch w.  The partials live
// in global memory, which outlives the blocks, so no block waits for the
// others at the end.  Not thread-block clusters exchanging through
// distributed shared memory: a cluster cannot span two GPCs, so on the
// H100 the largest size that holds every channel leaves SMs idle (52 of
// 132 at 10 channels), and that layout was faster at no shape measured
// (PERF.md).
//
// Sums.  Every chip table entry is +1 or -1 (the tables are checked by
// tests/test_torch_fused_geometry.py), so a product cv*x is exactly +-x:
// each sample's mixed I and Q are converted to float64 once, and each
// correlator is a float64 running sum to which the sample is added by one
// fused multiply-add with cv as +-1.0, exact (the H100 runs float64 at
// half the float32 rate, against the four float32 adds of a compensated
// (Kahan) sum: 2-7% faster a block, PERF.md; the +-1.0 is shared by a
// tap's I and Q sums, where xoring cv's sign into xd took a copy of xd's
// low word for each sum: 4-10% slower, tools/k1_loop_ab.py).  The sums of
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
// rate within 1e-4 of nominal: fused.py:chip_index_bound), and within a
// run it moves by a few entries.  So each run takes one wrap of -L*m, 0
// or L*m, from its first sample's prompt index, and every index of the
// run lands within SMEM_PAD entries of [0, L*m), where the tables in
// shared memory repeat themselves circularly; ceil(frac) is one float add
// rounded up onto 1.5 * 2^23, whose low bits are then the index (table_pos).
// Each epoch every block checks from its state that all of the epoch's
// raw indices are in that range and that a run moves by less than the
// padding (wraps_once and runs_fit; fused.py mirrors both) and where they
// may not, every sample takes cvt.rpi and the modulo instead: the same
// result, by a uniform branch.
//
// What bounds it.  Each sample costs one sincosf, three chip-index
// computations (six for B1C wideband) and up to twelve signed float64 adds
// (eighteen), and a complex sample four more multiplies and adds; the
// capture is read once (1, 4 or 8 bytes a sample: at most about 8 x 10^8
// bytes per second of signal, far below the card's bandwidth).  So the
// loop is bound by the instructions it issues, 110 to 140 a sample
// (tools/k1_loop_ab.py counts them in the SASS): the per-sample chain is
// kept to the reference's float32 operations, libdevice's sincosf and the
// float64 adds, and what changes only once a run or never (the coarse
// entries, the wrap, the bounds check, j and j % SPLIT) is taken out of
// it; the modulo is x - truncf(x), the chip index's ceil and conversion
// one float add, the int8 conversion a byte permute and a float add, all
// exact.  Spread over C*S SMs, the per-sample work shrinks by S; what does
// not shrink is the per-epoch chain: one block reduction, the exchange
// (the arrival counter and S reads from L2) and the scalar tail, W times
// per launch (4-10 us an epoch on the H100, PERF.md).  So more blocks pay
// where a thread walks many samples an epoch (B1C at 99.375 Msps: 13
// blocks a channel walk 10 runs a thread where 8 walked 16) and little
// where it walks few (B2a: two runs a thread at 8 blocks or 11).
// Capturing short blocks in a CUDA graph is later work.  None of the TPU kernel's machinery is
// carried over (prefix scratch, MXU one-hot selects, boundary tiles, the
// 4096-aligned DMA ring): the direct sum here is the same sum as its
// bucket form, regrouped (scan.py:171-173).
//
// Shared memory of one block (fused.py:_smem_bytes mirrors it): the warp
// partials (16 x 18 float64), the cursor, the state and the 18 rounded
// sums (2,416 bytes in all), then
// the coarse tables and the carrier table (int32 + 2 float32 per entry),
// the BOC(6,1) coarse tables where wideband, and the int8 chip tables,
// each padded by SMEM_PAD entries on either side: at the B1C preset
// (99.375 Msps, wideband) about 171,600 of the 232,448 bytes a block may
// opt in to.  128 registers a thread allow one block of
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
//  * jnp.mod is a floor-mod: mod1() adds 1 to a negative fmodf result,
//    itself x - truncf(x) with x's sign, which equals fmodf(x, 1) for
//    every float32 (tests/test_torch_k1_exact_forms.py checks this and
//    the other exact forms: the ceil, the int8 conversion, j_f and r_f);
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
#define N_WARPS (THREADS / 32)
#define SPLIT 4096
#define CODE_PAD 16   // circular padding of the chip tables as passed
// the circular padding of each chip table in shared memory, in entries on
// either side (runs_fit)
#define SMEM_PAD 64
// 1.5 * 2^23 and its bits (table_pos)
#define CEIL_MAGIC 12582912.0f
#define CEIL_MAGIC_BITS 0x4B400000
// the block's bookkeeping at the front of its shared memory: warp
// partials (float64), the cursor, the state and the rounded sums
#define HEAD_BYTES (N_WARPS * N_ACC * 8 + 8 + 8 * 4 + N_ACC * 4)
// the longest a block waits at an exchange before it traps (exchange())
#define WAIT_LIMIT_NS 2000000000ull

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
// cv as the float64 +-1.0 (its sign bit on 1.0's high word; the I and Q
// sums of a tap and phase share it) times x's float64 copy xd, added by one
// fused multiply-add.  The product is exactly +-xd, so the sum is rounded
// once, as a DADD of +-xd is.  (x itself is for tools/k1_sum_ab.py's
// compensated float32 variant of this block, which adds cv * x.)
struct Acc {
  double s;
  __device__ __forceinline__ void zero() { s = 0.0; }
  __device__ __forceinline__ void add(int cv, float x, double xd) {
    const double c =
        __hiloint2double((cv & (int)0x80000000) | 0x3FF00000, 0);
    s = __fma_rn(xd, c, s);
  }
  __device__ __forceinline__ double value() const { return s; }
};
// </acc>

// The capture kinds (fused.py:CAPTURE_KINDS), each a load of sample g
// (zero outside [0, total)), the samples of one run (RUN samples, 16
// bytes, from four 32-bit words) and a sample's mix with the local carrier
// e^{-j theta}, cs = cos(theta) and sn = sin(theta) (scan.py:_mix): a
// real sample x gives (x cs, -(x sn)); a complex one, stored as
// interleaved (I, Q) float pairs (torch.view_as_real's layout), gives (I cs
// + Q sn, Q cs - I sn), four products and two sums each rounded on its own.
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
  static constexpr int RUN = 16;
  static __device__ __forceinline__ S load(const T* cap, long long g,
                                           long long total) {
    return (g >= 0 && g < total) ? (float)cap[g] : 0.0f;
  }
  // sample i of a run at the capture's edges into its word, zero outside
  static __device__ __forceinline__ void put(uint32_t (&w)[8], int i,
                                             const T* cap, long long g,
                                             long long total) {
    if (g >= 0 && g < total)
      w[i >> 2] |= (uint32_t)(uint8_t)cap[g] << (8 * (i & 3));
  }
  // Sample i of a run: its byte, xored with 0x80 (so b + 128), placed
  // under the exponent of 2^23 by one byte permute, less 2^23 + 128 in one
  // float add; both steps are exact, so the value is (float)b.
  static __device__ __forceinline__ S sample(const uint32_t (&v)[4],
                                             int i) {
    const uint32_t u = v[i >> 2] ^ 0x80808080u;
    return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + (i & 3))) -
           8388736.0f;
  }
};

template <> struct Capture<CAPTURE_FLOAT32> : RealMix {
  using T = float;
  static constexpr int RUN = 4;
  static __device__ __forceinline__ S load(const T* cap, long long g,
                                           long long total) {
    return (g >= 0 && g < total) ? cap[g] : 0.0f;
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[8], int i,
                                             const T* cap, long long g,
                                             long long total) {
    w[i] = __float_as_uint(load(cap, g, total));
  }
  static __device__ __forceinline__ S sample(const uint32_t (&v)[4],
                                             int i) {
    return __uint_as_float(v[i]);
  }
};

template <> struct Capture<CAPTURE_COMPLEX64> {
  using T = float2;
  using S = float2;
  static constexpr int RUN = 2;
  static __device__ __forceinline__ S load(const T* cap, long long g,
                                           long long total) {
    return (g >= 0 && g < total) ? cap[g] : make_float2(0.0f, 0.0f);
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[8], int i,
                                             const T* cap, long long g,
                                             long long total) {
    const float2 x = load(cap, g, total);
    w[2 * i] = __float_as_uint(x.x);
    w[2 * i + 1] = __float_as_uint(x.y);
  }
  static __device__ __forceinline__ S sample(const uint32_t (&v)[4],
                                             int i) {
    return make_float2(__uint_as_float(v[2 * i]),
                       __uint_as_float(v[2 * i + 1]));
  }
  static __device__ __forceinline__ void mix(S x, float cs, float sn,
                                            float* ib, float* qb) {
    *ib = x.x * cs + x.y * sn;
    *qb = x.y * cs - x.x * sn;
  }
};

// fmodf(x, 1.0f), floored as jnp.mod is: x - truncf(x) is exact for every
// finite float32 (the fraction's bits are x's own), copysignf keeps the
// sign fmodf gives a zero result, and a negative result takes +1 as before.
__device__ __forceinline__ float mod1(float x) {
  const float r = copysignf(x - truncf(x), x);
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

// Entry i of a table padded by SMEM_PAD on either side: i - SMEM_PAD
// taken into [0, lm) (SMEM_PAD <= lm).
__device__ __forceinline__ int wrap_entry(int i, int lm) {
  const int idx = i - SMEM_PAD;
  return idx < 0 ? idx + lm : (idx >= lm ? idx - lm : idx);
}

// Whether one wrap offset per run serves every chip index of a run of
// `run` samples, in a bank whose early and late phases times m are lo_m
// and hi_m: within a run, each frac lies within (hi_m - lo_m) + (run - 1)
// * (sm + |dsm|) of the first sample's prompt frac, give or take the
// rounding of the per-sample sums (under 0.1 where wraps_once holds, as
// |frac| < 2^17 there), so each raw index lies within that plus 1 of the
// first prompt's, and the SMEM_PAD entries of circular padding on either
// side of the table must cover it.  fused.py:runs_fit mirrors it.
__device__ __forceinline__ bool runs_fit(float lo_m, float hi_m, float dsm,
                                         float sm, int run) {
  return ((hi_m - lo_m) + (float)(run - 1) * (sm + fabsf(dsm))) + 2.0f <=
         (float)SMEM_PAD;
}

// One epoch's constants of the sample loop, and the block's tables in
// shared memory.
struct Epoch {
  float rem_cyc, d_cyc, ab, two_pi, sm, dsm, sm61, dsm61;
  float base[3], base61[3];   // E/P/L code phase at the epoch start, times m
  int lm, lm61, stride;       // stride: one tap's table with its padding
  int off61;                  // the BOC(6,1) table's offset from code's
  const float* carr;
  const int* ck_int;
  const float* ck_frac;
  const int* ck61_int;
  const float* ck61_frac;
  const int8_t* code;
};

// What the samples of one run share, or a lone sample's own: the coarse
// carrier phase plus the remainder, each E/P/L phase plus the coarse
// fraction, and each bank's table offset (table_pos).
struct Point {
  float c0, b[3], b61[3];
  int pos, pos61;
};

// The shared-memory position of the chip entry (ck_int + ceil(frac) - 1)
// mod (L*m) (scan.py:85-89).  In a run, pos is ck_int - 1 plus the run's
// wrap offset plus SMEM_PAD less CEIL_MAGIC_BITS, and ceil(frac) comes
// from one float add rounded up: MAGIC + frac, for |frac| < 2^22, rounds
// up to MAGIC + ceil(frac), whose bits are CEIL_MAGIC_BITS + ceil(frac).
// A lone sample's pos is ck_int - 1: cvt.rpi and the modulo.
template <bool RUN>
__device__ __forceinline__ int table_pos(float frac, int pos, int lm) {
  if (RUN) return pos + __float_as_int(__fadd_ru(frac, CEIL_MAGIC));
  const int idx = (pos + __float2int_ru(frac)) % lm;
  return (idx < 0 ? idx + lm : idx) + SMEM_PAD;
}

// A run's pos (table_pos) from the raw index of its first sample's prompt:
// the wrap of -lm, 0 or lm that takes it into [0, lm).  Where wraps_once
// and runs_fit hold, every index of the run lands within SMEM_PAD of
// [0, lm), where the padding repeats the table circularly.
__device__ __forceinline__ int run_pos(float frac, int ck_int, int lm) {
  const int raw = (ck_int - 1) +
      (__float_as_int(__fadd_ru(frac, CEIL_MAGIC)) - CEIL_MAGIC_BITS);
  const int wrap = raw < 0 ? lm : (raw >= lm ? -lm : 0);
  return ((ck_int - 1) + wrap + SMEM_PAD) - CEIL_MAGIC_BITS;
}

// One sample x at (r_f, j_f) = (j % SPLIT, j) of the epoch, mixed and
// added, signed by its chips, into the sums; TAPS taps on the first chip
// grid, and the BOC(6,1) bank where WB.
template <int KIND, int TAPS, bool WB, bool RUN>
__device__ __forceinline__ void add_sample(const Epoch& ep, const Point& pt,
                                           typename Capture<KIND>::S x,
                                           float r_f, float j_f, Acc* acc) {
  // local carrier e^{-j theta} (scan.py:140-152)
  const float cyc = mod1((pt.c0 + r_f * ep.ab) + j_f * ep.d_cyc);
  float sn, cs;
  sincosf(ep.two_pi * cyc, &sn, &cs);
  float ib, qb;
  Capture<KIND>::mix(x, cs, sn, &ib, &qb);
  const double ib_d = (double)ib, qb_d = (double)qb;
  const float rsm = r_f * ep.sm;
  const float jd = j_f * ep.dsm;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int at = table_pos<RUN>((pt.b[e] + rsm) + jd, pt.pos, ep.lm);
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const int cv = ep.code[t * ep.stride + at];
      acc[t * 6 + e].add(cv, ib, ib_d);
      acc[t * 6 + 3 + e].add(cv, qb, qb_d);
    }
  }
  if (WB) {
    // the BOC(6,1) pilot at m = 12, its own coarse table and spacing; its
    // table lies at code61 = code + off61 (a run's pos61 holds off61)
    const float rsm61 = r_f * ep.sm61;
    const float jd61 = j_f * ep.dsm61;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int at =
          table_pos<RUN>((pt.b61[e] + rsm61) + jd61, pt.pos61, ep.lm61);
      const int cv = ep.code[RUN ? at : ep.off61 + at];
      acc[12 + e].add(cv, ib, ib_d);
      acc[15 + e].add(cv, qb, qb_d);
    }
  }
}

// A lone sample j (the slice's ragged ends, or every sample where the
// epoch's indices may need the modulo): its own load, zero outside
// [0, total), and its own coarse-table entries.
template <int KIND, int TAPS, bool WB>
__device__ __forceinline__ void add_lone(
    const Epoch& ep, const typename Capture<KIND>::T* cap, long long cursor,
    long long total, int j, Acc* acc) {
  const typename Capture<KIND>::S x = Capture<KIND>::load(cap, cursor + j,
                                                          total);
  const int k = j / SPLIT;
  Point pt;
  pt.c0 = ep.carr[k] + ep.rem_cyc;
#pragma unroll
  for (int e = 0; e < 3; ++e) pt.b[e] = ep.base[e] + ep.ck_frac[k];
  pt.pos = ep.ck_int[k] - 1;
  if (WB) {
#pragma unroll
    for (int e = 0; e < 3; ++e) pt.b61[e] = ep.base61[e] + ep.ck61_frac[k];
    pt.pos61 = ep.ck61_int[k] - 1;
  }
  add_sample<KIND, TAPS, WB, false>(ep, pt, x, (float)(j % SPLIT), (float)j,
                                    acc);
}

// One run's 16 bytes as loaded.  An int8 run: eight words from the two
// aligned 16-byte loads that hold them, and the byte offset of its first
// sample there.  A float32 or complex64 run, or a run at the capture's
// edges, is read sample by sample (zero outside [0, total)) into the first
// four words at offset 0: for 4 or 2 samples a run, the word select that
// an unaligned vector costs more than the loads it saves
// (tools/k1_loop_ab.py, variant runs_vec).
struct RawRun {
  uint32_t w[8];
  int shift;
};

template <int KIND>
__device__ __forceinline__ RawRun fetch_run(
    const typename Capture<KIND>::T* cap, long long g0, long long total) {
  using C = Capture<KIND>;
  RawRun raw;
  // <vector>
  if (KIND == CAPTURE_INT8 && g0 >= 0 && g0 + C::RUN <= total) {
  // </vector>
    const uintptr_t a = reinterpret_cast<uintptr_t>(cap + g0);
    const uint4* at = reinterpret_cast<const uint4*>(a & ~(uintptr_t)15);
    raw.shift = (int)(a & 15);
    // the second load only where the run spills into it: at offset 0 it
    // could lie past the capture's last byte
    const uint4 lo = __ldg(at), hi = __ldg(at + (raw.shift ? 1 : 0));
    raw.w[0] = lo.x, raw.w[1] = lo.y, raw.w[2] = lo.z, raw.w[3] = lo.w;
    raw.w[4] = hi.x, raw.w[5] = hi.y, raw.w[6] = hi.z, raw.w[7] = hi.w;
  } else {
    raw.shift = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) raw.w[i] = 0u;
#pragma unroll
    for (int i = 0; i < C::RUN; ++i) C::put(raw.w, i, cap, g0 + i, total);
  }
  return raw;
}

// The run's four words from the loaded eight: a word select by the word
// offset, then, for int8, a funnel shift by the byte offset.
template <int KIND>
__device__ __forceinline__ void align_run(const RawRun& raw,
                                          uint32_t (&v)[4]) {
  const int q = raw.shift >> 2;
  uint32_t u[6], t[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) u[i] = (q & 2) ? raw.w[i + 2] : raw.w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) t[i] = (q & 1) ? u[i + 1] : u[i];
  if (KIND == CAPTURE_INT8) {
    const int b = (raw.shift & 3) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __funnelshift_r(t[i], t[i + 1], b);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = t[i];
  }
}

// The RUN samples of the run that starts at j0 (a multiple of RUN, so
// within one SPLIT segment): the coarse-table entries and the wraps once,
// then each sample at j_f = j0 + i and r_f = j0 % SPLIT + i, exact float
// adds (j < n_max < 2^24).
template <int KIND, int TAPS, bool WB>
__device__ __forceinline__ void add_run(const Epoch& ep, const RawRun& raw,
                                        int j0, Acc* acc) {
  using C = Capture<KIND>;
  uint32_t v[4];
  align_run<KIND>(raw, v);
  const int k = j0 / SPLIT;
  const float r0 = (float)(j0 % SPLIT), jf0 = (float)j0;
  Point pt;
  pt.c0 = ep.carr[k] + ep.rem_cyc;
  const float ckf = ep.ck_frac[k];
#pragma unroll
  for (int e = 0; e < 3; ++e) pt.b[e] = ep.base[e] + ckf;
  pt.pos = run_pos((pt.b[1] + r0 * ep.sm) + jf0 * ep.dsm, ep.ck_int[k], ep.lm);
  if (WB) {
    const float ckf61 = ep.ck61_frac[k];
#pragma unroll
    for (int e = 0; e < 3; ++e) pt.b61[e] = ep.base61[e] + ckf61;
    pt.pos61 = run_pos((pt.b61[1] + r0 * ep.sm61) + jf0 * ep.dsm61,
                       ep.ck61_int[k], ep.lm61) + ep.off61;
  }
  // <samples>
#pragma unroll
  for (int i = 0; i < C::RUN; ++i)
    add_sample<KIND, TAPS, WB, true>(ep, pt, C::sample(v, i), r0 + (float)i,
                                     jf0 + (float)i, acc);
  // </samples>
}

// This thread's share of the block's slice [lo, hi) of the epoch.  Where
// `runs` holds, the threads take the slice's whole runs in turn (run i of
// the slice to thread i % THREADS, so a warp's loads are 512 consecutive
// bytes), each run loaded as it is summed: a load issued a run ahead
// holds its registers through the run's body, where the 128 a thread may
// have are all in use, and was slower (tools/k1_loop_ab.py, variant
// ahead).  The ragged head and tail, under RUN samples each
// (fused.py:rank_runs), go one sample a thread to the last threads, which
// hold the fewest runs.  Elsewhere every sample is a lone one, strided
// over the threads.
template <int KIND, int TAPS, bool WB>
__device__ __forceinline__ void sum_slice(
    const Epoch& ep, const typename Capture<KIND>::T* cap, long long cursor,
    long long total, int lo, int hi, bool runs, int tid, Acc* acc) {
  constexpr int R = Capture<KIND>::RUN;
  if (!runs) {
    for (int j = lo + tid; j < hi; j += THREADS)
      add_lone<KIND, TAPS, WB>(ep, cap, cursor, total, j, acc);
    return;
  }
  const int ra = (lo + R - 1) / R, rb = hi / R;   // whole runs [ra, rb)
  // <runs>
  for (int run = ra + tid; run < rb; run += THREADS)
    add_run<KIND, TAPS, WB>(
        ep, fetch_run<KIND>(cap, cursor + (long long)run * R, total),
        run * R, acc);
  // </runs>
  const int head = min(ra * R, hi), tail = max(rb * R, head);
  const int i = THREADS - 1 - tid;
  if (i < (head - lo) + (hi - tail))
    add_lone<KIND, TAPS, WB>(ep, cap, cursor, total,
                             i < head - lo ? lo + i : tail + (i - (head - lo)),
                             acc);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The exchange at one epoch: the block's partials are written; thread 0
// adds the block's arrival to its channel's counter with release
// semantics and waits, with acquire loads, until all S blocks of the
// channel have arrived at this epoch (`want` = S * (w + 1)).  The barriers
// on either side order the other threads' writes before the release and
// their reads after the acquire.  All S blocks are resident (the
// cooperative launch sees to it, and at S = 1 a block waits only for its
// own arrival), so a block waits at most for the slowest rank of its
// channel to finish the same epoch: tens of microseconds at the presets,
// and about 12 ms for the longest epoch a block can be given (n_max under
// 2^24 samples, fused._params, at about 1.3 SM cycles a sample, PERF.md),
// or a few of the card's time slices where contexts share it.  A wait of
// WAIT_LIMIT_NS, 2 s, is then no slow run but a fault of this code, and
// it traps rather than leave the card spinning for good.  A trap ends the process's CUDA
// context: every later CUDA call of the process fails.  A run stopped in
// a debugger while inside the kernel, or a context held off the card
// that long, would trip it too.
__device__ __forceinline__ void exchange(unsigned* arrived, unsigned want) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(arrived) : "memory");
    const unsigned long long t0 = globaltimer();
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(arrived) : "memory");
      if (seen < want && globaltimer() - t0 > WAIT_LIMIT_NS) __trap();
    } while (seen < want);
  }
  __syncthreads();
}

// S blocks a channel (Design, above), exchanging each epoch's partials
// through `xch` (C, 2, S, N_ACC) and the arrival counters `arrived` (C,),
// zero at the launch.
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
                   double* __restrict__ xch,              // (C, 2, S, N_ACC)
                   unsigned* __restrict__ arrived,        // (C,)
                   const TrackParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // S blocks a channel; block b is rank b % S of channel b / S
  const int S = (int)gridDim.x / p.n_channels;
  const int rank = (int)blockIdx.x % S;
  const int c = (int)blockIdx.x / S;
  const int tid = threadIdx.x;

  double* s_part = reinterpret_cast<double*>(smem);    // [N_WARPS][N_ACC]
  long long* s_cursor = reinterpret_cast<long long*>(s_part + N_WARPS * N_ACC);
  float* s_state = reinterpret_cast<float*>(s_cursor + 1);   // [8]
  float* s_sum = s_state + 8;                                // [N_ACC]
  const int k_wb = p.wideband ? p.k_max : 0;
  int* s_ck_int = reinterpret_cast<int*>(smem + HEAD_BYTES);
  float* s_ck_frac = reinterpret_cast<float*>(s_ck_int + p.k_max);
  float* s_carr = s_ck_frac + p.k_max;
  int* s_ck61_int = reinterpret_cast<int*>(s_carr + p.k_max);
  float* s_ck61_frac = reinterpret_cast<float*>(s_ck61_int + k_wb);
  int8_t* s_code = reinterpret_cast<int8_t*>(s_ck61_frac + k_wb);
  const int stride = p.lm + 2 * SMEM_PAD;   // one tap's table, padded
  int8_t* s_code61 = s_code + p.n_taps * stride;

  for (int i = tid; i < p.k_max; i += THREADS) {
    s_ck_int[i] = ck_int[i];
    s_ck_frac[i] = ck_frac[i];
    s_carr[i] = carr_t[(size_t)c * p.k_max + i];
  }
  for (int i = tid; i < k_wb; i += THREADS) {
    s_ck61_int[i] = ck61_int[i];
    s_ck61_frac[i] = ck61_frac[i];
  }
  // the chip tables, each entry i of [-SMEM_PAD, lm + SMEM_PAD) the
  // passed table's entry i mod lm
  const int8_t* code_c = code + (size_t)c * p.n_taps * p.table_len;
  for (int t = 0; t < p.n_taps; ++t)
    for (int i = tid; i < stride; i += THREADS)
      s_code[t * stride + i] =
          code_c[t * p.table_len + CODE_PAD + wrap_entry(i, p.lm)];
  if (p.wideband) {
    const int8_t* code61_c = code61 + (size_t)c * p.table_len61;
    for (int i = tid; i < p.lm61 + 2 * SMEM_PAD; i += THREADS)
      s_code61[i] = code61_c[CODE_PAD + wrap_entry(i, p.lm61)];
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
    // whether this epoch's runs may take one wrap offset each (wraps_once,
    // runs_fit): else every sample takes the modulo, the same result
    constexpr int R = Capture<KIND>::RUN;
    const bool runs =
        wraps_once(base[0], base[2], dsm, n, p.sm, p.lm) &&
        runs_fit(base[0], base[2], dsm, p.sm, R) &&
        (!p.wideband ||
         (wraps_once(base61[0], base61[2], dsm61, n, p.sm61, p.lm61) &&
          runs_fit(base61[0], base61[2], dsm61, p.sm61, R)));
    const Epoch ep = {rem_cyc, d_cyc, ab, p.two_pi, p.sm, dsm, p.sm61, dsm61,
                      {base[0], base[1], base[2]},
                      {base61[0], base61[1], base61[2]},
                      p.lm, p.lm61, stride, p.n_taps * stride, s_carr,
                      s_ck_int, s_ck_frac, s_ck61_int, s_ck61_frac, s_code};

    // <loop>
    Acc acc[N_ACC];
#pragma unroll
    for (int i = 0; i < N_ACC; ++i) acc[i].zero();
    if (p.wideband)
      sum_slice<KIND, 2, true>(ep, capture, cursor, total, lo, hi, runs, tid,
                               acc);
    else if (p.n_taps == 2)
      sum_slice<KIND, 2, false>(ep, capture, cursor, total, lo, hi, runs,
                                tid, acc);
    else
      sum_slice<KIND, 1, false>(ep, capture, cursor, total, lo, hi, runs,
                                tid, acc);
    // </loop>

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
    // the epoch's partials of the channel's ranks, by epoch parity; this
    // block's go to row `rank`
    double* part = xch + ((size_t)c * 2 + (w & 1)) * S * N_ACC;
    if (tid < N_ACC) {
      double v = 0.0;
      for (int wi = 0; wi < N_WARPS; ++wi) v += s_part[wi * N_ACC + tid];
      part[rank * N_ACC + tid] = v;
    }
    exchange(arrived + c, (unsigned)(S * (w + 1)));

    if (tid < 32) {
      // the channel's partials in rank order, rounded once
      if (tid < N_ACC) {
        double v = 0.0;
        for (int q = 0; q < S; ++q) v += __ldcg(part + q * N_ACC + tid);
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
             (size_t)p.n_taps * (p.lm + 2 * SMEM_PAD);
  if (p.wideband) b += (size_t)p.k_max * 8 + (size_t)(p.lm61 + 2 * SMEM_PAD);
  return b;
}

template <int KIND>
static cudaError_t set_attributes(size_t smem) {
  return cudaFuncSetAttribute(track_fused_kernel<KIND>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The blocks of the instance of capture kind `kind` the card holds at once
// with this config's shared memory and block size (blocks an SM times the
// SMs).  Returns 0, or the error of setting the kernel's attributes or of
// a query.
template <int KIND>
static int occupancy(const TrackParams& p, int* resident) {
  const size_t smem = smem_bytes(p);
  cudaError_t err = set_attributes<KIND>(smem);
  int per_sm = 0, sms = 0, dev = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, track_fused_kernel<KIND>, THREADS, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *resident = per_sm * sms;
  return (int)err;
}

extern "C" int bds3_track_occupancy(const TrackParams* params, int kind,
                                    int* resident) {
  switch (kind) {
    case CAPTURE_INT8:
      return occupancy<CAPTURE_INT8>(*params, resident);
    case CAPTURE_FLOAT32:
      return occupancy<CAPTURE_FLOAT32>(*params, resident);
    case CAPTURE_COMPLEX64:
      return occupancy<CAPTURE_COMPLEX64>(*params, resident);
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
                  void* cursor_out, int blocks, void* xch, void* arrived,
                  const TrackParams& p, void* stream) {
  const size_t smem = smem_bytes(p);
  cudaError_t err = set_attributes<KIND>(smem);
  if (err != cudaSuccess) return (int)err;
  // C*S blocks of THREADS threads; cooperative where S >= 2, so that the
  // launch is refused if they cannot all be resident at once
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_channels * blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = blocks >= 2 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, track_fused_kernel<KIND>,
      (const typename Capture<KIND>::T*)capture, total, (const int8_t*)code,
      (const int*)ck_int, (const float*)ck_frac, (const int8_t*)code61,
      (const int*)ck61_int, (const float*)ck61_frac, (const float*)carr_t,
      (const float*)a_base, (const float*)q0_cyc, (const float*)init_dstep,
      (const float*)state_in, (const long long*)cursor_in, (float*)out,
      (float*)state_out, (long long*)cursor_out, (double*)xch,
      (unsigned*)arrived, p);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported here; not left for the next launch
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Host entry point, called through ctypes.  Launches the instance of
// capture kind `kind` with `blocks` blocks a channel on `stream`,
// exchanging through `xch` (C * 2 * blocks * 18 float64) and `arrived` (C
// uint32 counters, zero).  Does not synchronize; returns the launch's
// error, else cudaGetLastError() (0 on success).
extern "C" int bds3_track_fused(const void* capture, long long total,
                                int kind, const void* code,
                                const void* ck_int, const void* ck_frac,
                                const void* code61, const void* ck61_int,
                                const void* ck61_frac, const void* carr_t,
                                const void* a_base, const void* q0_cyc,
                                const void* init_dstep, const void* state_in,
                                const void* cursor_in, void* out,
                                void* state_out, void* cursor_out,
                                int blocks, void* xch, void* arrived,
                                const TrackParams* params, void* stream) {
  switch (kind) {
#define LAUNCH(K)                                                          \
  case K:                                                                  \
    return launch<K>(capture, total, code, ck_int, ck_frac, code61,        \
                     ck61_int, ck61_frac, carr_t, a_base, q0_cyc,          \
                     init_dstep, state_in, cursor_in, out, state_out,      \
                     cursor_out, blocks, xch, arrived, *params, stream);
    LAUNCH(CAPTURE_INT8)
    LAUNCH(CAPTURE_FLOAT32)
    LAUNCH(CAPTURE_COMPLEX64)
#undef LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}
