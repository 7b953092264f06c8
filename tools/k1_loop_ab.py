#!/usr/bin/env python3
"""A/B of the parts of the CUDA tracking kernel's (K1's) sample loop, on
one NVIDIA GPU.

    python3 tools/k1_loop_ab.py [--variants a,b,...] [--reps N]

K1 (`bds3_tpu_torch/csrc/track_fused.cu`) sums each epoch's samples in
runs of 16 bytes (16 int8, 4 float32 or 2 complex64 samples): each run's
coarse-table entries and chip-index wrap taken once, an int8 run read as
one 16-byte load, the carrier's modulo, the chip indices' ceil and the
int8 conversion in exact cheap forms.  This script
builds the kernel with its loop replaced, one part at a time, into
`bds3_tpu_torch/_build/ab/`:

  * `parent`: the loop the kernel had before the runs, one sample a
    thread in turn, with fmodf, ceilf then a conversion, a byte load
    converted by I2F and the sign-xor sums (on the runs' shared-memory
    layout);
  * `p_mod`, `p_ceil`, `p_cvt`: that loop with one exact form each (x -
    truncf(x) for fmodf, cvt.rpi for ceilf and a conversion, the byte
    permute into a float for I2F), and `p_forms` with all three;
  * `runs_lone`: the runs, every kind's samples loaded one by one as the
    run is summed;
  * `runs_vec`: the runs, every kind's run one 16-byte vector load;
  * `ahead`: the kernel's loop with each run's load issued before the
    thread sums its previous run;
  * `new_cvtrpi`: the kernel's loop with cvt.rpi in place of the float add
    rounded up for the runs' chip indices;
  * `acc_xor`: the kernel with each float64 sum adding xd with cv's sign
    bit xored into its own copy (the parent's form), in place of one
    fused multiply-add by cv as +-1.0;
  * `new`: the kernel as it is (int8 runs one vector load each, float32
    and complex64 runs loaded sample by sample, each as it is summed).

For each variant, in one process on one card: `-Xptxas -v` registers and
spills of the int8 instance, the SASS of its sample loops (the loops'
instructions and the count of each kind of instruction in them; the
whole SASS is kept beside each library as `.sass`), every
output of the blocks below against the plain version bit for bit, and
the blocks' times by CUDA events in turns (the variants in order, then in
reverse): the B2a preset's 20-epoch block (99.375 Msps, 12 channels; int8,
and its float32 and complex64 casts) and the B1C preset's 20-epoch
wideband block (10 channels).  One JSON line per result, the card's name
and power limit on each; exits non-zero if a variant differs from the
plain version.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# The parent's loop and helpers, on the runs' shared-memory layout (each
# tap's table `stride` long, padded by SMEM_PAD).  MOD1, CEIL and LOAD are
# filled in per variant.
OLD_HELPERS = r"""
__device__ __forceinline__ float ab_fmod1(float x) {
  float r = fmodf(x, 1.0f);
  return r < 0.0f ? r + 1.0f : r;
}

__device__ __forceinline__ int ab_chip_index(float base_m, float ck_frac,
                                             int ck_int, float rsm, float jd,
                                             int lm, bool once) {
  const float frac = ((base_m + ck_frac) + rsm) + jd;
  const int raw = ck_int + CEIL(frac) - 1;
  if (once) return raw < 0 ? raw + lm : (raw >= lm ? raw - lm : raw);
  const int idx = raw % lm;
  return idx < 0 ? idx + lm : idx;
}

template <int KIND>
__device__ __forceinline__ typename Capture<KIND>::S ab_load(
    const typename Capture<KIND>::T* cap, long long g, long long total) {
  return Capture<KIND>::load(cap, g, total);
}

template <>
__device__ __forceinline__ float ab_load<CAPTURE_INT8>(
    const int8_t* cap, long long g, long long total) {
  return LOAD_INT8;
}

"""
I2F_LOAD = "(g >= 0 && g < total) ? (float)cap[g] : 0.0f"
PERMUTE_LOAD = ("(g >= 0 && g < total) ? __uint_as_float(__byte_perm("
                "(uint32_t)(uint8_t)cap[g] ^ 0x80u, 0x4B000000u, 0x7540)) "
                "- 8388736.0f : 0.0f")

OLD_LOOP = r"""    Acc acc[N_ACC];
#pragma unroll
    for (int i = 0; i < N_ACC; ++i) acc[i].zero();
    const bool once =
        wraps_once(base[0], base[2], dsm, n, p.sm, p.lm) &&
        (!p.wideband ||
         wraps_once(base61[0], base61[2], dsm61, n, p.sm61, p.lm61));
    (void)runs;
    (void)ep;
    for (int j = lo + tid; j < hi; j += THREADS) {
      const typename Capture<KIND>::S x = ab_load<KIND>(capture, cursor + j,
                                                        total);
      const int k = j / SPLIT;
      const float r_f = (float)(j % SPLIT);
      const float j_f = (float)j;
      const float cyc = MOD1(((s_carr[k] + rem_cyc) + r_f * ab) + j_f * d_cyc);
      float sn, cs;
      sincosf(p.two_pi * cyc, &sn, &cs);
      float ib, qb;
      Capture<KIND>::mix(x, cs, sn, &ib, &qb);
      const double ib_d = (double)ib, qb_d = (double)qb;
      const float rsm = r_f * p.sm;
      const float jd = j_f * dsm;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int idx = ab_chip_index(base[e], s_ck_frac[k], s_ck_int[k], rsm,
                                      jd, p.lm, once);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t < p.n_taps) {
            const int cv = s_code[t * stride + idx + SMEM_PAD];
            acc[t * 6 + e].add(cv, ib, ib_d);
            acc[t * 6 + 3 + e].add(cv, qb, qb_d);
          }
        }
      }
      if (p.wideband) {
        const float rsm61 = r_f * p.sm61;
        const float jd61 = j_f * dsm61;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const int idx = ab_chip_index(base61[e], s_ck61_frac[k],
                                        s_ck61_int[k], rsm61, jd61, p.lm61,
                                        once);
          const int cv = s_code61[idx + SMEM_PAD];
          acc[12 + e].add(cv, ib, ib_d);
          acc[15 + e].add(cv, qb, qb_d);
        }
      }
    }
"""

# The runs' loop with each run's load issued before the previous run is
# summed.
RUNS_AHEAD = r"""  // <runs>
  int run = ra + tid;
  RawRun next;
  if (run < rb) next = fetch_run<KIND>(cap, cursor + (long long)run * R, total);
  for (; run < rb; run += THREADS) {
    const RawRun cur = next;
    if (run + THREADS < rb)
      next = fetch_run<KIND>(cap, cursor + (long long)(run + THREADS) * R,
                             total);
    add_run<KIND, TAPS, WB>(ep, cur, run * R, acc);
  }
  // </runs>"""

# The float64 sums with cv's sign bit xored into each sum's own copy of
# the sample's float64 pair (the parent's form).
ACC_XOR = r"""// <acc>
struct Acc {
  double s;
  __device__ __forceinline__ void zero() { s = 0.0; }
  __device__ __forceinline__ void add(int cv, float x, double xd) {
    const int hi = __double2hiint(xd) ^ (cv & (int)0x80000000);
    s += __hiloint2double(hi, __double2loint(xd));
  }
  __device__ __forceinline__ double value() const { return s; }
};
// </acc>"""

KERNEL_ANCHOR = "template <int KIND>\n__global__ void __launch_bounds__"
VARIANTS = ("parent", "p_mod", "p_ceil", "p_cvt", "p_forms", "runs_lone",
            "runs_vec", "ahead", "new_cvtrpi", "acc_xor", "new")
VECTOR_TEST = "if (KIND == CAPTURE_INT8 && g0 >= 0 && g0 + C::RUN <= total)"


def _sub_block(src: str, tag: str, text: str) -> str:
    out, n = re.subn(rf"^\s*// <{tag}>$.*?^\s*// </{tag}>$",
                     lambda _: text, src, flags=re.S | re.M)
    if n != 1:
        raise RuntimeError(f"no single <{tag}> block in track_fused.cu")
    return out


def _replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"expected one {old!r} in track_fused.cu")
    return src.replace(old, new)


def variant_source(name: str, src: str) -> str:
    """track_fused.cu with the sample loop of variant `name`."""
    if name == "new":
        return src
    if name == "new_cvtrpi":
        return _replace_once(
            src, "return pos + __float_as_int(__fadd_ru(frac, CEIL_MAGIC));",
            "return pos + (CEIL_MAGIC_BITS + __float2int_ru(frac));")
    if name == "runs_lone":
        return _replace_once(src, VECTOR_TEST, "if (false)")
    if name == "runs_vec":
        return _replace_once(src, VECTOR_TEST,
                             VECTOR_TEST.replace("KIND == CAPTURE_INT8 && ",
                                                 ""))
    if name == "ahead":
        return _sub_block(src, "runs", RUNS_AHEAD)
    if name == "acc_xor":
        return _sub_block(src, "acc", ACC_XOR)
    forms = {"p_mod": {"mod"}, "p_ceil": {"ceil"}, "p_cvt": {"cvt"},
             "p_forms": {"mod", "ceil", "cvt"}}.get(name, set())
    helpers = OLD_HELPERS.replace(
        "CEIL(frac)", "__float2int_ru(frac)" if "ceil" in forms
        else "(int)ceilf(frac)").replace(
        "LOAD_INT8", PERMUTE_LOAD if "cvt" in forms else I2F_LOAD)
    loop = OLD_LOOP.replace("MOD1(", "mod1(" if "mod" in forms
                            else "ab_fmod1(")
    src = _replace_once(src, KERNEL_ANCHOR, helpers + KERNEL_ANCHOR)
    return _sub_block(_sub_block(src, "loop", loop), "acc", ACC_XOR)


def build(name: str, src: str):
    """Compiles a variant as _build.py compiles the port; returns (its
    library path, ptxas lines, registers and spill bytes of each capture
    kind's instance)."""
    from bds3_tpu_torch import _build

    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"track_fused_{name}.cu", out / f"libk1_{name}.so"
    cu.write_text(variant_source(name, src))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return so, ptxas_usage(proc.stdout + proc.stderr)


def ptxas_usage(log: str) -> dict:
    """{capture kind: {registers, spill_stores, spill_loads}} of the
    kernel's instances from `-Xptxas -v` output."""
    usage, kind = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z18track_fused_kernelILi"
                      r"(\d)E", ln)
        if m:
            kind = int(m.group(1))
            continue
        if kind is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            usage.setdefault(kind, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            usage.setdefault(kind, {})["registers"] = int(m.group(1))
            kind = None
    return usage


SASS_KINDS = ("FADD", "FMUL", "FFMA", "DADD", "LOP3", "F2I", "I2F", "F2F",
              "FRND", "MUFU", "LDS", "LDG", "PRMT", "SEL", "FSEL", "IADD3",
              "IMAD", "ISETP", "FSETP", "MOV", "SHF", "BRA", "CALL")


def sass_text(so) -> str:
    from bds3_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout


def sass_loops(so, kind: int = 0) -> list:
    """The loops of the capture kind's instance (int8 by default) in the
    library's SASS, largest first: each loop's instructions from the
    target of a backward branch to the branch, and its count of each of
    SASS_KINDS.  An inner loop (sincosf's argument reduction, the
    modulo) is counted inside the loop that holds it too."""
    text = sass_text(so)
    (so.parent / f"{so.stem}.sass").write_text(text)
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs
                 if f.startswith(f"_Z18track_fused_kernelILi{kind}E")), "")
    insts = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                         r"([^;]*);", body):
        insts.append((int(m.group(1), 16), m.group(3), m.group(4)))
    addr_index = {a: i for i, (a, _, _) in enumerate(insts)}
    loops = []
    for i, (a, op, args) in enumerate(insts):
        if not op.startswith("BRA"):
            continue
        t = re.search(r"0x([0-9a-f]+)", args)
        if not t or int(t.group(1), 16) >= a:
            continue
        start = addr_index.get(int(t.group(1), 16))
        if start is None:
            continue
        ops = collections.Counter(o.split(".")[0] for _, o, _ in
                                  insts[start:i + 1])
        loops.append({"instructions": i + 1 - start,
                      **{k: ops.get(k, 0) for k in SASS_KINDS}})
    loops.sort(key=lambda x: -x["instructions"])
    return loops


def _setups(dev):
    import torch

    import chip_smoke as cs
    from bds3_tpu_torch.io import synthesize_if
    from bds3_tpu_torch.track.driver import as_capture, setup_tracking

    sats = cs.sat_params(cs.FULL_SATS)
    s_b2a = cs.full_settings()
    cap = as_capture(synthesize_if(s_b2a, sats, n_ms=60.0, noise_std=2.0,
                                   seed=11), dev)
    out = {"b2a_int8": (cap, setup_tracking(
        cap, s_b2a, cs.make_inits(s_b2a, cs.FULL_SATS, 12), 20, 20))}
    out["b2a_float32"] = (cap.float(), out["b2a_int8"][1])
    setup = out["b2a_int8"][1]
    out["b2a_complex64"] = (cap.to(torch.complex64), dataclasses.replace(
        setup, cfg=dataclasses.replace(setup.cfg, complex_input=True)))
    sig = synthesize_if(cs.b1c_full_settings(), sats, n_ms=260.0,
                        noise_std=2.0, seed=11)
    cap = as_capture(sig, dev)
    s = cs.b1c_preset_settings()
    out["b1c_int8"] = (cap, setup_tracking(
        cap, s, cs.make_inits(s, cs.FULL_SATS, 10), 20, 20))
    return out


def _bits_differ(a, b) -> int:
    import torch

    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per timing of a B2a block (B1C: a fifth)")
    args = ap.parse_args()
    names = args.variants.split(",")

    import torch

    if not torch.cuda.is_available():
        print("k1_loop_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bds3_tpu_torch import _build
    from bds3_tpu_torch.track import fused
    from bds3_tpu_torch.track.scan import track_block_reference

    smi = cs.nvidia_smi()
    name, limit = (x.strip() for x in smi.split(",", 1))
    cs.CARD.update(card=name, power_limit=limit)
    src = (_build.CSRC / "track_fused.cu").read_text()
    argtypes = fused._entry().argtypes
    entries = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        futures = {v: pool.submit(build, v, src) for v in names}
        for v in names:
            so, usage = futures[v].result()
            fn = ctypes.CDLL(str(so)).bds3_track_fused
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
            entries[v] = fn
            loops = sass_loops(so)
            cs.emit({"phase": "k1_loop_ab_build", "variant": v,
                     "ptxas": usage, "sass_loops": loops[:4]})

    def use(v):
        fused._entry = lambda: entries[v]

    setups = _setups(torch.device("cuda"))
    differ = []
    for label, (cap, setup) in setups.items():
        args_ = (setup.cfg, cap, setup.tables, setup.consts, setup.state)
        st_r, rows_r = track_block_reference(*args_)
        for v in names:
            use(v)
            st_k, rows_k = fused.fused_track_block(*args_)
            torch.cuda.synchronize()
            n_rows = _bits_differ(rows_k, rows_r)
            n_state = _bits_differ(st_k.statef, st_r.statef)
            cursors = bool(torch.equal(st_k.cursor, st_r.cursor))
            if n_rows or n_state or not cursors:
                differ.append((v, label))
            cs.emit({"phase": "k1_loop_ab_exact", "variant": v,
                     "block": label, "rows_differ": n_rows,
                     "state_differ": n_state, "cursors_equal": cursors})

    for label, (cap, setup) in setups.items():
        reps = max(1, args.reps // 5) if label.startswith("b1c") \
            else args.reps
        turns = {v: [] for v in names}
        for v in names + names[::-1]:
            use(v)
            turns[v].append(cs.time_block(fused.fused_track_block, setup,
                                          cap, reps))
        cs.emit({"phase": "k1_loop_ab_time", "block": label,
                 "blocks_per_channel": cs.k1_blocks(setup, cap.dtype),
                 "ms": {v: sum(t) / len(t) for v, t in turns.items()},
                 "ms_turns": turns})
    print(smi)
    print(json.dumps({"ok": not differ, "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
