#!/usr/bin/env python3
"""A/B of the CUDA tracking kernel's (K1's) two exact summation schemes,
on one NVIDIA GPU.

    python3 tools/k1_sum_ab.py

K1 (`bds3_tpu_torch/csrc/track_fused.cu`) adds each sample, signed by its
chip, into float64 running sums.  This script builds the kernel as it is
("float64") and a copy whose `<acc>` block is a compensated float32
(Kahan) sum, each thread's sum then taken to float64 ("kahan"), into
`bds3_tpu_torch/_build/ab/`.  For each scheme, in one process on one card:

  * the 250-epoch gate of chip_smoke.py (`kernel_vs_plain_receiver_shapes`:
    B2a, 20 Msps, the five channels the receiver acquires, K1 at 1, 2 and
    the chosen number of blocks per channel against its plain version,
    blksize and cursors exact, correlators within 1e-3 scaled);
  * block times at the chosen blocks per channel, by CUDA events, in turns
    (float64, kahan, kahan, float64): the B1C preset's 20-epoch wideband
    block (99.375 Msps, 10 channels), that 250-epoch B2a block, and the B2a
    2000-epoch block at 99.375 Msps, 12 channels.

It reuses chip_smoke.py's captures (cached under
bds3_tpu_torch/_build/captures, or synthesized first).  One JSON line per
result, the card's name and power limit on each; exits non-zero if a
scheme fails its gate.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KAHAN = """// <acc>
// compensated float32 sum (Kahan) of cv * x, taken to float64 at the end
struct Acc {
  float s, c;
  __device__ __forceinline__ void zero() { s = c = 0.0f; }
  __device__ __forceinline__ void add(int cv, float x, double xd) {
    const float y = (float)cv * x - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
  __device__ __forceinline__ double value() const {
    return (double)s - (double)c;
  }
};
// </acc>"""


def build_kahan():
    """The kernel with the Kahan <acc> block, built as _build.py builds the
    port; its bds3_track_fused entry point with every argtype declared."""
    from bds3_tpu_torch import _build
    from bds3_tpu_torch.track import fused

    src = (_build.CSRC / "track_fused.cu").read_text()
    src, n = re.subn(r"^// <acc>$.*?^// </acc>$", lambda _: KAHAN, src,
                     flags=re.S | re.M)
    if n != 1:
        raise RuntimeError("no <acc> block in track_fused.cu")
    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "track_fused_kahan.cu", out / "libk1_kahan.so"
    cu.write_text(src)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    fn = ctypes.CDLL(str(so)).bds3_track_fused
    fn.restype = ctypes.c_int
    fn.argtypes = fused._entry().argtypes
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "track_fused" in ln or "registers" in ln]
    return fn, ptxas


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_sum_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bds3_tpu_torch.track import fused
    from bds3_tpu_torch.track.driver import as_capture, setup_tracking
    from bds3_tpu_torch.receiver import run_receiver

    smi = cs.nvidia_smi()
    name, limit = (x.strip() for x in smi.split(",", 1))
    cs.CARD.update(card=name, power_limit=limit)
    entries = {"float64": fused._entry()}
    entries["kahan"], ptxas = build_kahan()
    cs.emit({"phase": "k1_sum_ab_build", "kahan_ptxas": ptxas})

    def use(scheme):
        fused._entry = lambda: entries[scheme]

    caps = cs.Captures()
    dev = torch.device("cuda")
    try:
        # the B2a receiver's channels, as phase_receiver finds them
        s_rx = cs.e2e_settings()
        sig = caps.get("e2e")
        use("float64")
        res = run_receiver(sig, s_rx, epochs_per_block=250, verbose=False,
                           device="cuda")
        cap_rx = as_capture(sig, dev)
        setups = {
            "b2a_receiver_250ep": (cap_rx, setup_tracking(
                cap_rx, s_rx, res.channels, 250, 250)),
        }
        cap_b1c = as_capture(caps.get("b1c_full"), dev)
        s = cs.b1c_preset_settings()
        setups["b1c_wb_preset_20ep"] = (cap_b1c, setup_tracking(
            cap_b1c, s, cs.make_inits(s, cs.FULL_SATS, 10), 20, 20))
        cap_b2a = as_capture(caps.get("full"), dev)
        s = cs.full_settings()
        setups["b2a_99msps_2000ep"] = (cap_b2a, setup_tracking(
            cap_b2a, s, cs.make_inits(s, cs.FULL_SATS, 12), 2000, 2000))
    finally:
        caps.stop()

    failed = []
    for scheme in entries:
        use(scheme)
        cap, setup = setups["b2a_receiver_250ep"]
        try:
            cmp = cs.compare_block(setup.cfg, cap, setup,
                                   f"{scheme} receiver shapes")
            cs.emit({"phase": "k1_sum_ab_gate", "scheme": scheme,
                     "passed": True, **cmp})
        except AssertionError as e:
            failed.append(scheme)
            cs.emit({"phase": "k1_sum_ab_gate", "scheme": scheme,
                     "passed": False, "error": str(e)[:2000]})

    for label, (cap, setup) in setups.items():
        reps = 1 if label.startswith("b2a_99") else 5
        turns = {k: [] for k in entries}
        for scheme in ("float64", "kahan", "kahan", "float64"):
            use(scheme)
            turns[scheme].append(cs.time_block(fused.fused_track_block, setup,
                                               cap, reps))
        cs.emit({"phase": "k1_sum_ab_time", "block": label,
                 "blocks_per_channel": cs.k1_blocks(setup),
                 "ms": {k: sum(v) / len(v) for k, v in turns.items()},
                 "ms_turns": turns})
    use("float64")
    print(smi)
    print(json.dumps({"ok": not failed, "failed_gate": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
