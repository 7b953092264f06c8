#!/usr/bin/env python3
"""A/B of the mix+prefix kernel's (K2's) design choices, on one NVIDIA GPU.

    python -m bds3_tpu_torch.tools.k2_ab

Builds `bds3_tpu_torch/csrc/mix_prefix.cu` as it is ("as_is") and copies
with one change each into `bds3_tpu_torch/_build/ab/`:

  * "no_lookback": no block waits for the earlier tiles' totals (every
    carry is 0, so P is wrong: timed only), what the look-back costs;
  * "acquire": the polls as ld.acquire.gpu loads, not relaxed ones;
  * "channel_major": tickets channel by channel, not tile by tile across
    the channels;
  * "two_blocks": __launch_bounds__(512, 2) in place of (512, 4), so
    ptxas may take more registers and fewer blocks share an SM.

For each shape of card.prefix_shapes, on card.prefix_inputs,
in two passes (as_is first in the first, last in the second): the
device's time per call under torch.profiler over 20 calls, the time per
call of 20 back-to-back calls (CUDA events), with output and scratch made
once, and a sha256 of P.  One JSON line per (shape, variant), the card's
name and power limit on each.  Exits non-zero if a variant other than
no_lookback gives other bits than as_is.  Imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import subprocess
import sys

# variant: (text in mix_prefix.cu, its replacement)
PATCHES = {
    "no_lookback": ("  for (int u = tid; u < t; u += THREADS) {",
                    "  for (int u = tid; u < 0; u += THREADS) {"),
    "acquire": ("ld.relaxed.gpu.global.u64 %0",
                "ld.acquire.gpu.global.u64 %0"),
    "channel_major": (
        "const int c = (int)(s_ticket % n_channels);\n"
        "  const int t = (int)(s_ticket / n_channels);",
        "const int c = (int)(s_ticket / n_tiles);\n"
        "  const int t = (int)(s_ticket % n_tiles);"),
    "two_blocks": ("#define MIN_BLOCKS 4", "#define MIN_BLOCKS 2"),
}


def build_variants() -> tuple[dict, dict]:
    """Each patched copy built as _build.py builds the port, all at once:
    its bds3_mix_prefix entry point, and ptxas' register lines."""
    from bds3_tpu_torch import _build
    from bds3_tpu_torch.track import prefix

    src = (_build.CSRC / "mix_prefix.cu").read_text()
    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (old, new) in PATCHES.items():
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} not in mix_prefix.cu")
        cu, so = out / f"mix_prefix_{name}.cu", out / f"libk2_{name}.so"
        cu.write_text(src.replace(old, new))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
    entries, ptxas = {"as_is": prefix._entry()}, {}
    for name, (so, proc) in jobs.items():
        o, e = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{e}")
        fn = ctypes.CDLL(str(so)).bds3_mix_prefix
        fn.restype = ctypes.c_int
        fn.argtypes = entries["as_is"].argtypes
        entries[name] = fn
        ptxas[name] = [ln.strip() for ln in (o + e).splitlines()
                       if "registers" in ln]
    return entries, ptxas


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_ab: no CUDA device", file=sys.stderr)
        return 2
    from bds3_tpu_torch import bench
    from bds3_tpu_torch.benchmarks.mxu_micro import time_ms
    from bds3_tpu_torch.tools import card
    from bds3_tpu_torch.track import prefix
    from bds3_tpu_torch.track.state import make_track_config

    smi = bench.nvidia_smi()
    as_is = prefix._entry
    entries, ptxas = build_variants()
    card.emit({"phase": "k2_ab_build", "ptxas": ptxas}, smi)
    dev = torch.device("cuda")
    order = list(entries)
    failed = []
    shapes = []
    for label, s, c in card.prefix_shapes():
        n = make_track_config(s).n_max
        host = card.prefix_inputs(c, n)
        args = tuple(torch.from_numpy(a).to(dev) for a in host) + (n,)
        res = {v: {"device_ms": [], "call_ms": []} for v in order}
        shapes.append((label, args, card.prefix_bound(*host[:4], n)[0], res))

    def runs():
        """Each shape's call through each variant, in two passes, with
        that variant's entry point in place while the caller times it."""
        for label, args, _, res in shapes:
            for variant in order + order[::-1]:
                prefix._entry = lambda v=variant: entries[v]
                out, scratch = prefix.buffers(args[1].shape[0], args[-1], dev)
                yield res[variant], functools.partial(
                    prefix.mix_prefix, *args, out=out, scratch=scratch)

    for r, run in runs():
        p_i, p_q = run()
        torch.cuda.synchronize()
        r["sha256"] = hashlib.sha256(p_i.cpu().numpy().tobytes()
                                     + p_q.cpu().numpy().tobytes()
                                     ).hexdigest()[:16]
        r["call_ms"].append(time_ms(run, 20))
    # the profiler last: it may leave later launches slower on the host
    for r, run in runs():
        r["device_ms"].append(card.device_ms(run)[0])
    for label, _, bound_ms, res in shapes:
        for variant in order:
            r = res[variant]
            equal = r["sha256"] == res["as_is"]["sha256"]
            if not equal and variant != "no_lookback":
                failed.append(f"{label} {variant}")
            busy = [d for d in r["device_ms"] if d is not None]
            card.emit({"phase": "k2_ab", "shape": label, "variant": variant,
                       **r, "equal_as_is": equal, "bound_ms": bound_ms,
                       "share": bound_ms / min(busy) if busy else None},
                      smi)
    prefix._entry = as_is
    print(smi)
    print(json.dumps({"ok": not failed, "differs": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
