#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`bds3_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

In order, it

  1. builds the port's CUDA kernels from `bds3_tpu_torch/csrc` (ptxas'
     register and spill lines on the `build` line);
  2. prints the card's name and power limit, and K1's blocks per channel
     at the B1C preset, B1C narrowband (10 channels each) and B2a (12
     channels) at 99.375 Msps, with the blocks the card holds at once and
     each instance's shared memory: the preset and B2a must run S > 1;
  3. runs the card's test suite, `python -m pytest --noconftest -m cuda`
     over CARD_TESTS (every kernel against its plain version, the
     tracking paths, receivers, drivers and parallel paths at their
     full rates; see those files), and prints its exit code and wall
     time;
  4. prints {"ok": true, "device": {...}} last, only if all of them
     passed.

Any failure exits non-zero without that last line; so does a machine
without a usable CUDA device.  Nothing here imports JAX or the JAX
package.  The kernels' times come from the A/B tools
(`python -m bds3_tpu_torch.tools.{k1_loop_ab,k2_times,k3_times}`), the
cells' from `portbench`, traces from `bds3_tpu_torch.tools.profile_trace`.

`track_fused_bound` is K1's operation and byte count, which
`portbench/counts/k1.py` keeps a frozen copy of.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from bds3_tpu_torch.tools.card import roofline_ms  # noqa: F401 (K1's bound)

REPO = os.path.dirname(os.path.abspath(__file__))
CARD_TESTS = ("tests/test_torch_cuda.py", "tests/test_torch_cuda_paths.py")


def track_fused_bound(cfg, blksize: np.ndarray, span: int,
                      sample_bytes: int = 1) -> dict:
    """K1's bound for one launch whose epochs had these lengths
    (blksize (W, C)) and whose channels read `span` capture samples of
    `sample_bytes` each (1 int8, 4 float32, 8 complex64).
    Operations per sample: the carrier (2 multiplies and 3 adds for the
    phase, its mod, the angle multiply, one sine and one cosine, the two
    mixed products: 10; a complex sample's mix takes 4 products and 2
    adds: 4 more); per bank of taps that share a chip grid (one, or two
    for B1C wideband) two multiplies for the sample's ramp terms and, for
    each of E/P/L, 3 adds and a ceil for the chip index (14); per tap six
    multiply-adds (12).  Bytes: the capture span, the chip tables, the
    rows written."""
    taps = 2 if cfg.use_pilot else 1
    banks = 2 if cfg.wideband else 1
    per_sample = 10 + 14 * banks + 12 * (taps + (1 if cfg.wideband else 0)) \
        + (4 if cfg.complex_input else 0)
    samples = float(blksize.sum())
    n_ch = blksize.shape[1]
    tables = n_ch * (taps * (cfg.code_length * cfg.m_data + 32)
                     + (cfg.code_length * cfg.m_p61 + 32 if cfg.wideband
                        else 0))
    from bds3_tpu_torch.track.scan import slot_names

    rows = blksize.size * 4 * len(slot_names(cfg))
    ms, by = roofline_ms(samples * per_sample,
                         span * sample_bytes + tables + rows)
    return {"bound_ms": ms, "bound_by": by, "ops_per_sample": per_sample,
            "samples": samples}


def build() -> dict:
    """Builds the kernels: the seconds it took and ptxas' register and
    spill lines."""
    from bds3_tpu_torch import _build

    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    return {"seconds": dt, "ptxas": ptxas}


def k1_blocks_choice() -> dict:
    """K1's blocks per channel at the main shapes (20-epoch blocks): the
    blocks the card holds at once and the count chosen; fails unless the
    preset and B2a at 12 channels run more than one block a channel."""
    import torch

    from bds3_tpu_torch.config import b1c_settings, b2a_settings
    from bds3_tpu_torch.tools import card
    from bds3_tpu_torch.track import fused
    from bds3_tpu_torch.track.state import make_track_config

    dev = torch.cuda.current_device()
    out = {}
    for label, s, n_ch in (
            ("b1c_wb_preset_10ch", b1c_settings(), 10),
            ("b1c_nb_10ch", card.b1c_full_settings(), 10),
            ("b2a_12ch", b2a_settings(), 12)):
        cfg = make_track_config(s, epochs_per_block=20)
        out[label] = {"channels": n_ch,
                      "resident_blocks": fused.occupancy(cfg, n_ch, dev),
                      "blocks_per_channel": fused.blocks_per_channel(
                          cfg, n_ch, dev),
                      "smem_bytes": fused._smem_bytes(cfg)}
    for label in ("b1c_wb_preset_10ch", "b2a_12ch"):
        if out[label]["blocks_per_channel"] <= 1:
            raise AssertionError(f"K1 chose one block a channel at {label}: "
                                 f"{out}")
    return out


def main() -> int:
    if sys.argv[1:]:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from bds3_tpu_torch import bench
    from bds3_tpu_torch.tools import card

    smi = bench.nvidia_smi()
    card.emit({"phase": "build", **build(), "torch": torch.__version__,
               "k1_blocks": k1_blocks_choice()}, smi)
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                         "-m", "cuda", "-p", "no:cacheprovider", "-q",
                         *CARD_TESTS], cwd=REPO).returncode
    card.emit({"phase": "card_tests", "files": list(CARD_TESTS),
               "exit_code": rc, "wall_s": time.perf_counter() - t0}, smi)
    if rc != 0:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
