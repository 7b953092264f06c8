"""The readings that set a cell's limits, on the chip at the cell's size.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--control]

For each seed: the cell's set-up, one request of the program and the
numbers the check compares for its answer (the sound reading); with
--control, also the numbers of the reference put in the program's place
at the precision below the configuration's (the kind's `control`).  One
JSON line per seed on stdout.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench import spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    kind = spec.kind(cell.kind)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        state = kind.setup(cell, seed % 2 ** 63, "cuda")
        t1 = time.time()
        _, kept = kind.request(state)
        line = {"workload": cell.name, "seed": seed, "setup_s": t1 - t0,
                "sound": kind.numbers(state, kept,
                                      np.random.default_rng(seed))}
        t2 = time.time()
        line["check_s"] = t2 - t1
        if args.control:
            n_ep = kept[0]["blksize"].shape[1]
            ctl = kind.control(state, n_ep)
            line["control"] = kind.numbers(state, ctl,
                                           np.random.default_rng(seed))
            line["control_s"] = time.time() - t2
        print(json.dumps(line), flush=True)
        del state, kept
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
