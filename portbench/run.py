"""One run of one cell.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the kind's: inputs from the seed, one untimed request), then the
timed window, then the check against the reference.  With --trace 0 the
result holds the end-to-end metrics; with --trace 1 the window runs under
torch.profiler and the result holds the per-layer metrics, the device's
busy time and a breakdown.  The last line of stdout is the result; the
numbers compared, each beside its limit, are the last lines of stderr
and the last key of the result.

Without a card, or with fewer cards than the cell asks for, or with JAX
or the JAX package loaded at the end, the run prints no result and exits
non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

from portbench import devtrace, importcheck, spec
from portbench.window import Window, median, run_window

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4
THREADS = 4        # the host threads of torch's CPU operations


def process_start_s() -> float:
    """When this process started, on time.time()'s clock (Linux /proc;
    elsewhere the import of this module)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = process_start_s()


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    family: str                 # the kind's FAMILY
    setup_s: float
    window: Window
    trace: devtrace.Trace | None
    extras: dict                # the kind's layer_inputs


def read_metrics(ctx: Context, traced: bool, readers=None) -> dict:
    """{name: {"value", "unit"}} of every reader of this mode (end-to-end
    without the trace, per-layer with it) that finds something to read."""
    readers = spec.metric_readers() if readers is None else readers
    out = {}
    for name, mod in readers.items():
        if mod.END_TO_END == traced:
            continue
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", readers=None) -> dict:
    """Set-up, window, metrics and check of one run; the result's fields
    without the import check."""
    import numpy as np
    import torch

    kind = spec.kind(cell.kind)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state = kind.setup(cell, seed, device)
    setup_s = time.time() - T_PROCESS

    def request():
        return kind.request(state)

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW_SPAN):
                window = run_window(request, seconds)
    else:
        window = run_window(request, seconds)
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    walls = [r.wall_s for r in window.requests if r.ok]
    print(f"portbench: {cell.name} seed {seed}: setup_s {setup_s!r}; "
          f"{window.attempted} requests ({window.failed} failed) in "
          f"{window.span_s!r} s; request wall median "
          f"{median(walls) if walls else float('nan')!r} s",
          file=sys.stderr)
    trace = devtrace.from_profiler(prof) if traced else None
    ctx = Context(kind.FAMILY, setup_s, window, trace,
                  kind.layer_inputs(state, window))
    metrics = read_metrics(ctx, traced, readers)
    checks = kind.check(state, window, np.random.default_rng(seed))
    correct = window.attempted > 0 and window.failed == 0 and all(
        v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {n: {"value": _finite(float(v)),
                            "limit": float(lim)}
                        for n, (v, lim) in checks.items()}
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return EXIT_NO_CARD
    torch.set_num_threads(THREADS)
    result = run_cell(cell, args.seed % 2 ** 63, args.seconds,
                      bool(args.trace))
    bad = importcheck.loaded_forbidden() + importcheck.static_violations()
    if bad:
        print("portbench: forbidden modules loaded or imported: "
              + ", ".join(bad), file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
