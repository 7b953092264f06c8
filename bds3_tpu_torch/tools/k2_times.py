"""Device-bound times of K2 (bds3_tpu_torch/csrc/mix_prefix.cu) at every
tracking shape that runs it, with a hash of its output.

    python -m bds3_tpu_torch.tools.k2_times TAG

For each shape of card.prefix_shapes, on card.prefix_inputs, one JSON
line tagged with TAG:

  * `sha256`: of the P_i and P_q bytes of one call: two kernels that agree
    bit for bit print the same hash;
  * `repeat_equal`: a second call on the same inputs gave the same bytes;
  * `call_ms`: CUDA events around 20 back-to-back calls after a warm one,
    output and scratch made once (`prefix.buffers`), so the host's launch
    cost hides behind the device wherever the device takes longer;
  * `device_ms`, `kernels_per_call`: the device's own time per call and
    its kernel launches, from torch.profiler over 20 calls;
  * `bound_ms` (card.prefix_bound) and the shares of it; `bounded_by`
    says whether the host ("host": the calls take more than 1.2 times the
    device's time) or the device bounds the calls.

Run from the root of a checkout to time that checkout's K2; from two
checkouts' roots in turns (parent, change, change, parent) for an A/B
within one call, whose hashes show whether the two kernels agree bit for
bit.  Needs an NVIDIA GPU.
"""
import hashlib
import sys

import torch

from bds3_tpu_torch import bench
from bds3_tpu_torch.benchmarks.mxu_micro import time_ms
from bds3_tpu_torch.tools import card
from bds3_tpu_torch.track import prefix
from bds3_tpu_torch.track.state import make_track_config

REPS = 20


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    tag = sys.argv[1]
    smi = bench.nvidia_smi()
    dev = torch.device("cuda")
    lines, runs = [], []
    for label, s, c in card.prefix_shapes():
        n = make_track_config(s).n_max
        host = card.prefix_inputs(c, n)
        args = tuple(torch.from_numpy(a).to(dev) for a in host) + (n,)
        out, scratch = prefix.buffers(c, n, dev)

        def run(args=args, out=out, scratch=scratch):
            return prefix.mix_prefix(*args, out=out, scratch=scratch)

        p_i, p_q = (t.clone() for t in run())
        again = run()
        torch.cuda.synchronize()
        digest = hashlib.sha256(p_i.cpu().numpy().tobytes()
                                + p_q.cpu().numpy().tobytes()).hexdigest()
        lines.append({
            "tag": tag, "shape": label, "channels": c, "n": n,
            "sha256": digest[:16],
            "repeat_equal": bool(torch.equal(p_i, again[0])
                                 and torch.equal(p_q, again[1])),
            "call_ms": time_ms(run, REPS),
            "bound_ms": card.prefix_bound(*host[:4], n)[0]})
        runs.append(run)
    # the profiler last: it may leave later launches slower on the host
    for line, run in zip(lines, runs):
        dev_ms, kernels = card.device_ms(run, REPS)
        busy = dev_ms if dev_ms is not None else line["call_ms"]
        line.update(device_ms=dev_ms, kernels_per_call=kernels,
                    share_call=line["bound_ms"] / line["call_ms"],
                    share_device=line["bound_ms"] / busy,
                    bounded_by=("host" if line["call_ms"] > 1.2 * busy
                                else "device"))
        card.emit(line, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
