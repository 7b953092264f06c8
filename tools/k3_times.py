"""Device-bound times of K3 (bds3_tpu_torch/csrc/mxu_micro.cu) at every
shape of the bench, 2000 iterations: CUDA events around `reps`
back-to-back calls after a warm one, so that the host's launch costs hide
behind the device wherever the device takes longer.  One line a shape,
tagged with the first argument.

    python3 tools/k3_times.py TAG [variant ...]

Run from the root of a checkout, or from another checkout's root with
this script's path, to time that checkout's K3 (an A/B within one call:
parent, change, change, parent).  Needs an NVIDIA GPU.
"""
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bds3_tpu_torch.benchmarks import mxu_micro as k3  # noqa: E402

REPS = 20


def time_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    tag, only = sys.argv[1], sys.argv[2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(17)
    for M, K, N, dtype, split in k3.bench_shapes():
        v = k3.variant_of(dtype, split)
        if only and v not in only:
            continue
        a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
        a, b = a.cuda(), b.cuda().to(dtype)
        ms = time_ms(lambda: k3.mxu_micro(a, b, dtype, split))
        print(f"{tag} {v:5s} {str((M, K, N)):16s} {ms:.4f} ms "
              f"share {k3.bound_ms(M, K, N, v) / ms:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
