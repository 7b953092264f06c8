"""Device-bound times of K3 (bds3_tpu_torch/csrc/mxu_micro.cu) at every
shape of the bench, 2000 iterations, beside its yardstick: CUDA events
around `reps` back-to-back calls after a warm one, so that the host's
launch costs hide behind the device wherever the device takes longer.
One line a shape, tagged with the first argument: K3's ms and share of
its bound, then one `torch.mm` over the concatenated operands
(card.mxu_one_call; cuBLAS, TF32 off), its ms and how it multiplied.

    python -m bds3_tpu_torch.tools.k3_times TAG [variant ...]

Run from the root of a checkout to time that checkout's K3; from two
checkouts' roots in turns (parent, change, change, parent) for an A/B
within one call.  Needs an NVIDIA GPU.
"""
import sys

import numpy as np
import torch

from bds3_tpu_torch.benchmarks import mxu_micro as k3
from bds3_tpu_torch.benchmarks.mxu_micro import time_ms
from bds3_tpu_torch.tools import card

REPS = 20


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    tag, only = sys.argv[1], sys.argv[2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    for M, K, N, dtype, split in k3.bench_shapes():
        v = k3.variant_of(dtype, split)
        if only and v not in only:
            continue
        a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
        a, b = a.to(dev), b.to(dev).to(dtype)
        ms = time_ms(lambda: k3.mxu_micro(a, b, dtype, split), REPS)
        a_cat, b_rep = card.mxu_one_call_operands(a, b, v, k3.ITERS)
        mode = card.mxu_one_call_mode(v, dev)
        lib_ms = time_ms(lambda: card.mxu_one_call(a_cat, b_rep, mode),
                         REPS)
        del a_cat, b_rep
        print(f"{tag} {v:5s} {str((M, K, N)):16s} {ms:.4f} ms "
              f"share {k3.bound_ms(M, K, N, v) / ms:.3f} "
              f"one_mm {lib_ms:.4f} ms ({mode})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
