"""The benchmark of the PyTorch and CUDA receiver `bds3_tpu_torch`.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything here is data found by name plus one harness (`run.py`):
`configs/<config>.json`, `workloads/<cell>.json`, `traffic/<traffic>.json`
(a mix's parameters, read by the loop of its `kind`, `kinds/<kind>.py`) and
`metrics/<metric>.py` (one reader per metric).  `gen/` makes the inputs
from the seed, `reference/` is the plain reference that decides
`correct`, and `counts/` holds the operation and byte counts of the
rooflines.  None of `gen/`, `reference/` or `counts/` imports the program.
"""
