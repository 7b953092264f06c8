"""Launcher for runs of several ranks.

Port of `tools/launch_multihost.py`.  Every backend runs the same user
program, which calls `bds3_tpu_torch.parallel.multihost.initialize()`
(argument-free: it reads the torch rendezvous variables) and then builds
its mesh.

  local  spawn N ranks on this host (gloo on the CPU, or ranks sharing
         one card; NCCL with one card each) and wait for all of them;
         if one fails, the others are stopped and its exit code returned.
  slurm  emit (or submit with --submit) an sbatch script whose tasks
         take their rank from SLURM_PROCID and the world from
         SLURM_NTASKS.

Usage:
  python -m bds3_tpu_torch.parallel.launch local --nproc 2 -- \\
      python my_receiver.py --channels 24
  python -m bds3_tpu_torch.parallel.launch slurm --nodes 4 [--submit] -- \\
      python my_receiver.py
"""
from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(nproc: int, cmd: list[str], env_extra: dict | None = None,
                 timeout: float | None = None) -> int:
    """Run `cmd` as nproc local ranks with MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK and LOCAL_RANK set, and wait for every one.  Returns
    0 when all succeed; else the code of the first rank that failed,
    after stopping the others (124 when `timeout` seconds pass first)."""
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(nproc), RANK=str(rank),
                   LOCAL_RANK=str(rank))
        env.update(env_extra or {})
        procs.append(subprocess.Popen(cmd, env=env))
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                rc = 124
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return rc


SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name=bds3-torch
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --exclusive

# rank 0's node holds the rendezvous
export MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
export MASTER_PORT={port}
export WORLD_SIZE="$SLURM_NTASKS"

srun --export=ALL bash -c '
  export RANK="$SLURM_PROCID" LOCAL_RANK="$SLURM_LOCALID"
  exec {cmd}
'
"""


def emit_slurm(nodes: int, cmd: list[str], port: int = 29500) -> str:
    return SBATCH_TEMPLATE.format(nodes=nodes, port=port,
                                  cmd=" ".join(shlex.quote(c) for c in cmd))


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="backend", required=True)

    p_local = sub.add_parser("local")
    p_local.add_argument("--nproc", type=int, default=2)
    p_local.add_argument("cmd", nargs=argparse.REMAINDER)

    p_slurm = sub.add_parser("slurm")
    p_slurm.add_argument("--nodes", type=int, required=True)
    p_slurm.add_argument("--port", type=int, default=29500)
    p_slurm.add_argument("--submit", action="store_true")
    p_slurm.add_argument("cmd", nargs=argparse.REMAINDER)

    args = ap.parse_args()
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("missing program to launch (append: -- python ...)")

    if args.backend == "local":
        t0 = time.time()
        rc = launch_local(args.nproc, cmd)
        print(f"[launch] {args.nproc} local ranks finished rc={rc} in "
              f"{time.time() - t0:.1f}s", file=sys.stderr)
        return rc
    script = emit_slurm(args.nodes, cmd, args.port)
    if args.submit:
        return subprocess.run(["sbatch"], input=script.encode()).returncode
    print(script)
    return 0


if __name__ == "__main__":
    sys.exit(main())
