"""Dry run of every parallel path over n ranks at small sizes.

Port of `__graft_entry__.py:53` `dryrun_multichip`: channel-sharded
tracking (sharded_track_block and shard_map_track_block, the tracking
kernel in every rank on a card), PRN- and Doppler-sharded acquisition,
time-sharded non-coherent acquisition, time-sharded tracking on a
("time",) mesh, and on a 2-D ("time", "channel") mesh for B2a and for
B1C wideband QMBOC with the "split" code blend.  Inputs are
`_tiny_setup`'s (`__graft_entry__.py:10-37`): 4 Msps B2a, seeded int8
noise, one channel per rank.  It checks the shapes and prints one OK
line.

  python -m bds3_tpu_torch.parallel.dryrun [n] [--device cuda:0|cpu]

Its ranks meet over gloo and share one device: the card cuda:0 unless
another is named (--device cpu runs every rank on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np

from bds3_tpu_torch.config import TrackMode, b1c_settings, b2a_settings
from bds3_tpu_torch.parallel import worker
from bds3_tpu_torch.track.state import ChannelInit, make_track_config
from bds3_tpu_torch.utils.device import resolve_device


def tiny_inputs(n: int) -> tuple[dict, dict, list[dict]]:
    """(settings, arrays, cases) of the dry run over n ranks."""
    fs = 4e6
    s = b2a_settings(sampling_freq=fs, intermediate_freq=fs / 4)
    cfg = make_track_config(s, epochs_per_block=4)
    inits = [ChannelInit(prn=1 + i, acquired_freq=fs / 4 + 100.0 * i,
                         code_phase=17 * i, peak_metric=2.0)
             for i in range(n)]
    n_block = 17 * (n - 1) + 4 * (cfg.q0_int + 3) + cfg.n_max
    block = np.random.default_rng(0).integers(-30, 30, n_block) \
        .astype(np.int8)

    s_acq = dataclasses.replace(
        s, acq_satellite_list=tuple(range(1, 2 * n + 1)))
    acfg_bins = s_acq.num_doppler_bins
    per_rank = -(-acfg_bins // n)
    acq_sig = np.random.default_rng(1).integers(-30, 30, 4 * n * 4000 + 8192) \
        .astype(np.int8)

    t_inits = [ChannelInit(prn=1 + i, acquired_freq=fs / 4 + 130.0 * i,
                           code_phase=31 * i, peak_metric=2.0)
               for i in range(n)]
    n_ep = 4 * n
    n_sig = int(fs * 0.001 * (n_ep + 8)) + 8192
    tsig = np.random.default_rng(2).integers(-30, 30, n_sig).astype(np.int8)
    nt = n // 2 if n % 2 == 0 else n
    nc = n // nt

    fs_wb = 16e6
    s_wb = b1c_settings(sampling_freq=fs_wb, intermediate_freq=fs_wb / 4,
                        track_mode=TrackMode.WIDEBAND, wb_code_blend="split")
    wb_inits = [ChannelInit(prn=1 + i, acquired_freq=fs_wb / 4 + 210.0 * i,
                            code_phase=53 * i, peak_metric=2.0)
                for i in range(n)]
    n_sig_wb = int(fs_wb * 0.01 * (2 * nt + 7)) + 65536
    wsig = np.random.default_rng(3).integers(-30, 30, n_sig_wb) \
        .astype(np.int8)

    settings = {"b2a": s, "acq": s_acq, "wb": s_wb}
    arrays = {"block": block, "inits": worker.inits_to_array(inits),
              "acq_sig": acq_sig, "tsig": tsig,
              "t_inits": worker.inits_to_array(t_inits), "wsig": wsig,
              "wb_inits": worker.inits_to_array(wb_inits)}
    track = dict(settings="b2a", signal="block", inits="inits", epochs=4,
                 epochs_per_block=4, n_devices=n)
    tsh = dict(settings="b2a", signal="tsig", inits="t_inits")
    cases = [
        dict(name="channel", mode="channel", **track),
        dict(name="shard_map", mode="channel", shard_map=True, **track),
        dict(name="acq_prn", mode="acq_prn", settings="acq",
             signal="acq_sig", n_devices=n),
        dict(name="acq_doppler", mode="acq_doppler", settings="acq",
             signal="acq_sig", n_devices=n, bins=n * per_rank),
        dict(name="acq_noncoh", mode="acq_noncoh", settings="b2a",
             signal="acq_sig", n_devices=n, rounds=4, prns=[1, 2]),
        dict(name="time", mode="time", n_devices=n, epochs=n_ep,
             n_groups=min(2, n), **tsh),
        dict(name="time2d", mode="time2d", n_devices=n, shape=[nt, nc],
             epochs=4 * nt, n_groups=min(2, nt), **tsh),
        dict(name="time2d_b1c_wb", mode="time2d", n_devices=n,
             shape=[nt, nc], epochs=2 * nt, settings="wb", signal="wsig",
             inits="wb_inits", n_groups=min(2, nt)),
    ]
    return settings, arrays, cases


def dryrun_multichip(n: int, device: str = "cuda:0") -> str:
    resolve_device(device)          # a missing card fails here, not in n ranks
    settings, arrays, cases = tiny_inputs(n)
    with tempfile.TemporaryDirectory() as tmp:
        job, out = Path(tmp) / "job.npz", Path(tmp) / "out.npz"
        worker.write_job(job, cases, settings, arrays)
        r = worker.run_job(n, job, out, device=device,
                           store=str(Path(tmp) / "store"), timeout=900)
    nt = n // 2 if n % 2 == 0 else n
    assert r["channel/d_ip"].shape == (n, 4)
    for k in ("d_ip", "blksize", "cursor", "statef"):
        np.testing.assert_array_equal(r["shard_map/" + k], r["channel/" + k])
    assert r["acq_prn/peak"].shape == (2 * n,)
    assert r["acq_doppler/bin"].shape == (2 * n,)
    assert r["acq_noncoh/cube"].shape[0] == 2
    assert r["time/d_ip"].shape == (n, 4 * n)
    assert r["time2d/d_ip"].shape == (n, 4 * nt)
    assert r["time2d_b1c_wb/d_ip"].shape == (n, 2 * nt)
    assert "time2d_b1c_wb/p61_ip" in r      # the BOC(6,1) bank came through
    return (f"dryrun_multichip({n}): OK "
            f"(track outs {r['channel/d_ip'].shape}, "
            f"acq peaks {r['acq_prn/peak'].shape}, "
            f"noncoh cube {r['acq_noncoh/cube'].shape}, "
            f"timeshard outs {r['time/d_ip'].shape}, "
            f"2d timeshard outs {r['time2d/d_ip'].shape}, "
            f"2d B1C-WB outs {r['time2d_b1c_wb/d_ip'].shape}; "
            f"tracking-kernel launches "
            f"{int(sum(r[k].sum() for k in r if k.endswith('k1_launches')))})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
