"""Command-line entry point (port of `bds3_tpu/__main__.py`).

    python -m bds3_tpu_torch --signal b2a --file BDS_B2a_IF_signal.bin \
        --device cuda

The same options as `python -m bds3_tpu`, plus --device.  `--signal b1c`
runs the B1C preset (wideband, with resampled acquisition above 15 Msps).
`--file-type 2` reads an IQ8 capture (interleaved int8 I/Q), tracked as
complex samples.  `--transport int4|int2` packs a real capture for its
host->device upload; with an IQ8 capture it exits with an error before
the file is opened.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="bds3_tpu_torch",
        description="BDS-3 B1C/B2a receiver on PyTorch "
                    "(CUDA kernels on Hopper)")
    p.add_argument("--signal", choices=("b1c", "b2a"), required=True)
    p.add_argument("--file", required=True, help="IF capture path")
    p.add_argument("--file-type", type=int, default=1,
                   help="1=8-bit real, 2=8-bit IQ interleaved")
    p.add_argument("--fs", type=float, help="sampling frequency [Hz]")
    p.add_argument("--if-freq", type=float, help="intermediate frequency [Hz]")
    p.add_argument("--ms", type=int, help="milliseconds to process")
    p.add_argument("--channels", type=int, help="number of channels")
    p.add_argument("--prns", type=str, help="comma list of PRNs to search")
    p.add_argument("--skip-samples", type=int, default=0)
    p.add_argument("--track-mode", type=int, choices=(0, 1, 2),
                   help="0=data only, 1=narrowband pilot, 2=wideband (B1C)")
    p.add_argument("--probe", action="store_true",
                   help="print raw-data statistics before processing")
    p.add_argument("--checkpoint", help="write tracking checkpoint here")
    p.add_argument("--resume", help="resume PVT from a tracking checkpoint")
    p.add_argument("--resample", action="store_true",
                   help="bandpass-decimate before acquisition")
    p.add_argument("--wb-code-blend",
                   choices=("composite", "nb", "split", "dotprod"),
                   help="B1C wideband code-DLL blend (see Settings)")
    p.add_argument("--utm-datum", choices=("wgs84", "ed50"),
                   help="UTM E/N datum (ed50 = reference cart2utm parity)")
    p.add_argument("--transport", choices=("none", "int4", "int2"),
                   default="none",
                   help="host->device capture packing")
    p.add_argument("--ldpc", action="store_true",
                   help="soft B-CNAV2 LDPC(96,48) decode of frames that "
                        "fail the hard systematic CRC")
    p.add_argument("--device", default="cuda",
                   help="PyTorch device to run on: cuda, cuda:N or cpu")
    args = p.parse_args(argv)

    from bds3_tpu_torch.config import FileType, TrackMode, b1c_settings, b2a_settings
    from bds3_tpu_torch.io.ifdata import IFDataFile, probe_stats
    from bds3_tpu_torch.receiver import (
        check_ported,
        resume_from_checkpoint,
        run_receiver,
    )

    if args.resume:
        _report(resume_from_checkpoint(args.resume))
        return 0

    overrides = {"file_name": args.file,
                 "file_type": FileType(args.file_type),
                 "skip_samples": args.skip_samples}
    if args.fs:
        overrides["sampling_freq"] = args.fs
    if args.if_freq:
        overrides["intermediate_freq"] = args.if_freq
    if args.ms:
        overrides["ms_to_process"] = args.ms
    if args.channels:
        overrides["num_channels"] = args.channels
    if args.prns:
        overrides["acq_satellite_list"] = tuple(
            int(x) for x in args.prns.split(","))
    if args.track_mode is not None:
        overrides["track_mode"] = TrackMode(args.track_mode)
    if args.resample:
        overrides["resampling"] = True
    if args.wb_code_blend:
        overrides["wb_code_blend"] = args.wb_code_blend
    if args.utm_datum:
        overrides["utm_datum"] = args.utm_datum
    if args.ldpc:
        overrides["ldpc_decode"] = True
    s = (b2a_settings if args.signal == "b2a" else b1c_settings)(**overrides)
    try:
        check_ported(s, args.transport)
    except ValueError as e:
        p.error(str(e))

    f = IFDataFile.open(args.file, s.file_type, s.skip_samples)
    if args.probe:
        st = probe_stats(f)
        print(f"probe: mean={st['mean']:.3f} std={st['std']:.2f} "
              f"range=[{st['min']:.0f},{st['max']:.0f}] "
              f"spectrum peak bin={st['spectrum_peak_bin']}")

    res = run_receiver(f, s, checkpoint_path=args.checkpoint,
                       device=args.device, transport=args.transport)
    _report(res)
    return 0


def _report(res):
    if res.nav is None:
        print("No navigation solution.")
        return
    ok = np.isfinite(res.nav.x)
    if ok.any():
        print(f"fixes: {ok.sum()}  "
              f"lat={np.nanmean(res.nav.latitude):.6f} deg  "
              f"lon={np.nanmean(res.nav.longitude):.6f} deg  "
              f"h={np.nanmean(res.nav.height):.1f} m  "
              f"PDOP={np.nanmean(res.nav.dop[1][ok]):.2f}")


if __name__ == "__main__":
    sys.exit(main())
