"""Top-level receiver pipeline: acquisition -> tracking -> nav decode ->
PVT, on a PyTorch device.

Port of `bds3_tpu/receiver.py`, for B2a and B1C in every track mode on
real (int8, float32) and complex IQ captures, with B1C's band-pass
resampled acquisition.  An IQ8 capture's int8 I/Q pairs are read as a
complex64 source (`io.transport.IQ8Pairs`), as the reference widens them
(receiver.py:87-92), but they cross to the card as pairs and are widened
there.  Acquisition reads its window from the source as given.  A
capture that fits on the device goes there once (`device_resident`),
optionally packed (`transport`, int8 only); a larger one, or a
`StreamingCapture` asked to stream, is tracked block by block from the
host (track/driver.py).
C/N0 and lock health, navigation decoding and PVT run on the host, in the
port's own copies of the reference's host modules.

Under a profiler a run is one `receiver.run` span holding
`receiver.acquire`, `receiver.upload` (a capture uploaded whole),
`receiver.track` and `receiver.navpvt` (`utils/trace.py`); `timings`
holds each stage's `time.perf_counter` seconds, taken inside its span.
"""
from __future__ import annotations

import dataclasses
import pickle
import time

import numpy as np
import torch

from bds3_tpu_torch.acquire.pcps import AcqResults, acquire, make_acq_config
from bds3_tpu_torch.acquire.resample import plan_resample
from bds3_tpu_torch.config import FileType, Settings
from bds3_tpu_torch.io.ifdata import IFDataFile
from bds3_tpu_torch.io.transport import (
    IQ8Pairs,
    capture_dtype,
    check_packing,
    upload_capture,
    widen_iq8,
)
from bds3_tpu_torch.observe.cn0 import channel_health
from bds3_tpu_torch.pvt.solver import NavSolutions, post_navigation
from bds3_tpu_torch.track.driver import (
    TrackResults,
    as_capture,
    check_host_source,
    require_ported,
    track,
)
from bds3_tpu_torch.track.state import ChannelInit, assign_channels
from bds3_tpu_torch.utils.device import resolve_device
from bds3_tpu_torch.utils.trace import span, spanned

# device_resident="auto" keeps at least this share of the card's free
# memory for acquisition and tracking after the capture is uploaded
RESIDENT_FREE_SHARE = 0.5


@dataclasses.dataclass
class ReceiverResults:
    settings: Settings
    acq: AcqResults
    channels: list[ChannelInit]
    track: TrackResults | None
    nav: NavSolutions | None
    timings: dict
    # per-channel C/N0 + PLL-lock summary (observe.cn0.channel_health)
    health: list[dict] = dataclasses.field(default_factory=list)


def check_ported(s: Settings, transport: str = "none") -> None:
    """Raise before any file is opened or any device is touched: TypeError
    for another package's Settings, ValueError for a `transport` that is
    unknown or packs an IQ8 capture (io.transport.check_packing)."""
    require_ported(s)
    check_packing(transport, "IQ8" if s.file_type == FileType.IQ8
                  else "int8")


def acquisition_signal_length(s: Settings) -> int:
    """Samples needed by the acquisition stage (coarse FFT window + fine
    window, cf. postProcessing.m acq reads).  With resampling active the
    requirement is mapped back to the original rate (+ filter margin), as
    bds3_tpu/receiver.py:41-54 does."""
    if s.resampling and s.sampling_freq > s.resampling_threshold:
        plan = plan_resample(s)
        s_low = dataclasses.replace(
            s, sampling_freq=plan.new_fs, intermediate_freq=plan.new_if,
            resampling=False)
        need_low = acquisition_signal_length(s_low)
        return int(np.ceil((need_low + 2) * plan.old_fs / plan.new_fs)) \
            + 3 * 701
    cfg = make_acq_config(s)
    return cfg.n_fft + max(cfg.fine_noncoh, 1) * cfg.samples_per_code \
        + cfg.samples_per_code


def resident_fits(n_bytes: int, device: torch.device) -> bool:
    """device_resident="auto": whether a capture that takes n_bytes on the
    device (1, 4 or 8 bytes a sample: int8, float32, complex64) goes to
    `device` whole.  On a card, when it takes at most 1 - RESIDENT_FREE_SHARE
    of the free memory; on the CPU never (the host source is sliced block
    by block, as the reference does off its chip)."""
    if device.type != "cuda":
        return False
    free, _ = torch.cuda.mem_get_info(device)
    return n_bytes <= (1.0 - RESIDENT_FREE_SHARE) * free


def _channel_table(channels) -> str:
    lines = ["Ch | PRN |  Acquired freq [Hz] | Metric",
             "---+-----+---------------------+-------"]
    for ch, c in enumerate(channels):
        lines.append(f"{ch:2d} | {c.prn:3d} | {c.acquired_freq:19.1f} | "
                     f"{c.peak_metric:6.2f}")
    return "\n".join(lines)


@spanned("receiver.run")
def run_receiver(
    signal,
    settings: Settings,
    n_epochs: int | None = None,
    epochs_per_block: int = 200,
    checkpoint_path: str | None = None,
    prns=None,
    acq_results: AcqResults | None = None,
    verbose: bool = True,
    device: str | torch.device = "cuda",
    device_resident: bool | str = "auto",
    transport: str = "none",
) -> ReceiverResults:
    """Full cold-start pipeline on an IF capture, on `device`.

    signal: numpy array or memmap, StreamingCapture, tensor or IFDataFile;
    1-D real (int8, float32) or complex64 samples, or an IQ8 capture's
    (N, 2) int8 I/Q pairs (an IQ8 IFDataFile's data), which are tracked as
    complex64 I + jQ.
    Pass `acq_results` to reuse a previous acquisition (the reference's
    settings.skipAcquisition workflow, postProcessing.m:81-85).
    device_resident (bds3_tpu/receiver.py:96-148): True uploads a host
    capture whole before tracking, False tracks it block by block from the
    host; "auto" uploads it when it fits (resident_fits).  A tensor is
    tracked where it is.  transport: "none", "int4" or "int2", the packing
    of an int8 capture's upload, whole or per block (io.transport).
    Tracking runs the path `track` chooses ("auto").  What does not apply
    (a packing of a capture other than int8) raises before any work is
    done (check_ported, io.transport.check_packing).
    """
    check_ported(settings, transport)
    if isinstance(signal, IFDataFile):
        signal = signal.data
    pairs = len(signal.shape) == 2      # an IQ8 capture's I/Q pairs
    check_packing(transport, "IQ8" if pairs
                  else str(capture_dtype(signal.dtype)))
    dev = resolve_device(device)
    if pairs:
        signal = widen_iq8(signal.to(dev)) \
            if isinstance(signal, torch.Tensor) else IQ8Pairs(signal)
    if isinstance(signal, torch.Tensor):
        signal = as_capture(signal, dev)
    else:
        check_host_source(signal)
        if device_resident == "auto":
            device_resident = resident_fits(
                len(signal) * capture_dtype(signal.dtype).itemsize, dev)

    timings = {}
    with span("receiver.acquire"):
        t0 = time.perf_counter()
        if acq_results is not None:
            acq = acq_results
        else:
            # the window is read from the source as given
            # (receiver.py:108-113)
            acq = acquire(signal[: acquisition_signal_length(settings)],
                          settings, prns, device=dev)
        timings["acquire_s"] = time.perf_counter() - t0

    if device_resident is True and not isinstance(signal, torch.Tensor):
        # float32 and complex64 go up as they are, IQ8 pairs as int8
        with span("receiver.upload"):
            t0 = time.perf_counter()
            signal = upload_capture(signal, transport, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings["upload_s"] = time.perf_counter() - t0
        if verbose:
            print(f"[upload] capture -> {dev} in {timings['upload_s']:.2f}s "
                  f"(transport={transport})")
    if verbose:
        det = ", ".join(
            f"{p}({m:.1f})" for p, m in
            zip(acq.prns[acq.detected], acq.peak_metric[acq.detected])
        )
        print(f"[acquire] {timings['acquire_s']:.2f}s detected: ({det})")

    channels = assign_channels(acq, settings)
    if not channels:
        return ReceiverResults(settings, acq, [], None, None, timings)
    if verbose:
        print(_channel_table(channels))

    if n_epochs is None:
        n_epochs = settings.int_epochs
    # a host source not uploaded above streams per block, with the
    # packing applied to each block
    with span("receiver.track"):
        t0 = time.perf_counter()
        trk = track(signal, settings, channels, n_epochs=n_epochs,
                    epochs_per_block=min(epochs_per_block, n_epochs),
                    device=dev, transport=transport)
        timings["track_s"] = time.perf_counter() - t0
    ms_tracked = trk.n_epochs * settings.int_time * 1e3
    timings["track_realtime_factor"] = ms_tracked / 1e3 / timings["track_s"]
    if verbose:
        print(f"[track] {timings['track_s']:.2f}s for {ms_tracked:.0f} ms x "
              f"{len(channels)} channels "
              f"({timings['track_realtime_factor']:.2f}x realtime, "
              f"{trk.correlator} on {dev})")

    health = channel_health(trk)
    if verbose:
        for h in health:
            flag = "" if h["lock_ok"] else "  ** LOW LOCK **"
            print(f"[health] PRN {h['prn']:2d}: C/N0 {h['cn0_db']:5.1f} dB-Hz"
                  f"  PLL lock {h['pll_lock']:+.2f}{flag}")

    if checkpoint_path:
        # checkpoint between tracking and PVT (postProcessing.m:133-135)
        with open(checkpoint_path, "wb") as f:
            pickle.dump({"settings": settings, "acq": acq,
                         "channels": channels, "track": trk}, f)

    with span("receiver.navpvt"):
        t0 = time.perf_counter()
        nav = post_navigation(trk, settings)
        timings["pvt_s"] = time.perf_counter() - t0
    if verbose:
        if nav is None:
            print("[pvt] no solution (insufficient decoded satellites)")
        else:
            ok = np.isfinite(nav.x)
            print(f"[pvt] {ok.sum()}/{len(nav.x)} fixes in "
                  f"{timings['pvt_s']:.2f}s")
    return ReceiverResults(settings, acq, channels, trk, nav, timings,
                           health=health)


def resume_from_checkpoint(path: str) -> ReceiverResults:
    """Re-run PVT from a tracking checkpoint this module wrote (the
    reference's trackingResults.mat workflow).  Unpickles: read only
    checkpoints you wrote."""
    with open(path, "rb") as f:
        st = pickle.load(f)
    nav = post_navigation(st["track"], st["settings"])
    return ReceiverResults(st["settings"], st["acq"], st["channels"],
                           st["track"], nav, {})
