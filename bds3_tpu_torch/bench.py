"""The benchmark harness of `bench.py`, on one NVIDIA GPU.

    python3 -m bds3_tpu_torch.bench          # BENCH_BUDGET_S (default 540)

Runs the configurations of `bench.py:551-687` through the port, in the
same order and under the same names, with the same JSON fields, plus
`mxu_micro` (K3, `benchmarks/mxu_micro.py`'s shapes at 2000 iterations)
before the IO-bound streaming stage, which stays last:

  tracking_b2a_12ch (the headline), acquisition_b2a, tracking_b1c_12ch_nb,
  tracking_b1c_12ch_wb, tracking_b2a_48ch, tracking_b2a_12ch_40db,
  full_receiver_b2a, full_receiver_b1c, acquisition_b1c_resampled,
  acquisition_b1c, mxu_micro, streaming_49s.

The headline line (12-channel B2a tracking real-time factor at 99.375 Msps)
is printed after every stage with a `detail` dict of every stage so far,
the card's name in `device_kind`; the last stdout line is the most
complete.  Every stage is gated on the wall-clock budget.  Captures are
rendered on the card (io.render: the host synthesizer takes minutes to
hours for them) and cached under bds3_tpu_torch/_build/bench.

Two departures from `bench.py`: a stage that fails is recorded in `notes`
and makes the process exit non-zero at the end (there is no fallback to
another correlator); and the exit hooks are registered by `main()`, not on
import, so that the module imports without side effects.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import resource
import signal
import subprocess
import sys
import time

import numpy as np
import torch

PKG = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(PKG, "_build", "bench")
SECONDS = 2.2
CHANNELS = 12
B2A_SATS = [(5, 1650.0, 4100.0), (12, -2480.0, 8123.0),
            (19, 700.0, 55.0), (30, -310.0, 9000.0)]
B1C_SATS = [(7, 1230.0, 512.0), (21, -2875.0, 7300.0),
            (30, 460.0, 3100.0), (44, -1040.0, 9755.0)]
# Boulder, CO in ECEF [m] (same truth as tests/test_e2e_pvt.py)
RX_TRUTH = np.array([-1288398.0, -4721697.0, 4078625.0])
# bench.py's configurations in its order, then K3's stage before the
# streaming one (STAGES)
CONFIGS = ("tracking_b2a_12ch", "acquisition_b2a", "tracking_b1c_12ch_nb",
           "tracking_b1c_12ch_wb", "tracking_b2a_48ch",
           "tracking_b2a_12ch_40db", "full_receiver_b2a", "full_receiver_b1c",
           "acquisition_b1c_resampled", "acquisition_b1c", "streaming_49s")
STAGES = CONFIGS[:-1] + ("mxu_micro",) + CONFIGS[-1:]

DETAIL = {"configs": {}, "degraded": False, "notes": [], "skipped": [],
          "failed": []}
STATE = {"t_start": time.time(), "budget_s": 540.0, "headline": None,
         "emitted_final": False, "device": None}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def remaining() -> float:
    return STATE["budget_s"] - (time.time() - STATE["t_start"])


def emit():
    """Print the (current) headline JSON line to stdout, flushed; the last
    line printed is the most complete."""
    DETAIL["elapsed_s"] = round(time.time() - STATE["t_start"], 1)
    print(json.dumps({
        "metric": "b2a_12ch_tracking_realtime_factor",
        "value": STATE["headline"],
        "unit": "x_realtime_99.375Msps",
        "vs_baseline": STATE["headline"],
        "detail": DETAIL,
    }), flush=True)


def _emit_final(*args):
    if not STATE["emitted_final"]:
        STATE["emitted_final"] = True
        DETAIL["notes"].append("emitted by exit hook")
        emit()
    if args:             # invoked as a signal handler: exit now
        os._exit(124)


def gate(name: str, est_s: float) -> bool:
    """Stage gate: run only if the budget has room for the estimate."""
    if remaining() >= est_s:
        return True
    log(f"[bench] SKIP {name}: est {est_s:.0f}s > {remaining():.0f}s left")
    DETAIL["skipped"].append({"config": name, "est_s": est_s,
                              "remaining_s": round(remaining(), 1)})
    return False


def _fail(name: str, e: Exception) -> None:
    log(f"[bench] {name} failed: {e!r}")
    DETAIL["notes"].append(f"{name} failed: {type(e).__name__}: {e}")
    DETAIL["failed"].append(name)


def _stage(name, est_s, fn):
    """Run one bench stage under the budget gate; always emit after.  A
    failure is recorded, not retried another way."""
    if not gate(name, est_s):
        return
    log(f"[bench] >> {name} (elapsed {time.time() - STATE['t_start']:.0f}s)")
    try:
        fn()
    except Exception as e:
        _fail(name, e)
    emit()


def _sync():
    if STATE["device"].type == "cuda":
        torch.cuda.synchronize(STATE["device"])


def _cached(name: str, n: int, render) -> np.ndarray:
    """The int8 capture file `name` under CACHE as a read-only memmap,
    rendered first (render() -> int8 tensor on the card) unless a file of
    n samples is there."""
    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, name)
    if not (os.path.exists(path) and os.path.getsize(path) == n):
        t0 = time.time()
        sig = render()
        if sig.shape[0] != n:
            raise RuntimeError(f"{name}: rendered {sig.shape[0]} samples, "
                               f"expected {n}")
        tmp = f"{path}.{os.getpid()}.tmp"
        sig.cpu().numpy().tofile(tmp)
        os.replace(tmp, path)
        log(f"[bench] rendered {name}: {n / 1e6:.0f} MB in "
            f"{time.time() - t0:.1f}s")
    return np.memmap(path, dtype=np.int8, mode="r")


def _sat_params(sats, amplitude):
    from bds3_tpu_torch.io import SatParams

    return [SatParams(prn=p, doppler_hz=fd, code_phase_chips=cp,
                      amplitude=amplitude) for p, fd, cp in sats]


def get_capture(s, sats, cache_name, n_ms, amplitude=0.65) -> np.ndarray:
    """bench.py:99-118's capture (noise 2.0, seed 11), rendered on the
    card; a memmap of its cache file."""
    from bds3_tpu_torch.io.render import render_if

    n = int(n_ms * 1e-3 * s.sampling_freq)
    return _cached(cache_name, n, lambda: render_if(
        s, _sat_params(sats, amplitude), n_ms, STATE["device"],
        noise_std=2.0, seed=11)[:n])


def make_inits(s, sats, n_channels):
    """bench.py:121-134: channels from the synthesized truth, fanned out
    over the satellites."""
    from bds3_tpu_torch.track.state import ChannelInit

    inits = []
    for i in range(n_channels):
        prn, fd, cp = sats[i % len(sats)]
        code_rate = s.code_freq_basis * (1 + fd / s.carr_freq_basis)
        chi0 = cp % s.code_length
        start = ((s.code_length - chi0) % s.code_length) / code_rate
        inits.append(ChannelInit(
            prn=prn, acquired_freq=s.intermediate_freq + fd,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0,
        ))
    return inits


def _realized(res):
    return dataclasses.replace(res, outputs=res.outputs.realize())


def bench_tracking(name, s, sig_dev, inits, n_epochs, epochs_per_block,
                   passes, want="fused"):
    """Closed-loop tracking throughput (bench.py:137-213); returns the
    real-time factor.  No fallback: a failure raises."""
    from bds3_tpu_torch.observe.cn0 import channel_health
    from bds3_tpu_torch.track.driver import track

    dev = STATE["device"]
    t0 = time.time()
    res = track(sig_dev, s, inits, n_epochs=n_epochs,
                epochs_per_block=epochs_per_block, correlator=want,
                download=False, device=dev)
    res.outputs["d_ip"][:, -1:].cpu()        # force build + run
    compile_s = time.time() - t0
    ran = res.correlator
    log(f"[bench] {name}: correlator={ran} warmup+build {compile_s:.1f}s")

    walls = []
    for _ in range(passes):
        t0 = time.time()
        res = track(sig_dev, s, inits, n_epochs=n_epochs,
                    epochs_per_block=epochs_per_block, correlator=want,
                    download=False, device=dev)
        res.outputs.block_until_ready()
        walls.append(time.time() - t0)
    # lock evidence from one bulk download, outside the timed passes
    res = _realized(res)
    health = channel_health(res)
    locked = sum(h["lock_ok"] for h in health)
    cn0s = [round(h["cn0_db"], 1) for h in health]
    plls = [round(h["pll_lock"], 2) for h in health]
    best = min(walls)
    tracked_s = res.n_epochs * s.int_time
    rt = tracked_s / best
    n_ch = len(inits)
    log(f"[bench] {name}: {tracked_s:.2f}s x {n_ch}ch in {best:.3f}s best "
        f"(walls {[round(w, 3) for w in walls]}) -> {rt:.2f}x realtime "
        f"({rt * s.sampling_freq * n_ch / 1e9:.2f} G corr-samples/s); "
        f"locked {locked}/{n_ch} (C/N0 {min(cn0s):.1f}-{max(cn0s):.1f} "
        f"dB-Hz, PLL lock >= {min(plls):.2f})")
    DETAIL["configs"][name] = {
        "realtime_factor": round(rt, 3),
        "ms_per_epoch": round(best / res.n_epochs * 1e3, 4),
        "corr_gsamples_per_s": round(rt * s.sampling_freq * n_ch / 1e9, 2),
        "correlator": ran,
        "compile_s": round(compile_s, 1),
        "pass_walls_s": [round(w, 4) for w in walls],
        "channels": n_ch,
        "epochs": res.n_epochs,
        "locked": locked,
        "cn0_db": cn0s,
        "pll_lock": plls,
    }
    return rt


def bench_acquisition(name, s, sig, n_prns, warm_pass=True):
    """Cold-start PCPS acquisition wall time over n_prns satellites
    (bench.py:216-246), the window read from the host capture."""
    from bds3_tpu_torch.acquire.pcps import acquire
    from bds3_tpu_torch.receiver import acquisition_signal_length

    prns = tuple(range(1, n_prns + 1))
    win = np.asarray(sig[: acquisition_signal_length(s)])
    t0 = time.time()
    res = acquire(win, s, prns, device=STATE["device"])
    compile_s = time.time() - t0
    if warm_pass:
        t0 = time.time()
        res = acquire(win, s, prns, device=STATE["device"])
        wall = time.time() - t0
    else:
        wall = compile_s
    ndet = int(res.detected.sum())
    log(f"[bench] {name}: {n_prns} PRNs in {wall:.2f}s"
        f"{' warm' if warm_pass else ' COLD'} "
        f"(first {compile_s:.1f}s), detected {ndet}")
    DETAIL["configs"][name] = {
        "prns": n_prns,
        "wall_s": round(wall, 3),
        "warm": bool(warm_pass),
        "prn_per_s": round(n_prns / wall, 1),
        "compile_s": round(compile_s, 1),
        "detected": ndet,
    }


def _score_receiver(name, s, res, walls, fs, err_gate_m=None):
    """bench.py:253-289: fixes and median 3D error against the truth."""
    n_ch = len(res.channels)
    processed = res.track.n_epochs * s.int_time if res.track else 0.0
    corr = res.track.correlator if res.track else "none"
    fixes, err_med = 0, float("nan")
    if res.nav is not None:
        ok = np.isfinite(res.nav.x)
        fixes = int(ok.sum())
        err = np.sqrt((res.nav.x[ok] - RX_TRUTH[0]) ** 2
                      + (res.nav.y[ok] - RX_TRUTH[1]) ** 2
                      + (res.nav.z[ok] - RX_TRUTH[2]) ** 2)
        err_med = float(np.median(err)) if fixes else float("nan")
    rt_warm = processed / walls["warm"] if "warm" in walls else float("nan")
    log(f"[bench] {name}: acq+track({n_ch}ch)+decode+pvt on "
        f"{processed:.0f}s streamed scenario: "
        + ", ".join(f"{k} {v:.2f}s" for k, v in walls.items())
        + f" ({rt_warm:.2f}x rt warm, correlator={corr}); "
        f"{fixes} fixes, median 3D err {err_med:.3f} m")
    DETAIL["configs"][name] = {
        "fs_msps": round(fs / 1e6, 3),
        "tracked_s": round(processed, 2),
        **{f"wall_s_{k}": round(v, 2) for k, v in walls.items()},
        "realtime_factor_warm": round(rt_warm, 3),
        "channels": n_ch,
        "correlator": corr,
        "fixes": fixes,
        "median_3d_err_m": round(err_med, 3) if np.isfinite(err_med) else None,
        "timings_warm": {k: round(v, 3) for k, v in res.timings.items()
                         if isinstance(v, (int, float))},
    }
    if err_gate_m is not None and not (err_med < err_gate_m):
        DETAIL["degraded"] = True
        DETAIL["notes"].append(
            f"{name}: median 3D err {err_med:.2f} m exceeds the"
            f" {err_gate_m:.1f} m gate")


def probe_upload_mbs(n_bytes=100_000_000) -> float:
    """Measured host->device upload rate right now [MB/s]: a timed
    .to(device) of n_bytes with a synchronize."""
    probe = torch.from_numpy(np.zeros(n_bytes, np.int8))
    _sync()
    t0 = time.time()
    probe.to(STATE["device"])
    _sync()
    return n_bytes / 1e6 / (time.time() - t0)


def pick_transport(up_mbs: float) -> str:
    """bench.py:306-315: packed transport pays when the wire, not the host
    packing pass (~500 MB/s), is the bottleneck: int2 below 25 MB/s, int4
    below 250 MB/s, else none."""
    if up_mbs < 25.0:
        return "int2"
    return "int4" if up_mbs < 250.0 else "none"


def _scenario_file(name, sc, amplitude, seed) -> str:
    from bds3_tpu_torch.io.render import render_scenario

    s = sc.settings
    n = int(round(s.ms_to_process * 1e-3 * s.sampling_freq))
    _cached(name, n, lambda: render_scenario(
        sc, STATE["device"], noise_std=2.0, amplitude=amplitude, seed=seed))
    return os.path.join(CACHE, name)


def _run_receiver_passes(path, s, labels, epochs_per_block, transport):
    from bds3_tpu_torch.io.stream import StreamingCapture
    from bds3_tpu_torch.receiver import run_receiver

    walls, res = {}, None
    for label in labels:
        cap = StreamingCapture(path)
        t0 = time.time()
        res = run_receiver(cap, s, epochs_per_block=epochs_per_block,
                           verbose=False, device=STATE["device"],
                           transport=transport)
        _sync()
        walls[label] = time.time() - t0
    return res, walls


def bench_full_receiver(cold_and_warm=True):
    """bench.py:318-380 (BASELINE config 4, B2a): a 20 s scenario at
    24.84375 Msps streamed from disk -> acquisition -> tracking -> decode
    -> PVT, scored against the known receiver position; then the pilot
    secondary-code sync of every tracked channel."""
    from bds3_tpu_torch.config import b2a_settings
    from bds3_tpu_torch.io.scenario import make_scenario
    from bds3_tpu_torch.observe.secondary import b2a_pilot_secondary_sync

    fs = 99.375e6 / 4
    s = b2a_settings(
        sampling_freq=fs, intermediate_freq=fs / 4, ms_to_process=20_000,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 9)),
        num_channels=6,
    )
    sc = make_scenario(s, RX_TRUTH, n_sats=6, seed=3)
    path = _scenario_file("scenario4.bin", sc, 0.7, 1)
    up_mbs = probe_upload_mbs()
    transport = pick_transport(up_mbs)
    labels = ("cold", "warm") if cold_and_warm else ("warm",)
    res, walls = _run_receiver_passes(path, s, labels, 2000, transport)
    _score_receiver("full_receiver_b2a", s, res, walls, fs, err_gate_m=1.0)
    cfg = DETAIL["configs"]["full_receiver_b2a"]
    cfg["relay_probe_mb_s"] = round(up_mbs, 1)
    cfg["transport"] = transport
    try:
        syncs = [b2a_pilot_secondary_sync(res.track, ch)
                 for ch in range(len(res.channels))]
        cfg["pilot_secondary_sync"] = {
            "locked": sum(x["metric"] > 2.0 for x in syncs),
            "min_metric": round(min(x["metric"] for x in syncs), 2),
            "min_aligned": round(
                min(x["aligned_fraction"] for x in syncs), 3),
        }
    except Exception as e:
        _fail("full_receiver_b2a pilot_secondary_sync", e)


def bench_full_receiver_b1c():
    """bench.py:383-433 (BASELINE config 4, B1C): a 26 s wideband
    scenario at 33.125 Msps ("split" code blend, resampled acquisition)
    streamed from disk through the whole receiver."""
    from bds3_tpu_torch.config import b1c_settings
    from bds3_tpu_torch.io.scenario import make_scenario

    fs = 99.375e6 / 3
    s = b1c_settings(
        sampling_freq=fs, intermediate_freq=fs / 4, ms_to_process=26_000,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=5, wb_code_blend="split",
    )
    sc = make_scenario(s, RX_TRUTH, n_sats=5, sow_base=3600.0 * 3, seed=5)
    path = _scenario_file("scenario_b1c33.bin", sc, 1.3, 2)
    up_mbs = probe_upload_mbs()
    transport = pick_transport(up_mbs)
    res, walls = _run_receiver_passes(path, s, ("cold", "warm"), 500,
                                      transport)
    _score_receiver("full_receiver_b1c", s, res, walls, fs, err_gate_m=2.0)
    cfg = DETAIL["configs"]["full_receiver_b1c"]
    cfg["relay_probe_mb_s"] = round(up_mbs, 1)
    cfg["transport"] = transport


def bench_streaming(s):
    """bench.py:436-535: a 49 s (~4.9 GB) int8 file at 99.375 Msps, 12
    channels, streamed block by block from a StreamingCapture (pread with
    a lookahead thread) through K1 with bounded host and device memory,
    under a wall-clock deadline."""
    from bds3_tpu_torch.io.render import render_if
    from bds3_tpu_torch.io.stream import StreamingCapture
    from bds3_tpu_torch.observe.cn0 import channel_health
    from bds3_tpu_torch.track.driver import track

    n = int(49.0 * s.sampling_freq)
    path = os.path.join(CACHE, "stream49.bin")
    if not (os.path.exists(path) and os.path.getsize(path) == n):
        os.makedirs(CACHE, exist_ok=True)
        t0 = time.time()
        sats = _sat_params(B2A_SATS, 0.65)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            done = 0
            while done < n:
                ms = min(500.0, (n - done) / s.sampling_freq * 1e3)
                seg = render_if(s, sats, ms, STATE["device"], noise_std=2.0,
                                seed=100 + done, start_sample=done)
                f.write(seg.cpu().numpy().tobytes())
                done += seg.shape[0]
        os.replace(tmp, path)
        log(f"[bench] rendered 49 s capture ({n / 1e9:.2f} GB) in "
            f"{time.time() - t0:.0f}s")

    up_mbs = probe_upload_mbs()
    transport = pick_transport(up_mbs)
    pack_factor = {"none": 1.0, "int4": 2.0, "int2": 4.0}[transport]
    # the wire carries 1/pack_factor of the sample bytes, and a packed
    # transport is capped by its host packing pass (~500 MB/s,
    # bench.py:479-481); unpacked blocks skip that pass
    roofline = (min(up_mbs * pack_factor, 500.0) if transport != "none"
                else up_mbs) / 99.375
    deadline = max(20.0, remaining() - 30.0)
    log(f"[bench] streaming_49s: upload {up_mbs:.0f} MB/s, "
        f"transport={transport} (IO roofline {roofline:.2f}x realtime); "
        f"tracking up to 48.5s with a {deadline:.0f}s wall deadline")

    rss0_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    cap = StreamingCapture(path)
    inits = make_inits(s, B2A_SATS, 12)
    t0 = time.time()
    # 4 s blocks (bench.py:497-503); in-flight staging stays bounded to
    # two blocks by the lookahead sync
    res = track(cap, s, inits, n_epochs=48_500, epochs_per_block=4000,
                correlator="fused", download=False, sync_each_block=True,
                deadline_s=deadline, transport=transport,
                device=STATE["device"])
    res.outputs["d_ip"][:, -200:].cpu()
    wall = time.time() - t0
    tracked = res.n_epochs * s.int_time
    rt = tracked / wall
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    res = _realized(res)
    health = channel_health(res)
    locked = sum(h["lock_ok"] for h in health)
    log(f"[bench] streaming_49s: {tracked:.1f}s x 12ch streamed from "
        f"{n / 1e9:.2f} GB file in {wall:.1f}s ({rt:.2f}x rt sustained vs "
        f"{roofline:.2f}x IO roofline = {rt / max(roofline, 1e-9):.2f} of "
        f"roofline); peak RSS {rss_gb:.1f} GB (pre-phase {rss0_gb:.1f}); "
        f"locked {locked}/12")
    DETAIL["configs"]["streaming_49s"] = {
        "capture_gb": round(n / 1e9, 2),
        "tracked_s": round(tracked, 1),
        "wall_s": round(wall, 2),
        "realtime_factor_sustained": round(rt, 3),
        "relay_upload_mb_s": round(up_mbs, 1),
        "transport": transport,
        "io_roofline_rt": round(roofline, 2),
        "fraction_of_roofline": round(rt / max(roofline, 1e-9), 2),
        "peak_rss_gb": round(rss_gb, 2),
        "pre_phase_peak_rss_gb": round(rss0_gb, 2),
        "channels": 12,
        "correlator": res.correlator,
        "locked": locked,
        "cn0_db": [round(h["cn0_db"], 1) for h in health],
    }


def bench_mxu_micro():
    """K3 at every shape of benchmarks/mxu_micro.py:80-89, 2000 iterations:
    ms by CUDA events, TFLOP/s (split counts both products) and the share
    of the variant's dense peak."""
    from bds3_tpu_torch.benchmarks import mxu_micro

    rows = []
    for M, K, N, dtype, split in mxu_micro.bench_shapes():
        r = mxu_micro.run(M, K, N, dtype, split, device=STATE["device"],
                          out=sys.stderr)
        rows.append({"shape": [M, K, N], "variant": r["variant"],
                     "ms": round(r["ms"], 4),
                     "tflops": round(r["tflops"], 2),
                     "peak_share": round(r["bound_ms"] / r["ms"], 4)})
    DETAIL["configs"]["mxu_micro"] = {"iters": mxu_micro.ITERS,
                                      "kernel": mxu_micro.KERNEL_NAME,
                                      "shapes": rows}


def _card() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return None


def _track_b1c(s1, s1nb):
    """bench.py:592-619: B1C at 99.375 Msps, narrowband then wideband,
    300 epochs over the tracked span; returns the host capture."""
    sig1 = get_capture(s1, B1C_SATS, "capture_b1c47.bin", 6200.0,
                       amplitude=0.22)
    n_ep1 = 300
    need = int((n_ep1 + 4) * s1.samples_per_code)
    sig1_dev = torch.from_numpy(np.array(sig1[:need])).to(STATE["device"])
    inits1 = make_inits(s1, B1C_SATS, CHANNELS)
    for name, s in (("tracking_b1c_12ch_nb", s1nb),
                    ("tracking_b1c_12ch_wb", s1)):
        try:
            bench_tracking(name, s, sig1_dev, inits1, n_epochs=n_ep1,
                           epochs_per_block=150, passes=3)
        except Exception as e:
            _fail(name, e)
        emit()
    return sig1


def main() -> int:
    from bds3_tpu_torch.config import TrackMode, b1c_settings, b2a_settings
    from bds3_tpu_torch.io import amplitude_for_cn0

    STATE["t_start"] = time.time()
    STATE["budget_s"] = float(os.environ.get("BENCH_BUDGET_S", "540"))
    atexit.register(_emit_final)
    signal.signal(signal.SIGTERM, _emit_final)
    if not torch.cuda.is_available():
        log("[bench] no CUDA device (torch.cuda.is_available() is False)")
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    STATE["device"] = dev
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    DETAIL.update(backend="cuda", device=str(dev),
                  device_kind=torch.cuda.get_device_name(dev),
                  platform="gpu", device_count=torch.cuda.device_count(),
                  nvidia_smi=_card(), torch=torch.__version__,
                  budget_s=STATE["budget_s"])
    log(f"[bench] device={DETAIL['device_kind']} ({DETAIL['nvidia_smi']}) "
        f"budget={STATE['budget_s']:.0f}s")

    # ---- config 3 (headline): 12-channel B2a tracking ------------------
    s2 = b2a_settings()
    sig2 = get_capture(s2, B2A_SATS, "capture.bin", SECONDS * 1e3)
    sig2_dev = torch.from_numpy(np.array(sig2)).to(dev)
    inits2 = make_inits(s2, B2A_SATS, CHANNELS)
    try:
        STATE["headline"] = round(bench_tracking(
            "tracking_b2a_12ch", s2, sig2_dev, inits2,
            n_epochs=2000, epochs_per_block=2000, passes=6), 3)
    except Exception as e:
        _fail("tracking_b2a_12ch", e)
    emit()

    # ---- config 1: B2a cold-start acquisition ---------------------------
    _stage("acquisition_b2a", 40,
           lambda: bench_acquisition("acquisition_b2a", s2, sig2, 63))

    # ---- config 2: B1C tracking at the reference dataset rate ----------
    # the capture carries the full QMBOC pilot; narrowband tracks its
    # BOC(1,1) components, wideband all of it (amplitude 0.22 ~ 47 dB-Hz)
    s1 = b1c_settings(sampling_freq=99.375e6, intermediate_freq=14.58e6)
    s1nb = b1c_settings(sampling_freq=99.375e6, intermediate_freq=14.58e6,
                        track_mode=TrackMode.NARROWBAND)
    sig1 = None
    if gate("tracking_b1c", 120):
        try:
            sig1 = _track_b1c(s1, s1nb)
        except Exception as e:
            _fail("tracking_b1c", e)
        emit()

    # ---- config 5 (single-card aggregate): 48-channel B2a ---------------
    _stage("tracking_b2a_48ch", 45, lambda: bench_tracking(
        "tracking_b2a_48ch", s2, sig2_dev, make_inits(s2, B2A_SATS, 48),
        n_epochs=2000, epochs_per_block=2000, passes=3))

    # ---- low-C/N0 config: 12-channel tracking at 40 dB-Hz ---------------
    def _run40db():
        amp40 = amplitude_for_cn0(s2, 40.0, 2.0)
        sig40 = get_capture(s2, B2A_SATS, "capture40.bin", SECONDS * 1e3,
                            amplitude=amp40)
        bench_tracking("tracking_b2a_12ch_40db", s2,
                       torch.from_numpy(np.array(sig40)).to(dev),
                       make_inits(s2, B2A_SATS, CHANNELS), n_epochs=2000,
                       epochs_per_block=2000, passes=2)
        cfg40 = DETAIL["configs"].get("tracking_b2a_12ch_40db", {})
        if cfg40 and cfg40.get("locked", 0) < CHANNELS:
            DETAIL["degraded"] = True
            DETAIL["notes"].append(
                f"tracking_b2a_12ch_40db: only {cfg40.get('locked')}"
                f"/{CHANNELS} locked at 40 dB-Hz")

    _stage("tracking_b2a_12ch_40db", 50, _run40db)

    # ---- config 4: full receivers with real decoded fixes ---------------
    _stage("full_receiver_b2a", 60,
           lambda: bench_full_receiver(cold_and_warm=remaining() > 150))
    _stage("full_receiver_b1c", 75, bench_full_receiver_b1c)

    # ---- config 2 (acquisition): B1C 63-PRN GLRT cold start -------------
    if sig1 is not None:
        _stage("acquisition_b1c_resampled", 25,
               lambda: bench_acquisition("acquisition_b1c_resampled", s1,
                                         sig1, 63,
                                         warm_pass=remaining() > 60))
        s1f = dataclasses.replace(s1, resampling=False)
        _stage("acquisition_b1c", 35,
               lambda: bench_acquisition("acquisition_b1c", s1f, sig1, 63,
                                         warm_pass=remaining() > 120))

    # ---- K3: the matrix-throughput microbenchmark -----------------------
    _stage("mxu_micro", 10, bench_mxu_micro)

    # ---- capture-scale streaming LAST (IO-bound, budget-capped) ---------
    _stage("streaming_49s", 60, lambda: bench_streaming(s2))

    STATE["emitted_final"] = True     # the normal final emit
    emit()
    if DETAIL["failed"]:
        log(f"[bench] FAILED stages: {DETAIL['failed']}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
