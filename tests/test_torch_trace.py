"""The port's spans and counters (bds3_tpu_torch/utils/trace.py) on the
CPU: the tracking driver's spans under a CPU profiler, nested in its
root span, on the resident and the streamed path; acquisition's stages;
the receiver's upload; the counters of bytes and launches; the off path,
which calls nothing in torch; and the benchmark's five readers of them
(portbench/metrics/) on a real profiler trace of a tiny track(), and
the counter readers on counters made by hand."""
import math
import time
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bds3_tpu_torch.acquire import pcps
from bds3_tpu_torch.benchmarks import mxu_micro  # noqa: F401  (k3.launches)
from bds3_tpu_torch.config import b1c_settings, b2a_settings
from bds3_tpu_torch.io import SatParams, synthesize_if
from bds3_tpu_torch.io.transport import pack_int4, upload_capture
from bds3_tpu_torch.receiver import acquisition_signal_length, run_receiver
from bds3_tpu_torch.track import driver
from bds3_tpu_torch.track import fused, prefix  # noqa: F401  (k1, k2.launches)
from bds3_tpu_torch.track.scan import output_names, slot_names
from bds3_tpu_torch.track.state import ChannelInit
from bds3_tpu_torch.utils import trace
from portbench import devtrace, run, spec
from portbench.window import Request, Window

torch.set_num_threads(2)

S10 = dict(sampling_freq=10e6, intermediate_freq=2.5e6)
SATS = [SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                  amplitude=0.9),
        SatParams(prn=20, doppler_hz=-1200.0, code_phase_chips=5000.0,
                  amplitude=0.7)]
W = 10                  # epochs a block
N_EPOCHS = 40
READERS = ("track.setup_ms_per_signal_s", "track.download_ms_per_signal_s",
           "track.assemble_ms_per_signal_s",
           "track.blocks_idle_ms_per_signal_s", "track.d2h_MB_per_signal_s",
           "track.drain_hidden_share")


@pytest.fixture(scope="module")
def capture():
    """10 Msps B2a, 2 satellites, 60 ms, and a channel on each."""
    s = b2a_settings(**S10)
    sig = synthesize_if(s, SATS, n_ms=60.0, noise_std=1.0, seed=6)
    inits = []
    for sat in SATS:
        rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
        chi0 = sat.code_phase_chips % s.code_length
        start = ((s.code_length - chi0) % s.code_length) / rate
        inits.append(ChannelInit(
            prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0))
    return s, sig, inits


@pytest.fixture
def fresh_counters(monkeypatch):
    """An empty counter registry for the test, whatever ran before it."""
    monkeypatch.setattr(trace, "_COUNTS", defaultdict(int))


def _spans(prof) -> dict:
    """{name: [(start_us, end_us)]} of the host events of a profile."""
    out = defaultdict(list)
    for e in prof.events():
        out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def _track(capture, signal=None, **kw):
    s, sig, inits = capture
    return driver.track(sig if signal is None else signal, s, inits,
                        n_epochs=N_EPOCHS, epochs_per_block=W, device="cpu",
                        **kw)


def test_resident_track_spans_nest_under_track(capture, fresh_counters,
                                               monkeypatch):
    """The set-up, then the launch loop, inside the root span; each
    block's drain (its download, then its assembly), one of each a block,
    in block order: inside the launch loop for a block with LOOKAHEAD
    (here 2) blocks launched after it, after the loop for the last
    LOOKAHEAD blocks."""
    monkeypatch.setattr(driver, "LOOKAHEAD", 2)
    s, sig, inits = capture
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _track(capture, torch.from_numpy(sig))
    spans = _spans(prof)
    assert len(spans["track"]) == 1
    (r0, r1), = spans["track"]
    for name in ("track.setup", "track.blocks"):
        assert len(spans[name]) == 1, name
        (a, b), = spans[name]
        assert r0 <= a <= b <= r1, name
    (b0, b1), = spans["track.blocks"]
    assert spans["track.setup"][0][1] <= b0
    setup = driver.setup_tracking(torch.from_numpy(sig), s, inits, N_EPOCHS,
                                  W)
    n = setup.n_blocks
    down, asm = sorted(spans["track.download"]), sorted(spans["track.assemble"])
    assert len(down) == len(asm) == n >= 3
    drains = [x for pair in zip(down, asm) for x in pair]
    looped = 2 * (n - driver.LOOKAHEAD)
    assert all(b0 <= a <= b <= b1 for a, b in drains[:looped])
    assert all(b1 <= a <= b <= r1 for a, b in drains[looped:])
    assert all(p[1] <= q[0] for p, q in zip(drains, drains[1:]))
    assert not spans["k1.launch"]                           # card only
    assert not spans["track.read"] and not spans["track.upload"]
    c = trace.counters()
    assert c["track.blocks"] == n
    assert c["track.requests"] == 1
    assert c["track.signal_ms"] == pytest.approx(res.n_epochs * s.int_time
                                                 * 1e3)
    names = output_names(setup.cfg)
    assert c["track.d2h_bytes"] == res.n_epochs * len(inits) * len(names) \
        * 4
    assert c["track.drains_hidden"] <= c["track.blocks"]
    # on the CPU each block is done before the next is launched, so no
    # drain is hidden behind a later block
    assert c["track.drains_hidden"] == 0


def test_streamed_track_reads_and_uploads_each_block(capture,
                                                     fresh_counters):
    s, sig, inits = capture
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _track(capture, sig)
    spans = _spans(prof)
    setup = driver.setup_tracking(sig, s, inits, N_EPOCHS, W, "cpu")
    n = setup.n_blocks
    assert len(spans["track.read"]) == len(spans["track.upload"]) == n >= 3
    (r0, r1), = spans["track"]
    assert all(r0 <= a <= b <= r1 for a, b in spans["track.read"]
               + spans["track.upload"])
    assert not spans["track.blocks"]
    c = trace.counters()
    assert c["track.blocks"] == n
    assert c["upload.h2d_bytes"] == n * setup.schedule.block_len   # int8
    assert c["track.d2h_bytes"] == \
        res.n_epochs * len(inits) * len(output_names(setup.cfg)) * 4


def test_lazy_outputs_realize_counts_and_spans(capture, fresh_counters):
    s, sig, inits = capture
    res = _track(capture, torch.from_numpy(sig), download=False)
    assert "track.d2h_bytes" not in trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = res.outputs.realize()
    spans = _spans(prof)
    assert len(spans["track.download"]) == len(spans["track.assemble"]) == 1
    # the packed rows come down whole: the outputs and the state's slots
    slots = len(slot_names(driver.require_ported(s)))
    assert trace.counters()["track.d2h_bytes"] == \
        res.n_epochs * len(inits) * slots * 4
    assert set(out) == set(res.outputs.keys())


@pytest.mark.parametrize("packing", ["none", "int4"])
def test_upload_counts_the_bytes_sent(capture, fresh_counters, packing):
    _, sig, _ = capture
    upload_capture(sig, packing, "cpu")
    sent = sig.nbytes if packing == "none" else pack_int4(sig).nbytes
    assert trace.counters()["upload.h2d_bytes"] == sent


def test_receiver_upload_span(capture):
    """A host capture uploaded whole: the receiver's upload stage has its
    span, inside the root one, and its timing."""
    s, sig, inits = capture
    acq = pcps.AcqResults(
        prns=np.array([c.prn for c in inits]),
        carr_freq=np.array([c.acquired_freq for c in inits]),
        code_phase=np.array([c.code_phase for c in inits]),
        peak_metric=np.full(len(inits), 9.0),
        detected=np.ones(len(inits), bool),
        coarse_freq=np.array([c.acquired_freq for c in inits]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run_receiver(sig, s, n_epochs=20, epochs_per_block=W,
                           acq_results=acq, verbose=False, device="cpu",
                           device_resident=True)
    spans = _spans(prof)
    (r0, r1), = spans["receiver.run"]
    for name in ("receiver.acquire", "receiver.upload", "receiver.track",
                 "receiver.navpvt"):
        (a, b), = spans[name]
        assert r0 <= a <= b <= r1, name
    assert spans["track.blocks"] and not spans["track.read"]
    assert set(res.timings) == {"acquire_s", "upload_s", "track_s",
                                "track_realtime_factor", "pvt_s"}
    (a, b), = spans["receiver.upload"]
    assert 0 < res.timings["upload_s"] <= (b - a) * 1e-6


ACQ = {
    # (settings, the metric's span)
    "b2a": (b2a_settings(sampling_freq=40e6, intermediate_freq=9e6,
                         resampling=True, resampling_threshold=15e6,
                         acq_satellite_list=(19, 20)), "acquire.second_peak"),
    "b1c": (b1c_settings(sampling_freq=40e6, intermediate_freq=9e6,
                         resampling=True, resampling_threshold=15e6,
                         acq_satellite_list=(19, 20)), "acquire.glrt"),
}


@pytest.mark.parametrize("name", sorted(ACQ))
def test_acquire_stage_spans(name):
    """Resampled acquisition: the decimation, then the coarse search, the
    signal's metric and the fine search of the decimated window, once
    each and in that order."""
    s, metric = ACQ[name]
    sig = np.random.default_rng(5).integers(
        -8, 8, acquisition_signal_length(s)).astype(np.int8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pcps.acquire(sig, s, device="cpu")
    spans = _spans(prof)
    stages = ["acquire.resample", "acquire.coarse", metric, "acquire.fine"]
    assert [len(spans[n]) for n in stages] == [1, 1, 1, 1]
    starts = [spans[n][0][0] for n in stages]
    assert starts == sorted(starts)
    other = ({"acquire.second_peak", "acquire.glrt"} - {metric}).pop()
    assert not spans[other]


def test_counters_hold_the_launch_counts(monkeypatch):
    """The kernel wrappers' launch counts are counters from import on,
    and counters() reports what they hold."""
    names = ("k1.launches", "k2.launches", "k3.launches")
    assert set(names) <= set(trace.counters())
    for name, n in zip(names, (7, 3, 60)):
        monkeypatch.setitem(trace._COUNTS, name, n)
    c = trace.counters()
    assert (c["k1.launches"], c["k2.launches"], c["k3.launches"]) == \
        (7, 3, 60)


def test_spanned_puts_each_call_in_its_span():
    @trace.spanned("outer")
    def f(x, y=1):
        """f's doc."""
        with trace.span("inner"):
            return x + y

    assert f.__name__ == "f" and f.__doc__ == "f's doc."
    assert f(1, y=2) == 3                      # no profiler: no span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert f(2) == 3 and f(3) == 4
    spans = _spans(prof)
    assert len(spans["outer"]) == len(spans["inner"]) == 2
    assert all(a <= c <= d <= b for (a, b), (c, d)
               in zip(sorted(spans["outer"]), sorted(spans["inner"])))


def test_span_off_calls_nothing_in_torch(monkeypatch):
    """With no profiler, span() hands out the one shared no-op context and
    never reaches record_function; under a profiler it does."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("a") is trace.span("b")
    with trace.span("track"):
        with trace.span("track.setup"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="track.setup"):
            trace.span("track.setup")


def test_readers_on_a_cpu_profile_of_track(capture, fresh_counters):
    """The benchmark's six span and counter readers on a profile of one
    tiny track() as the harness takes it: each finds its spans or
    counters; the setup, download and assembly fit in the request, and
    the download and assembly read every block's span; the counter ratio
    is the rows' bytes over the seconds of signal; no drain is hidden on
    the CPU."""
    s, sig, inits = capture
    cap = torch.from_numpy(sig)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW_SPAN):
            t0 = time.perf_counter()
            res = _track(capture, cap)
            wall = time.perf_counter() - t0
    signal_s = res.n_epochs * s.int_time
    window = Window([Request(0.0, wall, True, signal_s, None)], wall)
    ctx = run.Context("track", 0.0, window, devtrace.from_profiler(prof),
                      {"signal_s": signal_s, "request_wall_s": wall,
                       "k1_bound_s": 0.0})
    readers = spec.metric_readers()
    got = {n: readers[n].read(ctx) for n in READERS}
    assert all(v is not None and math.isfinite(v) and v >= 0
               for v in got.values()), got
    host_ms = sum(got[n] for n in READERS[:3]) * signal_s
    assert 0 < host_ms <= wall * 1e3
    n_blocks = trace.counters()["track.blocks"]
    for name in ("track.download", "track.assemble"):
        spans = [(a, b) for a, b, n in ctx.trace.host if n == name]
        assert len(spans) == n_blocks >= 3, name
        assert got[f"{name}_ms_per_signal_s"] == pytest.approx(
            1e3 * sum(b - a for a, b in spans) / signal_s, rel=1e-9), name
    n_out = len(output_names(driver.require_ported(s)))
    per_s = res.n_epochs * len(inits) * n_out * 4 / 1e6 / signal_s
    assert got["track.d2h_MB_per_signal_s"] == pytest.approx(per_s,
                                                             rel=1e-12)
    # the CPU has no device intervals: the whole launch loop reads idle
    (a, b), = [(x, y) for x, y, n in ctx.trace.host if n == "track.blocks"]
    assert got["track.blocks_idle_ms_per_signal_s"] == pytest.approx(
        1e3 * (b - a) / signal_s)
    assert got["track.drain_hidden_share"] == 0.0
    assert run.read_metrics(ctx, True, {n: readers[n] for n in READERS}) \
        .keys() == set(READERS)


def test_device_readers_on_a_made_up_trace():
    """The readers that overlap host spans with device intervals, on a
    trace made by hand (ms): the launch loop's idle is its time with
    nothing on the device; the download is its span less the tracking
    kernel's time in it, the other device work (the copy) kept."""
    ms = 1e-3
    host = [(0 * ms, 2 * ms, "track.blocks"),
            (2 * ms, 9 * ms, "track.download"),
            (20 * ms, 24 * ms, "track.blocks"),
            (24 * ms, 30 * ms, "track.download")]
    device = [(0.5 * ms, 1 * ms, "track_fused_kernel<int8>"),
              (1.5 * ms, 6 * ms, "track_fused_kernel<int8>"),
              (6 * ms, 8 * ms, "Memcpy DtoH (Device -> Pageable)"),
              (21 * ms, 28 * ms, "track_fused_kernel<int8>")]
    tr = devtrace.Trace(device, host, (0.0, 40 * ms))
    ctx = run.Context("track", 0.0, Window([], 0.04), tr,
                      {"signal_s": 2.0, "request_wall_s": 0.04,
                       "k1_bound_s": 0.0})
    readers = spec.metric_readers()
    idle = readers["track.blocks_idle_ms_per_signal_s"].read(ctx)
    down = readers["track.download_ms_per_signal_s"].read(ctx)
    assert idle == pytest.approx((1.0 + 1.0) / 2.0)   # 0-0.5, 1-1.5, 20-21
    assert down == pytest.approx((3.0 + 2.0) / 2.0)   # 7-4, 6-4


@pytest.mark.parametrize("family,counts,want", [
    # the B1C preset's 10 channels of 13 blocks each, 18 launches
    ("track", {"k1.blocks": 10 * 13 * 18, "k1.launches": 18}, 100 * 130 / 132),
    # B2a's 12 channels of 11 blocks
    ("track", {"k1.blocks": 12 * 11 * 5, "k1.launches": 5}, 100.0),
    # more channels than SMs, one block each: above 100%, since the blocks
    # of a launch are then not all resident at once
    ("track", {"k1.blocks": 200 * 3, "k1.launches": 3}, 100 * 200 / 132),
    # no block launched (the plain version on the CPU)
    ("track", {"k1.blocks": 0, "k1.launches": 0}, None),
    # a program without the counter
    ("track", {"k1.launches": 18}, None),
    ("acquire", {"k1.blocks": 130, "k1.launches": 1}, None),
])
def test_sm_share_reader(monkeypatch, family, counts, want):
    """k1.sm_share: K1's blocks over its launches over the card's SMs,
    from the counters; nothing where there is nothing to read."""
    from types import SimpleNamespace

    monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(multi_processor_count=132))
    ctx = run.Context(family, 0.0, Window([], 1.0), None, {})
    got = spec.metric_readers()["k1.sm_share"].read(ctx)
    assert got == (want if want is None else pytest.approx(want, rel=1e-12))


@pytest.mark.parametrize("family,counts,want", [
    # B2a's 244 blocks a request: all but the last hidden
    ("track", {"track.drains_hidden": 243, "track.blocks": 244},
     100 * 243 / 244),
    # B1C's 18
    ("track", {"track.drains_hidden": 17, "track.blocks": 18}, 100 * 17 / 18),
    # none hidden (the CPU), or a block launched but not drained
    ("track", {"track.drains_hidden": 0, "track.blocks": 5}, 0.0),
    # no block
    ("track", {"track.drains_hidden": 0, "track.blocks": 0}, None),
    # a program without the counter
    ("track", {"track.blocks": 244}, None),
    ("acquire", {"track.drains_hidden": 3, "track.blocks": 4}, None),
])
def test_drain_hidden_share_reader(monkeypatch, family, counts, want):
    """track.drain_hidden_share: the drains hidden behind a later block
    over the blocks, from the counters; nothing where there is nothing to
    read."""
    monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    ctx = run.Context(family, 0.0, Window([], 1.0), None, {})
    got = spec.metric_readers()["track.drain_hidden_share"].read(ctx)
    assert got == (want if want is None else pytest.approx(want, rel=1e-12))


def test_k1_counters_are_listed_before_a_launch():
    """k1.blocks is in the registry from the wrapper's import on, so a run
    with no launch reads 0."""
    c = trace.counters()
    assert c["k1.blocks"] >= 0
