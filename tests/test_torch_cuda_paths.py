"""The port's paths on the card at their full rates, to their results:
acquisition over 63 PRNs and tracking to lock at 99.375 Msps (B2a as
int8 and as IQ8, the B1C preset wideband, B1C narrowband through K1, K2
and the plain bucket path), the receivers to position fixes (B2a as
int8, as its float32 cast and as IQ8; B1C narrowband and the bench's
B1C wideband), each receiver's kernels against their plain versions at
its shapes, the drivers of the JAX paths through their mains, and the
bench's K3 stage.  tests/test_torch_cuda.py holds the kernels to their
plain versions block by block.

The captures (bds3_tpu_torch/tools/card.py) are rendered on the card
once and cached under bds3_tpu_torch/_build/bench/.  Nothing here needs
JAX.  Marked `cuda` and skipped without an NVIDIA GPU; on a machine with
one run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_paths.py
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from bds3_tpu_torch.config import FileType, b1c_settings, b2a_settings
from bds3_tpu_torch import bench
from bds3_tpu_torch.tools import card
from bds3_tpu_torch.track import driver, fused, prefix
from bds3_tpu_torch.track.scan import pallas_prefix, track_block_bucket
from bds3_tpu_torch.utils.trace import counters

pytestmark = pytest.mark.cuda

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _iq8(s):
    """`s` for an IQ8 capture (interleaved int8 I/Q, tracked as complex)."""
    return dataclasses.replace(s, file_type=FileType.IQ8)


@functools.lru_cache(maxsize=None)
def _on_card(kind):
    """card.capture(kind) on the card, int8."""
    return torch.from_numpy(np.array(card.capture(kind))).to("cuda")


def _lock_count(trk, last: int) -> int:
    """Channels whose mean |I_P| exceeds 4 mean |Q_P| over the last
    epochs."""
    ip = np.abs(trk.outputs["d_ip"][:, -last:]).mean(axis=1)
    qp = np.abs(trk.outputs["d_qp"][:, -last:]).mean(axis=1)
    return int((ip > 4 * qp).sum())


# --- acquisition at 99.375 Msps ----------------------------------------------

@pytest.mark.parametrize("preset", ["b2a", "b1c_resampled"])
def test_full_rate_acquisition_finds_the_four_satellites(cuda, preset):
    """The preset's acquisition over PRNs 1-63 on the 2.2 s, 99.375 Msps
    capture of bench.B2A_SATS finds exactly those 4: B2a's, and the B1C
    preset's resampled one, whose resampler on the card must also be
    within 5e-3 of mean|host| of the host scipy filter in the interior of
    the acquisition window."""
    from bds3_tpu_torch.acquire import resample
    from bds3_tpu_torch.acquire.pcps import acquire
    from bds3_tpu_torch.receiver import acquisition_signal_length

    if preset == "b2a":
        s, kind = b2a_settings(), "full"
    else:
        s, kind = b1c_settings(), "b1c_full"
    capture = _on_card(kind)
    n = acquisition_signal_length(s)
    acq = acquire(capture[:n], s, device=cuda)
    assert len(acq.prns) == 63
    assert sorted(int(p) for p in acq.detected_prns()) == \
        sorted(p for p, _, _ in bench.B2A_SATS)
    if preset == "b2a":
        return
    plan = resample.plan_resample(s)
    on_card = resample.resample_signal_device(capture[:n], s, plan)
    host = resample.resample_signal(np.asarray(card.capture(kind)[:n]), s,
                                    plan)
    guard = int(3 * 701 * plan.new_fs / plan.old_fs) + 4
    on_card, host = on_card.cpu().numpy()[guard:-guard], host[guard:-guard]
    err = float(np.abs(on_card - host).max()) / float(np.abs(host).mean())
    assert err <= 5e-3, err


# --- tracking to lock at 99.375 Msps -----------------------------------------

# signal: (settings, channels, epochs, last epochs of the lock count), on
# card.capture("full") for B2a and card.capture("b1c_full") for B1C
SIGNALS = {"b2a": (b2a_settings, 12, 2000, 500),
           "b1c_wb": (b1c_settings, 10, 200, 100),
           "b1c_nb": (card.b1c_full_settings, 10, 200, 100)}
# correlator: (the path that must run, the counter of its kernel)
RAN = {"auto": (fused.KERNEL_NAME, "k1.launches"),
       "bucket_pallas": (prefix.KERNEL_NAME, "k2.launches"),
       "bucket": ("bucket", None)}
# case: (signal, capture, correlator)
TRACKING = {
    "b2a_auto": ("b2a", "int8", "auto"),
    "b2a_bucket_pallas": ("b2a", "int8", "bucket_pallas"),
    "b2a_iq8": ("b2a", "iq8", "auto"),
    "b1c_wb_auto": ("b1c_wb", "int8", "auto"),
    "b1c_nb_auto": ("b1c_nb", "int8", "auto"),
    "b1c_nb_bucket_pallas": ("b1c_nb", "int8", "bucket_pallas"),
    "b1c_nb_bucket_pallas_float32": ("b1c_nb", "float32", "bucket_pallas"),
    "b1c_nb_bucket": ("b1c_nb", "int8", "bucket"),
}


@pytest.mark.parametrize("case", list(TRACKING))
def test_full_rate_tracking_locks(cuda, case):
    """track() in one block over the 2.2 s capture of bench.B2A_SATS at
    99.375 Msps, channels fanned out over the 4 satellites from their
    truth: B2a 12 channels over 2000 epochs (int8 through K1 and through
    bucket_pallas, K2; the same satellites rendered on the card as IQ8
    and widened to complex64 through K1's complex instance), the B1C
    preset (wideband, composite) and B1C narrowband 10 channels over 200
    (K1; K2 on int8 and on its float32 cast, whose every output and epoch
    end equals the int8 run's; the plain bucket path).  Each runs its
    path, launches its kernel and locks every channel."""
    from bds3_tpu_torch.io.render import render_if
    from bds3_tpu_torch.io.transport import widen_iq8

    signal_, kind, correlator = TRACKING[case]
    make, n_ch, n_ep, last = SIGNALS[signal_]
    s = make()
    base = _on_card("full" if signal_ == "b2a" else "b1c_full")
    if kind == "iq8":
        s = _iq8(s)
        capture = widen_iq8(render_if(
            s, bench.sat_params(bench.B2A_SATS, 0.65), bench.SECONDS * 1e3,
            cuda, noise_std=2.0, seed=11))
        assert capture.dtype == torch.complex64
    else:
        capture = base.float() if kind == "float32" else base
    inits = bench.make_inits(s, bench.B2A_SATS, n_ch)
    ran, counter = RAN[correlator]

    def run(cap):
        return driver.track(cap, s, inits, n_epochs=n_ep,
                            epochs_per_block=n_ep, device=cuda,
                            correlator=correlator)

    before = counters()
    trk = run(capture)
    torch.cuda.synchronize()
    assert trk.correlator == ran and trk.n_epochs == n_ep
    if counter is not None:
        assert counters()[counter] > before[counter]
    assert _lock_count(trk, last) == n_ch
    if kind == "float32":
        i8 = run(base)
        np.testing.assert_array_equal(trk.absolute_sample, i8.absolute_sample)
        for n, v in i8.outputs.items():
            np.testing.assert_array_equal(trk.outputs[n], v, err_msg=n)


# --- the receivers to fixes -------------------------------------------------

def _check_fixes(nav, min_fixes: int, max_median_m: float) -> None:
    assert nav is not None, "no navigation solution"
    ok = np.isfinite(nav.x)
    err = np.sqrt((nav.x[ok] - bench.RX_TRUTH[0]) ** 2
                  + (nav.y[ok] - bench.RX_TRUTH[1]) ** 2
                  + (nav.z[ok] - bench.RX_TRUTH[2]) ** 2)
    med = float(np.median(err)) if ok.any() else float("inf")
    assert ok.sum() >= min_fixes and med < max_median_m, \
        (int(ok.sum()), med, min_fixes, max_median_m)


def _check_ephemerides(nav, scenario) -> None:
    """At least 4 ephemerides decoded, each with its satellite's true
    m_0."""
    truth = {e.prn: e for e in scenario.ephemerides}
    ephs = nav.ephemerides
    wrong = [p for p, e in ephs.items() if abs(e.m_0 - truth[p].m_0) > 1e-9]
    assert len(ephs) >= 4 and not wrong, (len(ephs), wrong)


def _receiver(sig, s, epochs_per_block):
    """run_receiver on the card: 5 channels, tracked through K1, which
    was launched."""
    from bds3_tpu_torch.receiver import run_receiver

    before = counters()["k1.launches"]
    res = run_receiver(sig, s, epochs_per_block=epochs_per_block,
                       verbose=False, device="cuda")
    torch.cuda.synchronize()
    assert len(res.channels) == 5, [c.prn for c in res.channels]
    assert res.track.correlator == fused.KERNEL_NAME
    assert counters()["k1.launches"] > before
    return res


@functools.lru_cache(maxsize=None)
def _b2a_receiver():
    return _receiver(card.capture("e2e"), card.e2e_settings(), 250)


def _receiver_b2a(dev):
    """The B2a scenario of tests/test_e2e_pvt.py (20 Msps, 11.5 s, 5
    satellites): >= 3 fixes, median 3D error < 1 m; K1 against its plain
    version over one 250-epoch block at the receiver's shapes."""
    res = _b2a_receiver()
    _check_fixes(res.nav, 3, 1.0)
    capture = _on_card("e2e")
    setup = driver.setup_tracking(capture, card.e2e_settings(),
                                  res.channels, 250, 250)
    card.assert_block_agrees(setup, capture)


def _receiver_b2a_float32(dev):
    """The same capture cast to float32: K1's float32 instance reads the
    same values, so tracking is exactly the int8 run's."""
    res8 = _b2a_receiver()
    res32 = _receiver(np.asarray(card.capture("e2e"), np.float32),
                      card.e2e_settings(), 250)
    t8, t32 = res8.track, res32.track
    assert sorted(t32.outputs) == sorted(t8.outputs)
    np.testing.assert_array_equal(t32.absolute_sample, t8.absolute_sample)
    for n, v in t8.outputs.items():
        np.testing.assert_array_equal(t32.outputs[n], v, err_msg=n)


def _receiver_b2a_iq8(dev):
    """The same scenario rendered on the card as IQ8 and handed over as
    the int8 pairs tensor, which the receiver widens there: K1's complex
    instance, >= 3 fixes, median < 1 m."""
    from bds3_tpu_torch.io.render import render_scenario

    s = _iq8(card.e2e_settings())
    pairs = render_scenario(card.e2e_scenario(s), dev, noise_std=2.0,
                            amplitude=0.7, seed=1)
    _check_fixes(_receiver(pairs, s, 250).nav, 3, 1.0)


def _receiver_b1c_nb(dev):
    """The B1C narrowband scenario of tests/test_e2e_b1c.py (6 Msps, 26 s,
    5 satellites): >= 4 ephemerides with the true m_0, >= 10 fixes,
    median < 2 m.  Then one 20-epoch block at its shapes: K1 against its
    plain version, and bucket_pallas against the same path with K2's
    plain version (over a longer closed loop one float32 loop state
    rounds the other way sooner or later, whatever the two summation
    orders, and moves the carrier phase by ~1e-4 cycles)."""
    s = card.b1c_e2e_settings()
    res = _receiver(card.capture("b1c_e2e"), s, 250)
    _check_ephemerides(res.nav, card.b1c_scenario())
    _check_fixes(res.nav, 10, 2.0)
    capture = _on_card("b1c_e2e")
    setup = driver.setup_tracking(capture, s, res.channels, 20, 20)
    card.assert_block_agrees(setup, capture)
    card.assert_block_agrees(
        setup, capture, "bucket_pallas", functools.partial(
            track_block_bucket, prefix_fn=functools.partial(
                pallas_prefix, mix=prefix.mix_prefix_reference)))


def _receiver_b1c_wb(dev):
    """The bench's B1C wideband scenario (33.125 Msps, IF fs/4, 26 s, the
    "split" blend, the preset's resampled acquisition): >= 4 ephemerides
    with the true m_0, >= 10 fixes, median < 2 m; K1 against its plain
    version over one 20-epoch block at its shapes."""
    s, scenario, _ = bench.b1c_receiver(dev)
    capture = _on_card("b1c_wb_e2e")
    res = _receiver(capture, s, 500)
    _check_ephemerides(res.nav, scenario)
    _check_fixes(res.nav, 10, 2.0)
    setup = driver.setup_tracking(capture, s, res.channels, 20, 20)
    card.assert_block_agrees(setup, capture)


RECEIVERS = {"b2a_e2e": _receiver_b2a,
             "b2a_e2e_float32": _receiver_b2a_float32,
             "b2a_e2e_iq8": _receiver_b2a_iq8,
             "b1c_nb_e2e": _receiver_b1c_nb,
             "b1c_wb_e2e": _receiver_b1c_wb}


@pytest.mark.parametrize("case", list(RECEIVERS))
def test_receiver_to_fixes(cuda, case):
    """run_receiver on a synthesized scenario, from acquisition to fixes,
    with every channel tracked through K1 (RECEIVERS' functions give each
    case's thresholds)."""
    RECEIVERS[case](cuda)


# --- the drivers of the JAX paths --------------------------------------------

# driver: (module, argv, the line it must print); each at its default
# length, the streaming demo at 5 s (two 2000-epoch blocks; 49 s by default)
DRIVERS = {
    "b2a_pipeline_demo": ("bds3_tpu_torch.examples.b2a_pipeline_demo", [],
                          "DEMO PASS"),
    "b1c_pipeline_demo": ("bds3_tpu_torch.examples.b1c_pipeline_demo", [],
                          "DEMO PASS"),
    "debug_pvt": ("bds3_tpu_torch.tools.debug_pvt", [], "PVT DEBUG PASS"),
    "validate_b1c_chain": ("bds3_tpu_torch.tools.validate_b1c_chain", [],
                           "B1C CHAIN PASS"),
    "streaming_demo": ("bds3_tpu_torch.tools.streaming_demo", ["5"],
                       "STREAMING DEMO PASS"),
    "profile_trace": ("bds3_tpu_torch.tools.profile_trace", [],
                      "traced 198 epochs x 12 ch in "),
}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_passes_on_the_card(cuda, name, tmp_path, capsys):
    """Each driver through its main on the card prints its PASS line
    (profile_trace its "traced" line for the kernel path, with a trace
    file) and launches K1."""
    import importlib

    module, argv, want = DRIVERS[name]
    if name == "profile_trace":
        argv = [str(tmp_path)]
    before = counters()["k1.launches"]
    assert importlib.import_module(module).main(argv) in (0, None)
    torch.cuda.synchronize()
    assert counters()["k1.launches"] > before
    hit = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith(want)]
    assert hit, f"no line starting {want!r}"
    if name == "profile_trace":
        assert "correlator=track_fused_cuda" in hit[-1]
        assert (tmp_path / "trace.json").stat().st_size > 0


# --- K3 in the bench --------------------------------------------------------

def test_bench_mxu_micro_stage_launches_k3(cuda, monkeypatch):
    """The port's bench stage of K3 (bench.bench_mxu_micro, every shape at
    2000 iterations) runs on the card and launches K3 for each shape."""
    from bds3_tpu_torch.benchmarks import mxu_micro

    monkeypatch.setitem(bench.STATE, "device", cuda)
    monkeypatch.setitem(bench.DETAIL, "configs", {})
    before = counters()["k3.launches"]
    bench.bench_mxu_micro()
    torch.cuda.synchronize()
    shapes = bench.DETAIL["configs"]["mxu_micro"]["shapes"]
    assert len(shapes) == len(mxu_micro.bench_shapes())
    assert counters()["k3.launches"] - before >= len(shapes)
