"""The port's copy of observe/plots.py renders from the port's own
results.

Ports tests/test_observe.py:41-67 (acquisition and tracking figures from
stand-in objects) and :145-155 (the probe figure), then renders every
plot function from a small run_receiver of the port on the CPU (B2a,
10 Msps, 0.6 s, the test_torch_receiver.py scenario): acquisition,
tracking for each channel, the probe panels of its capture, and both
channel tables.  The receiver's own channel table (`_channel_table`,
kept there so that no module on the card's path imports matplotlib)
must equal the copied `channel_init_table` string for string.

A run this short decodes no B-CNAV2 ephemeris (that takes ~9 s of
signal, minutes on a CPU), so its `nav` is None; the navigation and
sky plots render a NavSolutions that the port's least-squares solver
computes from the scenario's true ranges.
"""
import numpy as np
import pytest
import torch

from bds3_tpu_torch import receiver
from bds3_tpu_torch.config import FileType, b2a_settings
from bds3_tpu_torch.io.ifdata import IFDataFile, probe_stats
from bds3_tpu_torch.io.scenario import make_scenario, synthesize_scenario
from bds3_tpu_torch.observe import plots
from bds3_tpu_torch.pvt.geodesy import cart2geo, cart2utm, find_utm_zone
from bds3_tpu_torch.pvt.lsq import least_square_pos
from bds3_tpu_torch.pvt.satpos import satpos
from bds3_tpu_torch.pvt.solver import NavSolutions
from bds3_tpu_torch.track.state import ChannelInit

torch.set_num_threads(2)

RX = np.array([-1288398.0, -4721697.0, 4078625.0])


@pytest.fixture(scope="module")
def rx():
    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                     ms_to_process=600, use_tropo_corr=False,
                     acq_satellite_list=tuple(range(1, 6)), num_channels=5)
    sc = make_scenario(s, RX, n_sats=4, seed=3)
    sig = synthesize_scenario(sc, n_ms=600, noise_std=2.0, amplitude=0.7,
                              seed=1)
    res = receiver.run_receiver(sig, s, epochs_per_block=250, verbose=False,
                                device="cpu")
    assert res.track is not None and len(res.channels) == 4
    return s, sc, sig, res


def _saved(fig, path):
    fig.savefig(path)
    plots.plt.close(fig)
    return path.stat().st_size


def test_figures_build(tmp_path):
    """tests/test_observe.py:41-67 on the copy, with the port's settings."""
    class FakeAcq:
        prns = np.arange(1, 11)
        peak_metric = np.linspace(1, 10, 10)
        detected = peak_metric > 5

    fig = plots.plot_acquisition(FakeAcq(), 5.0)
    fig.savefig(tmp_path / "acq.png")

    class FakeTrack:
        prns = np.array([19])
        acquired_freq = np.array([7.5e6])
        int_time = 1e-3
        E = 500
        settings = b2a_settings()
        outputs = {
            k: np.abs(np.random.default_rng(0).normal(1000, 100, (1, 500)))
            for k in ("d_ie", "d_qe", "d_ip", "d_qp", "d_il", "d_ql",
                      "p11_ip", "p11_qp", "code_err", "carr_err")
        }
        carr_freq = np.full((1, 500), 7.5e6 + 100.0)

    fig = plots.plot_tracking(FakeTrack(), 0)
    fig.savefig(tmp_path / "trk.png")
    assert (tmp_path / "trk.png").stat().st_size > 0


def test_plot_probe_renders(tmp_path):
    """tests/test_observe.py:145-155 on the copy."""
    rng = np.random.default_rng(1)
    p = tmp_path / "n.bin"
    rng.integers(-20, 20, 200_000).astype(np.int8).tofile(p)
    st = probe_stats(IFDataFile.open(str(p), FileType.REAL8))
    fig = plots.plot_probe(st, 4e6)
    assert len(fig.axes) == 4


def test_receiver_results_render(rx, tmp_path):
    """Acquisition, tracking of every channel, and the probe of the
    capture, from the port's receiver; the status table holds a row per
    channel with its health."""
    s, _, sig, res = rx
    assert _saved(plots.plot_acquisition(res.acq, s.acq_threshold),
                  tmp_path / "acq.png") > 0
    for ch in range(len(res.track.prns)):
        fig = plots.plot_tracking(res.track, ch)
        assert len(fig.axes) == 8
        assert _saved(fig, tmp_path / f"trk{ch}.png") > 0
    path = tmp_path / "capture.bin"
    sig.tofile(path)
    st = probe_stats(IFDataFile.open(str(path), FileType.REAL8))
    assert _saved(plots.plot_probe(st, s.sampling_freq),
                  tmp_path / "probe.png") > 0
    table = plots.channel_status_table(res.track, res.acq, res.health)
    rows = table.splitlines()[2:]
    assert len(rows) == len(res.track.prns)
    for row, h in zip(rows, res.health):
        assert f"{h['cn0_db']:12.1f} | {h['pll_lock']:+.2f}" in row


def test_receiver_channel_table_equals_the_copy(rx):
    """run_receiver's own table is the copy's channel_init_table, string
    for string, on its channels and on values at the edges of the
    format."""
    res = rx[3]
    assert receiver._channel_table(res.channels) == \
        plots.channel_init_table(res.channels)
    edge = [ChannelInit(prn=63, acquired_freq=-1.25e9, code_phase=0,
                        peak_metric=-0.005),
            ChannelInit(prn=1, acquired_freq=123456789.96, code_phase=7,
                        peak_metric=1234.5)]
    for channels in (edge, []):
        assert receiver._channel_table(channels) == \
            plots.channel_init_table(channels)


def _nav_from_truth(sc, n_meas=6):
    """A NavSolutions of n_meas fixes, 0.5 s apart, from the scenario's
    true geometric ranges through the port's satellite positions,
    least-squares solver and UTM conversion."""
    ephs = sc.ephemerides
    c = len(ephs)
    nan = np.full(n_meas, np.nan)
    nav = NavSolutions(
        meas_sample=np.zeros(n_meas, np.int64), x=nan.copy(), y=nan.copy(),
        z=nan.copy(), dt=nan.copy(), latitude=nan.copy(),
        longitude=nan.copy(), height=nan.copy(), east=nan.copy(),
        north=nan.copy(), up=nan.copy(), dop=np.zeros((5, n_meas)),
        el=np.full((c, n_meas), np.nan), az=np.full((c, n_meas), np.nan),
        raw_p=np.full((c, n_meas), np.nan), local_time=nan.copy(),
        prns=np.array([e.prn for e in ephs]),
        ephemerides={e.prn: e for e in ephs})
    for m in range(n_meas):
        t_rx = sc.sow_base + 0.5 * m
        pos, _ = satpos(np.full(c, t_rx - 0.075), ephs, False)
        obs = np.linalg.norm(pos - RX[:, None], axis=0)
        xyzdt, el, az, dop = least_square_pos(pos, obs, use_tropo=False)
        nav.x[m], nav.y[m], nav.z[m], nav.dt[m] = xyzdt
        nav.raw_p[:, m], nav.el[:, m], nav.az[:, m] = obs, el, az
        nav.dop[:, m] = dop
        lat, lon, h = cart2geo(*xyzdt[:3], 5)
        nav.latitude[m], nav.longitude[m], nav.height[m] = lat, lon, h
        nav.east[m], nav.north[m], nav.up[m] = cart2utm(
            *xyzdt[:3], find_utm_zone(lat, lon))
        nav.local_time[m] = t_rx
    return nav


def test_navigation_plots_render(rx, tmp_path):
    """plot_navigation and sky_plot from the port's solver on the
    scenario's true ranges (the short receiver run has no fix): the fixes
    land within 100 m of the receiver (the ranges ignore the Earth's
    rotation in flight, which the solver corrects), every satellite has
    an elevation, and both figures render."""
    sc = rx[1]
    nav = _nav_from_truth(sc)
    err = np.sqrt((nav.x - RX[0])**2 + (nav.y - RX[1])**2
                  + (nav.z - RX[2])**2)
    assert np.all(err < 100.0), err
    assert np.isfinite(nav.el).all()
    fig = plots.plot_navigation(nav)
    assert len(fig.axes) == 3
    assert _saved(fig, tmp_path / "nav.png") > 0
    fig = plots.sky_plot(nav)
    assert len(fig.axes[0].lines) == len(nav.prns)
    assert _saved(fig, tmp_path / "sky.png") > 0
