"""The port's host copies (track state, loop coefficients, acquisition
tables) equal the JAX package's originals exactly, and convert.py carries
them over to tensors without changing a value or a dtype."""
import dataclasses
import enum

import numpy as np
import pytest
import torch

from bds3_tpu.acquire import pcps as ref_acq
from bds3_tpu.config import TrackMode, b1c_settings, b2a_settings
from bds3_tpu.track import driver as ref_driver
from bds3_tpu.track import loops as ref_loops
from bds3_tpu.track import state as ref_state
from bds3_tpu.track import weighting as ref_weighting
from bds3_tpu_torch import convert
from bds3_tpu_torch.acquire import pcps as port_acq
from bds3_tpu_torch.track import driver as port_driver
from bds3_tpu_torch.track import loops as port_loops
from bds3_tpu_torch.track import scan as port_scan
from bds3_tpu_torch.track import state as port_state

torch.set_num_threads(2)

# each package gets its own Settings: the port's enums are its own
P = convert.settings_from_reference


def _by_name(d: dict) -> dict:
    """A dataclass's fields with each enum as its name: the two packages'
    enums are of different classes."""
    return {k: v.name if isinstance(v, enum.Enum) else v
            for k, v in d.items()}

SETTINGS = {
    "b2a_full": b2a_settings(),
    "b2a_10msps": b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6),
    "b2a_data_only": b2a_settings(sampling_freq=20e6, intermediate_freq=5e6,
                                  track_mode=TrackMode.DATA_ONLY),
    "b1c_wb": b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6),
    "b1c_nb": b1c_settings(track_mode=TrackMode.NARROWBAND),
}


def _inits(mod, n=3):
    return [mod.ChannelInit(prn=p, acquired_freq=f, code_phase=c,
                            peak_metric=m)
            for p, f, c, m in [(19, 2.5e6 + 777.0, 1234, 3.0),
                               (5, 2.5e6 - 1200.0, 77, 9.5),
                               (30, 2.5e6 + 3100.0, 9001, 1.7)][:n]]


def _assert_tuple_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(SETTINGS))
@pytest.mark.parametrize("epb", [30, 200])
def test_make_track_config(name, epb):
    s = SETTINGS[name]
    want = ref_state.make_track_config(s, False, epb)
    got = port_state.make_track_config(P(s), False, epb)
    assert _by_name(dataclasses.asdict(got)) == \
        _by_name(dataclasses.asdict(want))
    assert convert.config_from_reference(want) == got


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_channel_consts_and_tables(name):
    s = SETTINGS[name]
    cfg_r = ref_state.make_track_config(s, False, 50)
    cfg_p = port_state.make_track_config(P(s), False, 50)
    _assert_tuple_equal(
        port_state.channel_consts(cfg_p, _inits(port_state), P(s)),
        ref_state.channel_consts(cfg_r, _inits(ref_state), s))
    for m in (cfg_r.m_data, 12):
        _assert_tuple_equal(port_state.code_coarse_tables(cfg_p, m),
                            ref_state.code_coarse_tables(cfg_r, m))
    _assert_tuple_equal(
        port_driver.channel_code_tables(cfg_p, _inits(port_state)),
        ref_driver.channel_code_tables(cfg_r, _inits(ref_state)))


def test_initial_state_and_conversion():
    s = SETTINGS["b2a_10msps"]
    cfg = ref_state.make_track_config(s, False, 50)
    consts = ref_state.channel_consts(cfg, _inits(ref_state), s)
    cursors = np.array([10, 0, 1234])
    want = ref_state.initial_state(cfg, _inits(ref_state), consts, cursors)
    got = port_state.initial_state(cfg, _inits(port_state), consts, cursors)
    _assert_tuple_equal(got, want)

    st = convert.state_to_torch(want, 500, "cpu")
    assert st.cursor.dtype == torch.int64 and st.statef.dtype == torch.float32
    np.testing.assert_array_equal(st.cursor.numpy(), cursors + 500)
    np.testing.assert_array_equal(st.statef[:, 3].numpy(), want.d_step)
    _assert_tuple_equal(convert.state_from_torch(st, 500), want)

    ct = convert.consts_to_torch(consts, "cpu")
    for name, t in ct._asdict().items():
        assert t.dtype in (torch.float32, torch.int32), name
        np.testing.assert_array_equal(t.numpy(), getattr(consts, name))


@pytest.mark.parametrize("use_pilot", [True, False])
def test_tables_to_torch_layout(use_pilot):
    mode = TrackMode.NARROWBAND if use_pilot else TrackMode.DATA_ONLY
    s = P(b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                       track_mode=mode))
    cfg = port_state.make_track_config(s, False, 50)
    data, p11, _ = port_driver.channel_code_tables(cfg, _inits(port_state))
    ck_i, ck_f = port_state.code_coarse_tables(cfg, 1)
    t = convert.tables_to_torch(cfg, data, p11, ck_i, ck_f, "cpu")
    taps = 2 if use_pilot else 1
    assert t.code.shape == (3, taps, 10230 + 2 * port_scan.CODE_PAD)
    assert t.code.dtype == torch.int8
    np.testing.assert_array_equal(t.code[:, 0].numpy(), data)
    if use_pilot:
        np.testing.assert_array_equal(t.code[:, 1].numpy(), p11)
    assert t.ck_int.dtype == torch.int32 and t.ck_frac.dtype == torch.float32


def test_tables_to_torch_wideband():
    """B1C wideband: the JAX package's own tables (channel_code_tables,
    code_coarse_tables at m_p61 = 12) carry over to TrackTables with the
    BOC(6,1) pilot and its coarse tables, equal to the port's."""
    s = SETTINGS["b1c_wb"]
    cfg_r = ref_state.make_track_config(s, False, 50)
    cfg = convert.config_from_reference(cfg_r)
    assert cfg.wideband and cfg.m_p61 == 12
    data, p11, p61 = ref_driver.channel_code_tables(cfg_r, _inits(ref_state))
    ck_i, ck_f = ref_state.code_coarse_tables(cfg_r, cfg_r.m_data)
    ck61 = ref_state.code_coarse_tables(cfg_r, cfg_r.m_p61)
    t = convert.tables_to_torch(cfg, data, p11, ck_i, ck_f, "cpu", p61, *ck61)
    assert t.code.shape == (3, 2, 10230 * 2 + 2 * port_scan.CODE_PAD)
    assert t.code61.shape == (3, 10230 * 12 + 2 * port_scan.CODE_PAD)
    assert t.code61.dtype == torch.int8 and t.ck61_int.dtype == torch.int32
    np.testing.assert_array_equal(t.code61.numpy(), p61)
    np.testing.assert_array_equal(t.ck61_int.numpy(), ck61[0])
    np.testing.assert_array_equal(t.ck61_frac.numpy(), ck61[1])
    # the port's driver builds the same tables
    cap = torch.zeros(20_000_000, dtype=torch.int8)   # 50 epochs at 30 Msps
    setup = port_driver.setup_tracking(cap, P(s), _inits(port_state), 50, 50)
    for name in ("code", "ck_int", "ck_frac", "code61", "ck61_int",
                 "ck61_frac"):
        assert torch.equal(getattr(setup.tables, name), getattr(t, name))


def test_assign_channels():
    acq = ref_acq.AcqResults(
        prns=np.array([3, 7, 19, 25, 30]),
        carr_freq=np.array([1.0, 2.0, 3.0, 4.0, 5.0]),
        code_phase=np.array([10, 20, 30, 40, 50]),
        peak_metric=np.array([2.0, 9.0, 1.0, 5.0, 3.5]),
        detected=np.array([True, True, False, True, True]),
        coarse_freq=np.zeros(5))
    s = b2a_settings(num_channels=3)
    want = ref_state.assign_channels(acq, s)
    got = port_state.assign_channels(convert.acq_from_reference(acq), s)
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]


@pytest.mark.parametrize("bn,zeta,t", [(2.0, 0.7, 0.001), (1.0, 0.7, 0.01),
                                       (20.0, 0.7, 0.001)])
def test_loop_coefficients(bn, zeta, t):
    assert port_loops.dll_coefficients(bn, zeta) == \
        ref_loops.dll_coefficients(bn, zeta)
    assert port_loops.pll_coefficients(bn, t) == \
        ref_loops.pll_coefficients(bn, t)


def test_wb_dll_weight():
    from bds3_tpu_torch.track import weighting as port_weighting

    assert port_weighting.wb_dll_weight(1.023e6, 27e6) == \
        ref_weighting.wb_dll_weight(1.023e6, 27e6)


@pytest.mark.parametrize("name", ["b2a_full", "b2a_10msps", "b1c_wb"])
def test_make_acq_config(name):
    s = SETTINGS[name]
    assert _by_name(dataclasses.asdict(port_acq.make_acq_config(P(s)))) == \
        _by_name(dataclasses.asdict(ref_acq.make_acq_config(s)))


@pytest.mark.parametrize("name", ["b2a_10msps", "b1c_wb"])
def test_acquisition_code_tables(name):
    s = dataclasses.replace(SETTINGS[name], acq_noncoh_rounds=3)
    prns = np.array([1, 19, 44])
    for fn in ("acq_code_tables", "full_code_tables", "fine_code_tables"):
        want = getattr(ref_acq, fn)(s, prns)
        got = getattr(port_acq, fn)(P(s), prns)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype == np.int8, fn
            np.testing.assert_array_equal(x, y, err_msg=fn)


def test_glrt_noise_power():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(5000) + 1j * rng.standard_normal(5000)
    for v in (x, x.real, x.astype(np.complex64)):
        assert port_acq.glrt_noise_power(v) == ref_acq.glrt_noise_power(v)
