"""The frozen copies against the program's originals, on the CPU: the code
generators, the renderer, the channel starts and the tracking reference,
which must give the program's plain direct-sum path bit for bit."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench import program
from portbench.gen import render as grender
from portbench.gen import signals as gsig
from portbench.gen.sky import channel_starts, draw_sky
from portbench.kinds.track_resident import front_of
from portbench.reference import judge
from portbench.reference import track as ref
from portbench.tests.tiny import tiny_cell


def test_code_generators_equal_the_programs():
    from bds3_tpu_torch import signals as psig

    for prn in (1, 19, 33, 63):
        for name in ("b2a_data_code", "b2a_pilot_code", "b1c_data_boc11",
                     "b1c_pilot_boc11", "b1c_pilot_boc61",
                     "b1c_secondary_code"):
            np.testing.assert_array_equal(getattr(gsig, name)(prn),
                                          getattr(psig, name)(prn))
    np.testing.assert_array_equal(gsig.b2a_data_secondary(),
                                  psig.b2a_data_secondary())


@pytest.mark.parametrize("cell", ["b2a.track.resident", "b1c.track.resident"])
def test_render_equals_the_programs_renderer(cell):
    """Without noise, the frozen renderer gives the program's render_if
    sample for sample (whose own test holds it to the host synthesizer);
    the amplitudes are raised so that the int8 samples are not all 0."""
    from bds3_tpu_torch.io import SatParams
    from bds3_tpu_torch.io.render import render_if

    c = tiny_cell(cell)
    front = front_of(c.config["settings"])
    sats = [dataclasses.replace(s, amplitude=40 * s.amplitude)
            for s in draw_sky(front, np.random.default_rng(5), 3, 4000.0,
                              (45.0, 50.0), 2.0)]
    n = int(round(3.0 * 1e-3 * front.fs))
    got = grender.render(front, sats, n, "cpu", 0.0, 1, chunk=1 << 14)
    want = render_if(program.settings(c.config),
                     [SatParams(prn=s.prn, doppler_hz=s.doppler_hz,
                                code_phase_chips=s.code_phase_chips,
                                carrier_phase=s.carrier_phase,
                                amplitude=s.amplitude,
                                nav_bits=np.array(s.nav_bits))
                      for s in sats], 3.0, "cpu")[:n]
    assert got.dtype == torch.int8 and got.abs().max() > 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_channel_starts_equal_the_bench():
    from bds3_tpu_torch.bench import make_inits

    c = tiny_cell("b2a.track.resident")
    s = program.settings(c.config)
    front = front_of(c.config["settings"])
    sats = draw_sky(front, np.random.default_rng(9), 4, 4500.0,
                    (42.0, 52.0), 2.0)
    got = channel_starts(front, sats)
    want = make_inits(s, [(x.prn, x.doppler_hz, x.code_phase_chips)
                          for x in sats], 4)
    assert [(g["prn"], g["acquired_freq"], g["code_phase"]) for g in got] \
        == [(w.prn, w.acquired_freq, w.code_phase) for w in want]


def test_sky_draws_the_same_work_for_every_seed():
    front = front_of(tiny_cell("b2a.track.resident").config["settings"])
    for seed in (0, 2 ** 31 + 7, 2 ** 62):
        sats = draw_sky(front, np.random.default_rng(seed), 12, 5000.0,
                        (42.0, 52.0), 2.0)
        assert len({s.prn for s in sats}) == 12
        assert all(abs(s.doppler_hz) < 5000.0 for s in sats)


MODES = [
    ("b2a.track.resident", {}),
    ("b2a.track.resident", {"track_mode": "DATA_ONLY"}),
    ("b1c.track.resident", {"track_mode": "NARROWBAND"}),
    ("b1c.track.resident", {"wb_code_blend": "composite"}),
    ("b1c.track.resident", {"wb_code_blend": "nb"}),
    ("b1c.track.resident", {"wb_code_blend": "split"}),
    ("b1c.track.resident", {"wb_code_blend": "dotprod"}),
]


@pytest.mark.parametrize("cell,over", MODES)
def test_reference_equals_the_programs_plain_path(cell, over):
    """ref.run from the channels' starts gives every output of the
    program's track_block_reference bit for bit, and the constants agree."""
    from bds3_tpu_torch.track.driver import setup_tracking
    from bds3_tpu_torch.track.scan import loop_constants, track_block_reference
    from bds3_tpu_torch.track.state import ChannelInit

    c = tiny_cell(cell, **over)
    st = c.config["settings"]
    s = program.settings(c.config)
    front = front_of(st)
    sats = draw_sky(front, np.random.default_rng(3), 2, 3000.0,
                    (45.0, 50.0), 2.0)
    w = 6
    capture = grender.render(front, sats, int((w + 3) * st["int_time"]
                                              * st["sampling_freq"]),
                             "cpu", 2.0, 3)
    starts = channel_starts(front, sats)
    inits = [ChannelInit(prn=x["prn"], acquired_freq=x["acquired_freq"],
                         code_phase=x["code_phase"], peak_metric=2.0)
             for x in starts]
    setup = setup_tracking(capture, s, inits, w, w)
    _, rows = track_block_reference(setup.cfg, capture, setup.tables,
                                    setup.consts, setup.state)
    lp = ref.make_loop(st)
    k = ref.constants(lp)
    prog_k = loop_constants(setup.cfg)
    assert {n: v for n, v in prog_k.items() if n in k} == \
        {n: v for n, v in k.items() if n in prog_k}
    ch = ref.make_channels(lp, starts, "cpu")
    cur, state = ref.initial_state(ch)
    got, _, _ = ref.run(lp, ch, capture, cur, state, w)
    names = lp.output_names()
    for i, n in enumerate(names):
        assert judge.ulps(got[n], rows[:, :, i].T.numpy()) == 0.0, n


def test_ulps():
    a = np.array([1.0, -2.0, 0.0, np.nan], np.float32)
    assert judge.ulps(a, a.copy()) == 0.0
    assert judge.ulps(np.float32([0.0]), np.float32([-0.0])) == 0.0
    b = a.copy()
    b[0] = np.nextafter(np.float32(1.0), np.float32(2.0))
    assert judge.ulps(a, b) == 1.0
    c = a.copy()
    c[3] = 1.0
    assert judge.ulps(a, c) == 2.0 ** 31
    tiny = np.float32([1e-45])
    assert judge.ulps(tiny, -tiny) == 2.0
