"""Ground truth of the B2a demo: the ephemeris it encodes into its
satellites' B-CNAV2 messages and expects to decode.

A copy of `sample_eph` from tests/test_navmsg.py:60, which the original
demo imports from the test suite; the port keeps its own, held equal to
the test's field by field (tests/test_torch_drivers.py)."""
from __future__ import annotations

from bds3_tpu_torch.navmsg.ephemeris import Ephemeris


def sample_eph(prn=19) -> Ephemeris:
    e = Ephemeris()
    e.prn = prn
    e.wn = 800
    e.sat_type = "MEO"
    e.t_oe = 345600.0
    e.delta_a = 123.5
    e.a_dot = 0.01
    e.delta_n0 = 4.5e-9
    e.delta_n0_dot = 1.0e-13
    e.m_0 = 1.2345
    e.e = 0.003
    e.omega = -2.1
    e.omega_0 = 0.5
    e.i_0 = 0.96
    e.omega_dot = -8.0e-9
    e.i_0_dot = 2.0e-10
    e.c_is = 1.5e-8
    e.c_ic = -2.0e-8
    e.c_rs = 100.25
    e.c_rc = 200.5
    e.c_us = 8.0e-6
    e.c_uc = -4.0e-6
    e.t_oc = 345600.0
    e.a_0 = 1.0e-4
    e.a_1 = 2.0e-12
    e.a_2 = 0.0
    e.iodc = 321
    e.t_gd_b1cp = 3.0e-9
    return e
