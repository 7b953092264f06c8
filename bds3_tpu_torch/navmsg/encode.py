"""Navigation-message encoders — test/benchmark infrastructure.

The reference has no encoders (it only receives); these exist so the
synthesizer can emit B-CNAV1/B-CNAV2 streams carrying *known* ephemerides,
closing the loop for golden-value end-to-end tests (SURVEY.md section 4).
Encoders are exact inverses of the parsers in ephemeris.py; LDPC parity
symbols are filled with pseudorandom chips since the receiver (like the
reference) reads only the systematic symbols.
"""
from __future__ import annotations

import numpy as np

from bds3_tpu_torch.navmsg.bch import bch_encode
from bds3_tpu_torch.navmsg.bcnav2 import PREAMBLE
from bds3_tpu_torch.navmsg.crc import crc24q
from bds3_tpu_torch.navmsg.ephemeris import BDS_PI, Ephemeris


def _set_u(bits: np.ndarray, a: int, b: int, value: int) -> None:
    n = b - a + 1
    v = int(value) & ((1 << n) - 1)
    for i in range(n):
        bits[a - 1 + i] = (v >> (n - 1 - i)) & 1


def _set_s(bits: np.ndarray, a: int, b: int, value: int) -> None:
    _set_u(bits, a, b, value)


def _q(value: float, scale: float) -> int:
    return int(round(value / scale))


def _append_crc(payload: np.ndarray) -> np.ndarray:
    crc = crc24q(payload)
    crc_bits = np.array([(crc >> (23 - i)) & 1 for i in range(24)], np.uint8)
    return np.concatenate([payload, crc_bits])


# --------------------------------------------------------------------------
# B-CNAV2 (B2a)
# --------------------------------------------------------------------------

def build_bcnav2_message(eph: Ephemeris, mtype: int, sow_s: float) -> np.ndarray:
    """One 288-bit message (264 payload + CRC-24Q)."""
    b = np.zeros(264, dtype=np.uint8)
    _set_u(b, 1, 6, eph.prn)
    _set_u(b, 7, 12, mtype)
    _set_u(b, 13, 30, int(sow_s // 3))
    sat_code = {"GEO": 1, "IGSO": 2, "MEO": 3}.get(eph.sat_type, 3)
    if mtype == 10:
        _set_u(b, 31, 43, eph.wn)
        _set_u(b, 62, 72, _q(eph.t_oe, 300))
        _set_u(b, 73, 74, sat_code)
        _set_s(b, 75, 100, _q(eph.delta_a, 2.0**-9))
        _set_s(b, 101, 125, _q(eph.a_dot, 2.0**-21))
        _set_s(b, 126, 142, _q(eph.delta_n0 / BDS_PI, 2.0**-44))
        _set_s(b, 143, 165, _q(eph.delta_n0_dot / BDS_PI, 2.0**-57))
        _set_s(b, 166, 198, _q(eph.m_0 / BDS_PI, 2.0**-32))
        _set_u(b, 199, 231, _q(eph.e, 2.0**-34))
        _set_s(b, 232, 264, _q(eph.omega / BDS_PI, 2.0**-32))
    elif mtype == 11:
        _set_s(b, 43, 75, _q(eph.omega_0 / BDS_PI, 2.0**-32))
        _set_s(b, 76, 108, _q(eph.i_0 / BDS_PI, 2.0**-32))
        _set_s(b, 109, 127, _q(eph.omega_dot / BDS_PI, 2.0**-44))
        _set_s(b, 128, 142, _q(eph.i_0_dot / BDS_PI, 2.0**-44))
        _set_s(b, 143, 158, _q(eph.c_is, 2.0**-30))
        _set_s(b, 159, 174, _q(eph.c_ic, 2.0**-30))
        _set_s(b, 175, 198, _q(eph.c_rs, 2.0**-8))
        _set_s(b, 199, 222, _q(eph.c_rc, 2.0**-8))
        _set_s(b, 223, 243, _q(eph.c_us, 2.0**-30))
        _set_s(b, 244, 264, _q(eph.c_uc, 2.0**-30))
    elif mtype in (30, 31, 32):
        _set_u(b, 43, 53, _q(eph.t_oc, 300))
        _set_s(b, 54, 78, _q(eph.a_0, 2.0**-34))
        _set_s(b, 79, 100, _q(eph.a_1, 2.0**-50))
        _set_s(b, 101, 111, _q(eph.a_2, 2.0**-66))
        _set_u(b, 112, 113, (eph.iodc >> 8) & 3)
        _set_u(b, 114, 121, eph.iodc & 0xFF)
        if mtype == 30:
            _set_s(b, 122, 133, _q(eph.t_gd_b2ap, 2.0**-34))
            _set_s(b, 134, 145, _q(eph.isc_b2ad, 2.0**-34))
    elif mtype == 33:
        # Clock + BGTO; IODC follows the BGTO block (see ephemeris.py's
        # MT33 deviation note)
        _set_u(b, 43, 53, _q(eph.t_oc, 300))
        _set_s(b, 54, 78, _q(eph.a_0, 2.0**-34))
        _set_s(b, 79, 100, _q(eph.a_1, 2.0**-50))
        _set_s(b, 101, 111, _q(eph.a_2, 2.0**-66))
        _set_u(b, 112, 114, eph.gnss_id)
        _set_u(b, 115, 127, eph.wn_0_bgto)
        _set_u(b, 128, 143, _q(eph.t_0_bgto, 16.0))
        _set_s(b, 144, 159, _q(eph.a_0_bgto, 2.0**-35))
        _set_s(b, 160, 172, _q(eph.a_1_bgto, 2.0**-51))
        _set_s(b, 173, 179, _q(eph.a_2_bgto, 2.0**-68))
        _set_u(b, 180, 181, (eph.iodc >> 8) & 3)
        _set_u(b, 182, 189, eph.iodc & 0xFF)
    elif mtype == 34:
        # SISAI + Clock
        _set_u(b, 43, 53, _q(eph.t_op, 300))
        _set_u(b, 54, 58, eph.sisai_ocb)
        _set_u(b, 59, 61, eph.sisai_oc1)
        _set_u(b, 62, 64, eph.sisai_oc2)
        _set_u(b, 65, 75, _q(eph.t_oc, 300))
        _set_s(b, 76, 100, _q(eph.a_0, 2.0**-34))
        _set_s(b, 101, 122, _q(eph.a_1, 2.0**-50))
        _set_s(b, 123, 133, _q(eph.a_2, 2.0**-66))
        _set_u(b, 134, 135, (eph.iodc >> 8) & 3)
        _set_u(b, 136, 143, eph.iodc & 0xFF)
    else:
        raise ValueError(f"unsupported message type {mtype}")
    return _append_crc(b)


def bcnav2_symbols(messages: list[np.ndarray], seed: int = 1) -> np.ndarray:
    """Messages -> concatenated +-1 symbol stream (600 symbols each:
    24-symbol preamble + 576 LDPC codeword symbols, systematic first
    288).  The parity half is REAL 64-ary LDPC(96,48) parity
    (navmsg/ldpc.py) — the systematic-read receiver ignores it exactly
    as the reference does (BCNAV2decoding.m:129-132), and the
    ldpc_decode extension exploits it.  `seed` is kept for call
    compatibility (the old placeholder filled this half with seeded
    noise)."""
    del seed
    from bds3_tpu_torch.navmsg.ldpc import encode as ldpc_encode

    out = []
    for msg in messages:
        cw = ldpc_encode(np.asarray(msg, dtype=np.uint8))
        sym = np.empty(600, dtype=np.int8)
        sym[:24] = PREAMBLE.astype(np.int8)
        sym[24:] = 1 - 2 * cw.astype(np.int8)
        out.append(sym)
    return np.concatenate(out)


def bcnav2_nav_bits(eph: Ephemeris, first_sow: float, n_frames: int) -> np.ndarray:
    """Cycled MT10/11/30 symbol stream for the synthesizer's nav_bits
    (one symbol per 5 ms data-secondary period)."""
    mtypes = [10, 11, 30]
    msgs = []
    for k in range(n_frames):
        msgs.append(build_bcnav2_message(eph, mtypes[k % 3], first_sow + 3 * k))
    return bcnav2_symbols(msgs)


# --------------------------------------------------------------------------
# B-CNAV1 (B1C)
# --------------------------------------------------------------------------

def build_bcnav1_payloads(eph: Ephemeris, soh_s: float) -> tuple[np.ndarray, np.ndarray]:
    """(600-bit SF2 with CRC, 264-bit SF3 with CRC) for one frame."""
    # Subframe 2: bits of the assembled frame positions 15..614 map to
    # payload positions 1..600 (ephemeris.py parse offsets minus 14).
    f = np.zeros(878, dtype=np.uint8)  # assemble in frame coordinates
    _set_u(f, 15, 27, eph.wn)
    _set_u(f, 28, 35, eph.how)
    _set_u(f, 36, 46, eph.iodc)
    _set_u(f, 46, 53, eph.iode)  # reference's overlapping read, see parser
    o = 53
    _set_u(f, o + 1, o + 11, _q(eph.t_oe, 300))
    _set_u(f, o + 12, o + 13, {"GEO": 1, "IGSO": 2, "MEO": 3}.get(eph.sat_type, 3))
    _set_s(f, o + 14, o + 39, _q(eph.delta_a, 2.0**-9))
    _set_s(f, o + 40, o + 64, _q(eph.a_dot, 2.0**-21))
    _set_s(f, o + 65, o + 81, _q(eph.delta_n0 / BDS_PI, 2.0**-44))
    _set_s(f, o + 82, o + 104, _q(eph.delta_n0_dot / BDS_PI, 2.0**-57))
    _set_s(f, o + 105, o + 137, _q(eph.m_0 / BDS_PI, 2.0**-32))
    _set_u(f, o + 138, o + 170, _q(eph.e, 2.0**-34))
    _set_s(f, o + 171, o + 203, _q(eph.omega / BDS_PI, 2.0**-32))
    o = 256
    _set_s(f, o + 1, o + 33, _q(eph.omega_0 / BDS_PI, 2.0**-32))
    _set_s(f, o + 34, o + 66, _q(eph.i_0 / BDS_PI, 2.0**-32))
    _set_s(f, o + 67, o + 85, _q(eph.omega_dot / BDS_PI, 2.0**-44))
    _set_s(f, o + 86, o + 100, _q(eph.i_0_dot / BDS_PI, 2.0**-44))
    _set_s(f, o + 101, o + 116, _q(eph.c_is, 2.0**-30))
    _set_s(f, o + 117, o + 132, _q(eph.c_ic, 2.0**-30))
    _set_s(f, o + 133, o + 156, _q(eph.c_rs, 2.0**-8))
    _set_s(f, o + 157, o + 180, _q(eph.c_rc, 2.0**-8))
    _set_s(f, o + 181, o + 201, _q(eph.c_us, 2.0**-30))
    _set_s(f, o + 202, o + 222, _q(eph.c_uc, 2.0**-30))
    o = 478
    _set_u(f, o + 1, o + 11, _q(eph.t_oc, 300))
    _set_s(f, o + 12, o + 36, _q(eph.a_0, 2.0**-34))
    _set_s(f, o + 37, o + 58, _q(eph.a_1, 2.0**-50))
    _set_s(f, o + 59, o + 69, _q(eph.a_2, 2.0**-66))
    o = 547
    _set_s(f, o + 1, o + 12, _q(eph.t_gd_b2ap, 2.0**-34))
    _set_s(f, o + 13, o + 24, _q(eph.isc_b1cd, 2.0**-34))
    _set_s(f, o + 25, o + 36, _q(eph.t_gd_b1cp, 2.0**-34))
    sf2 = _append_crc(f[14:590])  # 576 payload bits + CRC = 600

    # Subframe 3, page 1 (iono + UTC zeroed is fine for tests)
    p3 = np.zeros(240, dtype=np.uint8)
    _set_u(p3, 1, 6, 1)  # PageID 1
    sf3 = _append_crc(p3)  # 264
    return sf2, sf3


def bcnav1_frame_symbols(eph: Ephemeris, soh_s: float) -> np.ndarray:
    """One 1800-symbol B-CNAV1 data-channel frame (+-1).

    [BCH21(prn6) | BCH51(soh8) | interleaved SF2(1200)+SF3(528)], with
    real LDPC(200,100)/(88,44) parity in the non-systematic halves — the
    skip-LDPC receiver reads only the systematic bits
    (BCNAV1decoding.m:144-163); the ldpc_decode extension uses the rest.
    """
    from bds3_tpu_torch.navmsg.ldpc import code_h, encode as ldpc_encode

    sf2, sf3 = build_bcnav1_payloads(eph, soh_s)
    frame2 = ldpc_encode(sf2, code_h("bcnav1_sf2"))     # (1200,)
    frame3 = ldpc_encode(sf3, code_h("bcnav1_sf3"))     # (528,)

    inter = np.empty((36, 48), dtype=np.uint8)
    sf3_rows = np.arange(2, 35, 3)
    sf2_rows = np.setdiff1d(np.arange(36), sf3_rows)
    inter[sf2_rows] = frame2.reshape(25, 48)
    inter[sf3_rows] = frame3.reshape(11, 48)
    body = inter.T.reshape(-1)  # inverse of bits[72:].reshape(48,36).T

    prn_bits = np.array([(eph.prn >> (5 - i)) & 1 for i in range(6)], np.uint8)
    soh_bits = np.array([(int(soh_s // 18) >> (7 - i)) & 1 for i in range(8)],
                        np.uint8)
    # Receiver conventions (BCNAV1decoding.m:104-171): subframe-1 BCH
    # check bits are 1-2*(symbol>0) = -symbol, so transmit s = -codeword;
    # subframes 2/3 logical bit = (symbol>0), so transmit s = 2*bit-1.
    sym = np.empty(1800, dtype=np.int8)
    sym[:21] = -bch_encode(prn_bits, 21)
    sym[21:72] = -bch_encode(soh_bits, 51)
    sym[72:] = 2 * body.astype(np.int8) - 1
    return sym
