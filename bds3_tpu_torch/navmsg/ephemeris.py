"""BDS-3 broadcast ephemeris container and B-CNAV1/B-CNAV2 bit-field
parsers.

Layouts follow BDS-SIS-ICD-B1C-1.0 / ICD-B2a-1.0 as carried by the
reference decoders (`BDS-3_B1C/include/ephemeris.m:66-237`,
`BDS-3_B2a/include/ephemeris.m:57-310`).  Known reference defects handled
here (SURVEY.md section 2.4):

- B2a MT33/MT34 in the reference are partially copy-paste-broken
  (`BDS-3_B2a/include/ephemeris.m:157-297`).  Deltas decoded here
  correctly per ICD-B2a-1.0:
  * MT33 carries Clock + BGTO.  The reference's BGTO ranges (112:179)
    are correct (widths 3/13/16/16/13/7 match the ICD), but its IODC
    read at 112:121 is the copy-paste bug — in MT33 the IODC follows
    the BGTO block at bits 180:189.  We decode both correctly.
  * MT34 carries SISAI + Clock: t_op(43:53), SISAI_ocb(54:58),
    SISAI_oc1(59:61), SISAI_oc2(62:64) precede the clock block at 65.
    The reference's "BDT-UTC" assignments in MT34 (every field reading
    bits 123:133) are copy-paste garbage for fields MT34 does not
    carry; BDT-UTC is a B-CNAV1 subframe-3 page-1 product (decoded in
    parse_bcnav1_frame below).
  * MT30 additionally carries T_GD_B2ap(122:133) and ISC_B2ad(134:145)
    ahead of the iono block; the reference skips them.
- The B2a eph struct never defines the B1C group delay the B2a satpos
  reads (T_GDB1Cp): here group delays default to 0.0 so the B2a PVT path
  is well-defined.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bds3_tpu_torch.navmsg.bits import s, u

BDS_PI = 3.1415926535898


@dataclasses.dataclass
class Ephemeris:
    """Broadcast ephemeris + clock for one satellite (superset of the two
    reference eph structs, `eph_structure_init.m`)."""

    prn: int = 0
    # validity: B1C single-frame flag; B2a per-message-type flags
    flag: bool = False
    id_valid: set = dataclasses.field(default_factory=set)
    # time
    sow: float | None = None     # B2a seconds of week (MT second count * 3)
    soh: float | None = None     # B1C seconds of hour
    wn: int = 0
    how: int = 0                 # B1C hours of week
    tow: float | None = None
    iodc: int = 0
    iode: int = 0
    sat_type: str = ""
    # orbit (subframe 2 / MT10+11)
    t_oe: float = 0.0
    delta_a: float = 0.0
    a_dot: float = 0.0
    delta_n0: float = 0.0
    delta_n0_dot: float = 0.0
    m_0: float = 0.0
    e: float = 0.0
    omega: float = 0.0
    omega_0: float = 0.0
    i_0: float = 0.0
    omega_dot: float = 0.0
    i_0_dot: float = 0.0
    c_is: float = 0.0
    c_ic: float = 0.0
    c_rs: float = 0.0
    c_rc: float = 0.0
    c_us: float = 0.0
    c_uc: float = 0.0
    # clock
    t_oc: float = 0.0
    a_0: float = 0.0
    a_1: float = 0.0
    a_2: float = 0.0
    # group delays (B1C subframe 2 / B2a MT30)
    t_gd_b2ap: float = 0.0
    isc_b1cd: float = 0.0
    t_gd_b1cp: float = 0.0
    isc_b2ad: float = 0.0
    # SIS accuracy indices (B2a MT34)
    t_op: float = 0.0
    sisai_ocb: int = 0
    sisai_oc1: int = 0
    sisai_oc2: int = 0
    # iono (B1C page 1 / B2a MT30)
    alpha: tuple = (0.0,) * 9
    # health / integrity
    hs: int = 0
    dif: int = 0
    sif: int = 0
    aif: int = 0
    sismai: int = 0
    # UTC / BGTO (B1C pages)
    a_0_utc: float = 0.0
    a_1_utc: float = 0.0
    a_2_utc: float = 0.0
    delta_t_ls: float = 0.0
    t_ot: float = 0.0
    wn_ot: int = 0
    wn_lsf: int = 0
    dn: int = 0
    delta_t_lsf: float = 0.0
    gnss_id: int = 0
    wn_0_bgto: int = 0
    t_0_bgto: float = 0.0
    a_0_bgto: float = 0.0
    a_1_bgto: float = 0.0
    a_2_bgto: float = 0.0

    def has_b2a_requisites(self) -> bool:
        """B2a PVT gate: MT10 + MT11 + one of MT30..34
        (`BDS-3_B2a/postNavigation.m:84-100`)."""
        return (10 in self.id_valid and 11 in self.id_valid
                and any(m in self.id_valid for m in (30, 31, 32, 33, 34)))


def _parse_orbit_block(eph: Ephemeris, b: np.ndarray, base: int) -> None:
    """Ephemeris I+II common to B-CNAV1 SF2 and B-CNAV2 MT10/11 field
    scaling (identical scale factors in both ICDs)."""


def parse_bcnav1_frame(bits: np.ndarray, eph: Ephemeris) -> Ephemeris:
    """Parse one 878-bit B-CNAV1 frame (after BCH + de-interleave;
    `BDS-3_B1C/include/ephemeris.m:66-237`).

    bits: uint8 array of length 878: [PRN(6) SOH(8) SF2(600) SF3(264)].
    """
    b = np.asarray(bits, dtype=np.uint8)
    prn = u(b, 1, 6)
    if prn < 1 or prn > 63:
        return eph
    eph.prn = prn
    first = not eph.flag
    if first:
        eph.soh = u(b, 7, 14) * 18
        # subframe 2 header
        eph.wn = u(b, 15, 27)
        eph.how = u(b, 28, 35)
        eph.iodc = u(b, 36, 46)
        eph.iode = u(b, 46, 53)          # sic: reference subFra2Bit(32:39)
        # Ephemeris I (bits 54..256)
        o = 53
        eph.t_oe = u(b, o + 1, o + 11) * 300
        eph.sat_type = {1: "GEO", 2: "IGSO", 3: "MEO"}.get(
            u(b, o + 12, o + 13), "")
        eph.delta_a = s(b, o + 14, o + 39) * 2.0**-9
        eph.a_dot = s(b, o + 40, o + 64) * 2.0**-21
        eph.delta_n0 = s(b, o + 65, o + 81) * 2.0**-44 * BDS_PI
        eph.delta_n0_dot = s(b, o + 82, o + 104) * 2.0**-57 * BDS_PI
        eph.m_0 = s(b, o + 105, o + 137) * 2.0**-32 * BDS_PI
        eph.e = u(b, o + 138, o + 170) * 2.0**-34
        eph.omega = s(b, o + 171, o + 203) * 2.0**-32 * BDS_PI
        # Ephemeris II (bits 257..478)
        o = 256
        eph.omega_0 = s(b, o + 1, o + 33) * 2.0**-32 * BDS_PI
        eph.i_0 = s(b, o + 34, o + 66) * 2.0**-32 * BDS_PI
        eph.omega_dot = s(b, o + 67, o + 85) * 2.0**-44 * BDS_PI
        eph.i_0_dot = s(b, o + 86, o + 100) * 2.0**-44 * BDS_PI
        eph.c_is = s(b, o + 101, o + 116) * 2.0**-30
        eph.c_ic = s(b, o + 117, o + 132) * 2.0**-30
        eph.c_rs = s(b, o + 133, o + 156) * 2.0**-8
        eph.c_rc = s(b, o + 157, o + 180) * 2.0**-8
        eph.c_us = s(b, o + 181, o + 201) * 2.0**-30
        eph.c_uc = s(b, o + 202, o + 222) * 2.0**-30
        # clock (bits 479..547)
        o = 478
        eph.t_oc = u(b, o + 1, o + 11) * 300
        eph.a_0 = s(b, o + 12, o + 36) * 2.0**-34
        eph.a_1 = s(b, o + 37, o + 58) * 2.0**-50
        eph.a_2 = s(b, o + 59, o + 69) * 2.0**-66
        # group delays (bits 548..583)
        o = 547
        eph.t_gd_b2ap = s(b, o + 1, o + 12) * 2.0**-34
        eph.isc_b1cd = s(b, o + 13, o + 24) * 2.0**-34
        eph.t_gd_b1cp = s(b, o + 25, o + 36) * 2.0**-34

    # subframe 3 (bits 615..878)
    o = 614
    page_id = u(b, o + 1, o + 6)
    eph.hs = u(b, o + 7, o + 8)
    eph.dif = u(b, o + 9, o + 9)
    eph.sif = u(b, o + 10, o + 10)
    eph.aif = u(b, o + 11, o + 11)
    eph.sismai = u(b, o + 12, o + 15)
    if page_id == 1:
        t = o + 42  # iono block at subframe-3 bits 43..116
        eph.alpha = (
            u(b, t + 1, t + 10) * 2.0**-3,
            s(b, t + 11, t + 18) * 2.0**-3,
            u(b, t + 19, t + 26) * 2.0**-3,
            u(b, t + 27, t + 34) * 2.0**-3,
            u(b, t + 35, t + 42) * 2.0**-3,
            s(b, t + 43, t + 50) * 2.0**-3,
            s(b, t + 51, t + 58) * 2.0**-3,
            s(b, t + 59, t + 66) * 2.0**-3,
            s(b, t + 67, t + 74) * 2.0**-3,
        )
        t = o + 116  # BDT-UTC block at subframe-3 bits 117..213
        eph.a_0_utc = s(b, t + 1, t + 16) * 2.0**-35
        eph.a_1_utc = s(b, t + 17, t + 29) * 2.0**-51
        eph.a_2_utc = s(b, t + 30, t + 36) * 2.0**-68
        eph.delta_t_ls = s(b, t + 37, t + 44)
        eph.t_ot = u(b, t + 45, t + 60) * 16.0
        eph.wn_ot = u(b, t + 61, t + 73)
        eph.wn_lsf = u(b, t + 74, t + 86)
        eph.dn = u(b, t + 87, t + 89)
        eph.delta_t_lsf = s(b, t + 90, t + 97)
    elif page_id == 3:
        t = o + 158  # BGTO block at subframe-3 bits 159..226
        eph.gnss_id = u(b, t + 1, t + 3)
        eph.wn_0_bgto = u(b, t + 4, t + 16)
        eph.t_0_bgto = u(b, t + 17, t + 32) * 16.0
        eph.a_0_bgto = s(b, t + 33, t + 48) * 2.0**-35
        eph.a_1_bgto = s(b, t + 49, t + 61) * 2.0**-51
        eph.a_2_bgto = s(b, t + 62, t + 68) * 2.0**-68

    if first:
        eph.tow = eph.how * 3600 + eph.soh
    eph.flag = True
    return eph


def parse_bcnav2_message(bits: np.ndarray, eph: Ephemeris) -> Ephemeris:
    """Parse one 288-bit B-CNAV2 message (264 data + CRC24 already checked;
    `BDS-3_B2a/include/ephemeris.m:57-310`)."""
    b = np.asarray(bits, dtype=np.uint8)
    prn = u(b, 1, 6)
    if prn < 1 or prn > 63:
        return eph
    mtype = u(b, 7, 12)
    eph.prn = prn
    if eph.sow is None:
        eph.sow = u(b, 13, 30) * 3

    if mtype == 10:
        eph.id_valid.add(10)
        eph.wn = u(b, 31, 43)
        eph.dif = u(b, 44, 44)
        eph.sif = u(b, 45, 45)
        eph.aif = u(b, 46, 46)
        eph.t_oe = u(b, 62, 72) * 300
        eph.sat_type = {1: "GEO", 2: "IGSO", 3: "MEO"}.get(u(b, 73, 74), "")
        eph.delta_a = s(b, 75, 100) * 2.0**-9
        eph.a_dot = s(b, 101, 125) * 2.0**-21
        eph.delta_n0 = s(b, 126, 142) * 2.0**-44 * BDS_PI
        eph.delta_n0_dot = s(b, 143, 165) * 2.0**-57 * BDS_PI
        eph.m_0 = s(b, 166, 198) * 2.0**-32 * BDS_PI
        eph.e = u(b, 199, 231) * 2.0**-34
        eph.omega = s(b, 232, 264) * 2.0**-32 * BDS_PI
    elif mtype == 11:
        eph.id_valid.add(11)
        eph.hs = u(b, 31, 32)
        eph.dif = u(b, 33, 33)
        eph.sif = u(b, 34, 34)
        eph.aif = u(b, 36, 36)
        eph.omega_0 = s(b, 43, 75) * 2.0**-32 * BDS_PI
        eph.i_0 = s(b, 76, 108) * 2.0**-32 * BDS_PI
        eph.omega_dot = s(b, 109, 127) * 2.0**-44 * BDS_PI
        eph.i_0_dot = s(b, 128, 142) * 2.0**-44 * BDS_PI
        eph.c_is = s(b, 143, 158) * 2.0**-30
        eph.c_ic = s(b, 159, 174) * 2.0**-30
        eph.c_rs = s(b, 175, 198) * 2.0**-8
        eph.c_rc = s(b, 199, 222) * 2.0**-8
        eph.c_us = s(b, 223, 243) * 2.0**-30
        eph.c_uc = s(b, 244, 264) * 2.0**-30
    elif mtype in (30, 31, 32, 33):
        eph.id_valid.add(mtype)
        eph.t_oc = u(b, 43, 53) * 300
        eph.a_0 = s(b, 54, 78) * 2.0**-34
        eph.a_1 = s(b, 79, 100) * 2.0**-50
        eph.a_2 = s(b, 101, 111) * 2.0**-66
        if mtype == 33:
            # Clock + BGTO (ICD-B2a-1.0): BGTO directly after a_2, IODC
            # after the BGTO block.  The reference's IODC read at
            # 112:121 (ephemeris.m:252-256) is its MT30 copy-paste bug;
            # its BGTO ranges (ephemeris.m:258-264) are correct.
            eph.gnss_id = u(b, 112, 114)
            eph.wn_0_bgto = u(b, 115, 127)
            eph.t_0_bgto = u(b, 128, 143) * 16.0
            eph.a_0_bgto = s(b, 144, 159) * 2.0**-35
            eph.a_1_bgto = s(b, 160, 172) * 2.0**-51
            eph.a_2_bgto = s(b, 173, 179) * 2.0**-68
            eph.iodc = (u(b, 180, 181) << 8) | u(b, 182, 189)
        else:
            eph.iodc = (u(b, 112, 113) << 8) | u(b, 114, 121)
        if mtype == 30:
            # group delays ahead of the iono block (skipped by the
            # reference, ephemeris.m:166-183)
            eph.t_gd_b2ap = s(b, 122, 133) * 2.0**-34
            eph.isc_b2ad = s(b, 134, 145) * 2.0**-34
            eph.alpha = (
                u(b, 146, 155) * 2.0**-3,
                s(b, 156, 163) * 2.0**-3,
                u(b, 164, 171) * 2.0**-3,
                u(b, 172, 179) * 2.0**-3,
                u(b, 180, 187) * 2.0**-3,
                s(b, 188, 195) * 2.0**-3,
                s(b, 196, 203) * 2.0**-3,
                s(b, 204, 211) * 2.0**-3,
                s(b, 212, 219) * 2.0**-3,
            )
    elif mtype == 34:
        # SISAI + Clock (ICD-B2a-1.0): a 22-bit SISAI block precedes
        # the clock fields.  The reference decodes the clock/IODC at
        # the right offsets but then assigns nine "BDT-UTC" fields all
        # from bits 123:133 (ephemeris.m:280-289) — fields MT34 does
        # not carry; they are not reproduced here.
        eph.id_valid.add(34)
        eph.t_op = u(b, 43, 53) * 300
        eph.sisai_ocb = u(b, 54, 58)
        eph.sisai_oc1 = u(b, 59, 61)
        eph.sisai_oc2 = u(b, 62, 64)
        eph.t_oc = u(b, 65, 75) * 300
        eph.a_0 = s(b, 76, 100) * 2.0**-34
        eph.a_1 = s(b, 101, 122) * 2.0**-50
        eph.a_2 = s(b, 123, 133) * 2.0**-66
        eph.iodc = (u(b, 134, 135) << 8) | u(b, 136, 143)
    else:
        eph.id_valid.add(mtype)
    return eph
