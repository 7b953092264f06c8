"""B-CNAV1 (B1C) frame synchronization and decoding.

Parity with `BDS-3_B1C/include/BCNAV1decoding.m:65-189`: frame sync by
correlating the hard-limited pilot prompt stream against the 1800-chip
secondary code; at each full-match lag, decode subframe 1 with the BCH
hypothesis decoders (retrying inverted polarity), block de-interleave
subframes 2/3 (36x48, columns 3:3:35 -> SF3), CRC-24Q gate both, then
parse ephemeris.  LDPC decoding is skipped exactly as in the reference
(BCNAV1decoding.m:156-158) — the codes are systematic so the information
symbols are read directly.
"""
from __future__ import annotations

import numpy as np

from bds3_tpu_torch.config import TrackMode
from bds3_tpu_torch.navmsg.bch import (bch21_6_decode, bch51_8_decode,
                                 bch_decode_soft)
from bds3_tpu_torch.navmsg.crc import crc24q_check
from bds3_tpu_torch.navmsg.ephemeris import Ephemeris, parse_bcnav1_frame
from bds3_tpu_torch.signals import b1c_secondary_code

FRAME_SYMBOLS = 1800


def _sync_candidates(pilot_prompt: np.ndarray, prn: int) -> np.ndarray:
    """0-based start indices where |xcorr with the secondary code| is a
    full 1800-chip match (threshold 1799.5, BCNAV1decoding.m:91)."""
    signs = np.where(pilot_prompt > 0, 1.0, -1.0)
    sec = b1c_secondary_code(prn).astype(np.float64)
    n = len(signs)
    if n < FRAME_SYMBOLS:
        return np.array([], dtype=np.int64)
    # correlation at non-negative lags: c[k] = sum signs[k+j] * sec[j]
    c = np.correlate(signs, sec, mode="valid")
    return np.nonzero(np.abs(c) >= 1799.5)[0]


def decode_bcnav1(
    data_prompt: np.ndarray,
    pilot_prompt: np.ndarray,
    prn: int,
    ldpc: bool = False,
) -> tuple[Ephemeris, int | None, float | None]:
    """Decode all frames in one channel's prompt streams.

    data_prompt: data-channel I_P per 10 ms epoch.
    pilot_prompt: pilot prompt carrying the secondary code (composite I in
    WB mode, BOC11 Q in NB mode — caller selects, BCNAV1decoding.m:66-73).
    ldpc=True: subframes whose hard systematic CRC fails get a soft
    64-ary LDPC(200,100)/(88,44) decode over the de-interleaved
    codewords (navmsg/ldpc.py) before the frame is dropped.
    Returns (eph, first_subframe_epoch (0-based), TOW).
    """
    eph = Ephemeris()
    first_sf = None
    tow = None
    for idx in _sync_candidates(pilot_prompt, prn):
        if idx + FRAME_SYMBOLS > len(data_prompt):
            continue
        soft = np.asarray(data_prompt[idx : idx + FRAME_SYMBOLS],
                          dtype=np.float64)
        bits = (soft > 0).astype(np.uint8)

        dec = bch21_6_decode(1.0 - 2.0 * bits[:21])
        if dec is None:
            bits = 1 - bits
            soft = -soft
            dec = bch21_6_decode(1.0 - 2.0 * bits[:21])
        dec51 = None if dec is None \
            else bch51_8_decode(1.0 - 2.0 * bits[21:72])
        if dec51 is None and ldpc:
            # the reference thresholds require ~error-free subframe-1
            # symbols; decode softly over both polarities and gate on the
            # normalized correlations (noise-only ~N(0, 1/sqrt(n)))
            best = (-1.0, None, None, 1.0)
            for fl in (1.0, -1.0):
                d1, c1 = bch_decode_soft(-soft[:21] * fl, 21, 6)
                d2, c2 = bch_decode_soft(-soft[21:72] * fl, 51, 8)
                if min(c1, c2) > best[0]:
                    best = (min(c1, c2), d1, d2, fl)
            if best[0] >= 0.45:
                dec, dec51, fl = best[1], best[2], best[3]
                soft = soft * fl
                bits = (soft > 0).astype(np.uint8)
        if dec is None or dec51 is None:
            continue
        frame = np.zeros(878, dtype=np.uint8)
        frame[:6] = dec
        frame[6:14] = dec51

        # de-interleave: MATLAB reshape(bits(73:end),[36,48]) is
        # column-major: element (r, c) = bits[72 + c*36 + r]
        inter = bits[72:].reshape(48, 36).T  # (36, 48)
        sf3_rows = np.arange(2, 35, 3)       # MATLAB cols 3:3:35, 0-based
        sf2_rows = np.setdiff1d(np.arange(36), sf3_rows)
        sf2 = inter[sf2_rows].reshape(-1)    # row-major == MATLAB (.')
        sf3 = inter[sf3_rows].reshape(-1)

        sf2_ok = crc24q_check(sf2[:600])
        sf3_ok = crc24q_check(sf3[:264])
        if ldpc and not (sf2_ok and sf3_ok):
            # soft LDPC over the de-interleaved codewords; bipolar
            # symbol +1 = bit 0, scaled to half-LLRs (bcnav2.py recipe)
            from bds3_tpu_torch.navmsg.ldpc import code_h, decode as ldpc_decode

            soft_i = -soft[72:].reshape(48, 36).T   # bit 1 -> -1
            a = float(np.mean(np.abs(soft_i)))
            s2 = max(float(np.var(np.abs(soft_i))), 1e-9 * a * a + 1e-12)
            scale = a / s2
            if not sf2_ok:
                d2, ok2 = ldpc_decode(
                    soft_i[sf2_rows].reshape(-1) * scale,
                    code_h("bcnav1_sf2"))
                if ok2 and crc24q_check(d2):
                    sf2 = np.concatenate([d2, sf2[600:]])
                    sf2_ok = True
            if not sf3_ok:
                d3, ok3 = ldpc_decode(
                    soft_i[sf3_rows].reshape(-1) * scale,
                    code_h("bcnav1_sf3"))
                if ok3 and crc24q_check(d3):
                    sf3 = np.concatenate([d3, sf3[264:]])
                    sf3_ok = True
        if not (sf2_ok and sf3_ok):
            continue
        frame[14:614] = sf2[:600]
        frame[614:] = sf3[:264]
        eph = parse_bcnav1_frame(frame, eph)
        if tow is None and eph.flag:
            tow = eph.tow
            first_sf = int(idx)
    return eph, first_sf, tow


def pilot_prompt_stream(track_results, channel: int) -> np.ndarray:
    """Select the pilot prompt stream used for frame sync per tracking
    mode (BCNAV1decoding.m:66-73)."""
    mode = track_results.settings.track_mode
    o = track_results.outputs
    if mode == TrackMode.WIDEBAND:
        # composite pilot I
        import numpy as _np

        w11 = float(_np.sqrt(29.0 / 33.0))
        w61 = float(_np.sqrt(4.0 / 33.0))
        return (-w61 * o["p61_ip"][channel] + w11 * o["p11_qp"][channel])
    return o["p11_qp"][channel]
