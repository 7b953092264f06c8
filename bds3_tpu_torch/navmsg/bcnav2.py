"""B-CNAV2 (B2a) frame synchronization and decoding.

Parity with `BDS-3_B2a/include/BCNAV2decoding.m:62-159`: the 24-bit
preamble upsampled by the 5-chip data secondary code is correlated against
the hard-limited data prompt stream (1 ms symbols); at each hit, 3000
symbols are folded 5:1 with secondary-code wipe-off into 600 message
symbols, polarity-corrected by the preamble, CRC-24Q checked over the
systematic 288 bits (LDPC skipped as in the reference,
BCNAV2decoding.m:129-132), and parsed message-by-message.
"""
from __future__ import annotations

import numpy as np

from bds3_tpu_torch.navmsg.crc import crc24q_check
from bds3_tpu_torch.navmsg.ephemeris import Ephemeris, parse_bcnav2_message
from bds3_tpu_torch.signals import b2a_data_secondary

# ICD-B2a frame preamble, bipolar (BCNAV2decoding.m:72-74)
PREAMBLE = np.array(
    [-1, -1, -1, 1, 1, 1, -1, 1, 1, -1, 1, 1,
     -1, -1, 1, -1, -1, -1, -1, 1, -1, 1, 1, 1], dtype=np.float64
)
FRAME_MS = 3000       # 600 symbols x 5 ms
MSG_SYMBOLS = 600


def _sync_candidates(data_prompt: np.ndarray,
                     threshold: float = 115.0) -> np.ndarray:
    """Preamble-epoch correlation hits.  The reference's 115/120
    threshold presumes near-clean symbol decisions; the LDPC path lowers
    it (noise-only sd is sqrt(120) ~ 11, so 40 is still 3.6 sigma) and
    lets the downstream CRC/parity gates reject false candidates."""
    signs = np.where(data_prompt > 0, 1.0, -1.0)
    sec = b2a_data_secondary().astype(np.float64)
    pattern = np.kron(PREAMBLE, sec)  # 120 ms preamble waveform
    if len(signs) < len(pattern):
        return np.array([], dtype=np.int64)
    c = np.correlate(signs, pattern, mode="valid")
    return np.nonzero(np.abs(c) > threshold)[0]


def decode_bcnav2(data_prompt: np.ndarray,
                  ldpc: bool = False) -> tuple[Ephemeris, int | None, float | None]:
    """Decode all messages in one channel's data prompt stream (1 ms epochs).

    ldpc=True: when the hard-decision systematic read fails CRC (the
    reference's only path, BCNAV2decoding.m:129-132), run the soft
    64-ary LDPC(96,48) decode over the full codeword (navmsg/ldpc.py)
    before giving up on the frame — recovers messages several dB below
    the hard-CRC threshold.

    Returns (eph, first_subframe_epoch (0-based), TOW)."""
    eph = Ephemeris()
    first_sf = None
    tow = None
    sec = b2a_data_secondary().astype(np.float64)
    signs = np.where(data_prompt > 0, 1.0, -1.0)
    soft_all = np.asarray(data_prompt, dtype=np.float64)
    for idx in _sync_candidates(data_prompt, 40.0 if ldpc else 115.0):
        if idx + FRAME_MS > len(signs):
            continue
        grp = signs[idx : idx + FRAME_MS].reshape(MSG_SYMBOLS, 5)
        soft = (soft_all[idx : idx + FRAME_MS].reshape(MSG_SYMBOLS, 5)
                * sec).sum(axis=1)
        nav = np.where((grp * sec).sum(axis=1) > 0, 1.0, -1.0)
        flip = 1.0
        if not np.array_equal(nav[:24], PREAMBLE):
            nav, flip = -nav, -1.0
        if not np.array_equal(nav[:24], PREAMBLE):
            # soft-preamble fallback for the LDPC path: sign of the
            # correlation decides polarity
            if not ldpc:
                continue
            c = float(np.dot(np.where(soft > 0, 1.0, -1.0)[:24], PREAMBLE))
            if abs(c) < 12:
                continue
            flip = 1.0 if c > 0 else -1.0
            nav = np.where(soft * flip > 0, 1.0, -1.0)
        msg_bits = (nav[24 : 24 + 288] < 0).astype(np.uint8)  # -1 -> 1
        if not crc24q_check(msg_bits):
            if not ldpc:
                continue
            # soft LDPC decode of the 576-symbol codeword; map the
            # folded symbol statistic to half-LLRs (s = A*x/sigma^2)
            from bds3_tpu_torch.navmsg.ldpc import decode as ldpc_decode

            cw_soft = soft[24:] * flip
            a = float(np.mean(np.abs(cw_soft)))
            s2 = max(float(np.var(np.abs(cw_soft))), 1e-9 * a * a + 1e-12)
            dec_bits, par_ok = ldpc_decode(cw_soft * (a / s2))
            if not (par_ok and crc24q_check(dec_bits)):
                continue
            msg_bits = dec_bits
        eph = parse_bcnav2_message(msg_bits, eph)
        if first_sf is None:
            first_sf = int(idx)
            tow = eph.sow
    return eph, first_sf, tow
