"""B-CNAV2 LDPC decode demo: recover a frame the reference would drop.

Port of examples/ldpc_decode_demo.py on the port's own navmsg copies;
its printed lines are the original's.  Synthesizes a B-CNAV2 symbol
stream at a symbol SNR where the hard systematic CRC path (the
reference's only decode path, BCNAV2decoding.m:129-132) fails on most
frames, then shows the soft 64-ary LDPC(96,48) extension recovering
them.  Host only (numpy), runs in seconds:

    python -m bds3_tpu_torch.examples.ldpc_decode_demo
"""
from __future__ import annotations

import sys

import numpy as np

from bds3_tpu_torch.navmsg.bcnav2 import decode_bcnav2
from bds3_tpu_torch.navmsg.encode import bcnav2_symbols, build_bcnav2_message
from bds3_tpu_torch.navmsg.ephemeris import Ephemeris
from bds3_tpu_torch.signals import b2a_data_secondary


def main(argv=None) -> int:
    if argv:
        print("usage: python -m bds3_tpu_torch.examples.ldpc_decode_demo",
              file=sys.stderr)
        return 2
    eph = Ephemeris()
    eph.prn = 5
    eph.iodc, eph.iode = 105, 15
    msgs = [build_bcnav2_message(eph, mt, 1200.0 + 3 * i)
            for i, mt in enumerate((10, 11, 30))]
    sym = bcnav2_symbols(msgs)
    sec = b2a_data_secondary().astype(np.float64)
    chips = np.kron(sym.astype(np.float64), sec)   # 1 ms data-prompt epochs

    rng = np.random.default_rng(0)
    sigma = np.sqrt(5) * 0.72         # folded symbol SNR ~ 1.4 (raw BER ~8%)
    n_hard = n_ldpc = 0
    trials = 10
    for _ in range(trials):
        stream = chips + rng.normal(0, sigma, len(chips))
        eph_h, _, _ = decode_bcnav2(stream, ldpc=False)
        eph_l, _, _ = decode_bcnav2(stream, ldpc=True)
        n_hard += int(eph_h.has_b2a_requisites())
        n_ldpc += int(eph_l.has_b2a_requisites())
    print(f"raw symbol SNR ~1.4 ({trials} trials):")
    print(f"  hard systematic CRC path (reference): {n_hard}/{trials} frames")
    print(f"  soft LDPC(96,48) extension:           {n_ldpc}/{trials} frames")
    ok = n_ldpc > n_hard
    print("DEMO PASS" if ok else "DEMO FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
