"""BeiDou-3 B1C/B2a per-PRN ICD constant tables (PRN 1..63).

Auto-generated by tools/extract_icd_tables.py from the BDS-SIS-ICD tables as
carried by the reference receiver (see file docstring there for file:line
provenance).  Do not edit the generated tables by hand.  Exception: the
B2a pilot-secondary block at the end is hand-maintained — the reference
carries no source for it (see its provenance caveat).

B2a G2 seeds are packed MSB-first: bit 12 (MSB) is ICD register cell 1.
"""

# B2a data-channel G2 register initial states, 13-bit ints, MSB = cell 1.
# Source: BDS-3_B2a/include/generateB2aDataCode.m:39-101 (ICD-B2a-1.0 tbl 5-4)
B2A_DATA_G2_SEED = (
    4133, 4148, 4269, 4431, 4437, 4526, 4590, 4603, 4905, 5082,
    5173, 5188, 5205, 5211, 5212, 5283, 5367, 5377, 5438, 5547,
    5553, 5715, 5730, 5784, 5814, 5874, 5887, 5906, 5948, 6049,
    6088, 6100, 6123, 6131, 6225, 6292, 6327, 6417, 6425, 6571,
    6577, 6610, 6741, 6772, 6859, 6999, 7220, 7299, 7307, 7331,
    7336, 7483, 7575, 7752, 7828, 7833, 7898, 7928, 7935, 8117,
    1026, 7157, 978,
)

# B2a pilot-channel G2 register initial states.
# Source: BDS-3_B2a/include/generateB2aPilotCode.m:39-101
B2A_PILOT_G2_SEED = (
    4133, 4148, 4269, 4431, 4437, 4526, 4590, 4603, 4905, 5082,
    5173, 5188, 5205, 5211, 5212, 5283, 5367, 5377, 5438, 5547,
    5553, 5715, 5730, 5784, 5814, 5874, 5887, 5906, 5948, 6049,
    6088, 6100, 6123, 6131, 6225, 6292, 6327, 6417, 6425, 6571,
    6577, 6610, 6741, 6772, 6859, 6999, 7220, 7299, 7307, 7331,
    7336, 7483, 7575, 7752, 7828, 7833, 7898, 7928, 7935, 8117,
    5254, 1528, 853,
)

# B2a LFSR feedback taps (1-based cell numbers per ICD register diagram).
B2A_DATA_G1_TAPS = (1, 5, 11, 13)
B2A_DATA_G2_TAPS = (3, 5, 9, 11, 12, 13)
B2A_PILOT_G1_TAPS = (3, 6, 7, 13)
B2A_PILOT_G2_TAPS = (1, 5, 7, 8, 12, 13)
# G1 register is reset to all-ones after outputting this many chips.
B2A_G1_RESET_CHIP = 8190
B2A_CODE_LENGTH = 10230

# B1C Weil-code parameters: (phase_diff w, truncation_point p) per PRN.
# Primary codes: Legendre sequence length N=10243, truncated to 10230 chips.
# Source: BDS-3_B1C/include/generateDataBOC11.m:43-58 (ICD-B1C-1.0 tbl 4-3)
B1C_DATA_WP = (
    (2678, 699), (4802, 694), (958, 7318), (859, 2127), (3843, 715),
    (2232, 6682), (124, 7850), (4352, 5495), (1816, 1162), (1126, 7682),
    (1860, 6792), (4800, 9973), (2267, 6596), (424, 2092), (4192, 19),
    (4333, 10151), (2656, 6297), (4148, 5766), (243, 2359), (1330, 7136),
    (1593, 1706), (1470, 2128), (882, 6827), (3202, 693), (5095, 9729),
    (2546, 1620), (1733, 6805), (4795, 534), (4577, 712), (1627, 1929),
    (3638, 5355), (2553, 6139), (3646, 6339), (1087, 1470), (1843, 6867),
    (216, 7851), (2245, 1162), (726, 7659), (1966, 1156), (670, 2672),
    (4130, 6043), (53, 2862), (4830, 180), (182, 2663), (2181, 6940),
    (2006, 1645), (1080, 1582), (2288, 951), (2027, 6878), (271, 7701),
    (915, 1823), (497, 2391), (139, 2606), (3693, 822), (2054, 6403),
    (4342, 239), (3342, 442), (2592, 6769), (1007, 2560), (310, 2502),
    (4203, 5072), (455, 7268), (4318, 341),
)

# Source: BDS-3_B1C/include/generatePilotBOC11.m:44-59
B1C_PILOT_WP = (
    (796, 7575), (156, 2369), (4198, 5688), (3941, 539), (1374, 2270),
    (1338, 7306), (1833, 6457), (2521, 6254), (3175, 5644), (168, 7119),
    (2715, 1402), (4408, 5557), (3160, 5764), (2796, 1073), (459, 7001),
    (3594, 5910), (4813, 10060), (586, 2710), (1428, 1546), (2371, 6887),
    (2285, 1883), (3377, 5613), (4965, 5062), (3779, 1038), (4547, 10170),
    (1646, 6484), (1430, 1718), (607, 2535), (2118, 1158), (4709, 526),
    (1149, 7331), (3283, 5844), (2473, 6423), (1006, 6968), (3670, 1280),
    (1817, 1838), (771, 1989), (2173, 6468), (740, 2091), (1433, 1581),
    (2458, 1453), (3459, 6252), (2155, 7122), (1205, 7711), (413, 7216),
    (874, 2113), (2463, 1095), (1106, 1628), (1590, 1713), (3873, 6102),
    (4026, 6123), (4272, 6070), (3556, 1115), (128, 8047), (1200, 6795),
    (130, 2575), (4494, 53), (1871, 1729), (3073, 6388), (4386, 682),
    (4098, 5565), (1923, 7160), (1176, 2277),
)

# Pilot secondary code: Legendre N=3607, truncated to 1800 chips.
# Source: BDS-3_B1C/include/generate2ndCode.m:44-56 (ICD-B1C-1.0 tbl 4-5)
B1C_SECONDARY_WP = (
    (269, 1889), (1448, 1268), (1028, 1593), (1324, 1186), (822, 1239),
    (5, 1930), (155, 176), (458, 1696), (310, 26), (959, 1344),
    (1238, 1271), (1180, 1182), (1288, 1381), (334, 1604), (885, 1333),
    (1362, 1185), (181, 31), (1648, 704), (838, 1190), (313, 1646),
    (750, 1385), (225, 113), (1477, 860), (309, 1656), (108, 1921),
    (1457, 1173), (149, 1928), (322, 57), (271, 150), (576, 1214),
    (1103, 1148), (450, 1458), (399, 1519), (241, 1635), (1045, 1257),
    (164, 1687), (513, 1382), (687, 1514), (422, 1), (303, 1583),
    (324, 1806), (495, 1664), (725, 1338), (780, 1111), (367, 1706),
    (882, 1543), (631, 1813), (37, 228), (647, 2871), (1043, 2884),
    (24, 1823), (120, 75), (134, 11), (136, 63), (158, 1937),
    (214, 22), (335, 1768), (340, 1526), (661, 1402), (889, 1445),
    (929, 1680), (1002, 1290), (1149, 1245),
)

B1C_LEGENDRE_N = 10243
B1C_SECONDARY_LEGENDRE_N = 3607
B1C_CODE_LENGTH = 10230
B1C_SECONDARY_LENGTH = 1800

# B2a data secondary code (5 chips, bipolar) — ICD-B2a-1.0; reference
# BDS-3_B2a/include/BCNAV2decoding.m:69.
B2A_DATA_SECONDARY = (1, 1, 1, -1, 1)

# --- B2a pilot secondary codes (ICD-B2a-1.0 section 5.2.3) ---------------
# Construction: length-1021 Weil sequences truncated to 100 chips, one
# (phase w, truncation point p) pair per PRN — the same generator family
# as the B1C secondary codes above (signals/weil.py:weil_code).
#
# PARAMETER PROVENANCE CAVEAT: the per-PRN (w, p) table is published only
# in the ICD PDF.  The reference receiver does not carry it (its tracker
# ignores the pilot secondary entirely), no retrieved snippet contains
# it, and this build environment has no network egress — so the values
# below are a deterministic placeholder (w = PRN, p = PRN), NOT the ICD
# broadcast values.  Everything structural (generator, synthesizer
# overlay, receiver-side secondary sync) uses this table consistently,
# so the full pilot-aided chain works end-to-end on synthesized signal;
# processing on-air captures requires dropping in the ICD Table values
# here (a data-only change).
B2A_PILOT_SECONDARY_PARAMS_ARE_PLACEHOLDER = True
B2A_PILOT_SECONDARY_LEGENDRE_N = 1021
B2A_PILOT_SECONDARY_LENGTH = 100
B2A_PILOT_SECONDARY_WP = tuple(
    (prn, prn) for prn in range(1, 64)
)
