"""64-ary LDPC codecs for the B-CNAV messages — the decode stage the
reference receiver explicitly skips (`BDS-3_B2a/include/BCNAV2decoding.m:
129-132`, `BDS-3_B1C/include/BCNAV1decoding.m:144-163` read the
systematic halves and drop the parity), implemented as a labeled,
parity-default-off extension (VERDICT r4 item 7).

All three BDS-3 B-CNAV codes are rate-1/2 over GF(2^6) (primitive
polynomial x^6 + x + 1): B-CNAV2 LDPC(96, 48), B-CNAV1 subframe-2
LDPC(200, 100) and subframe-3 LDPC(88, 44).  The ICDs publish the
parity-check matrices only in the PDFs; this environment has no copy, so
the default matrices here are DETERMINISTIC SYNTHETIC constructions
(seeded, unit-lower-banded parity block for systematic encoding) used
consistently by the frame encoders and these decoders — the full
parity chain works end-to-end on synthesized captures, and the real ICD
matrices can be dropped in via ``BDS3_BCNAV2_LDPC_H`` /
``BDS3_BCNAV1_SF2_LDPC_H`` / ``BDS3_BCNAV1_SF3_LDPC_H`` (text files of
``row col coeff`` triples, coeff in GF(64) power-basis integer form) or
:func:`set_code_h`.

Decoder: probability-domain Q-ary sum-product with fast-Hadamard-
transform check nodes — GF(2^6)'s additive group is (Z_2)^6, so the
check-node convolution is pointwise in the 6-dimensional WHT domain, and
edge coefficients act as index permutations x -> h*x.  Messages are
(n_edges, 64) float64 arrays; a 20-iteration decode of one frame costs
~2 ms on host, noise next to the 3 s frame period.
"""
from __future__ import annotations

import os

import numpy as np

_PRIM = 0x43          # x^6 + x + 1
Q = 64
M_BITS = 6
N_SYM = 96            # codeword symbols
K_SYM = 48            # message symbols


def _build_tables():
    exp = np.zeros(2 * Q, dtype=np.int64)
    log = np.zeros(Q, dtype=np.int64)
    x = 1
    for i in range(Q - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & Q:
            x ^= _PRIM
    exp[Q - 1: 2 * Q - 2] = exp[: Q - 1]
    return exp, log


_EXP, _LOG = _build_tables()


def gf_mul(a, b):
    """GF(64) product (array-safe)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    out = _EXP[(_LOG[a] + _LOG[b]) % (Q - 1)]
    return np.where((a == 0) | (b == 0), 0, out)


def gf_inv(a):
    a = np.asarray(a, dtype=np.int64)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(64) inverse of 0")
    return _EXP[(Q - 1 - _LOG[a]) % (Q - 1)]


# --- parity-check matrices -------------------------------------------------
# All BDS-3 B-CNAV LDPC codes are rate-1/2 over GF(64): B-CNAV2 (96,48),
# B-CNAV1 subframe 2 (200,100) and subframe 3 (88,44).  H is (k, 2k);
# column block [0:k] covers the message symbols, [k:2k] the parity.

# (k_sym, env var, synthetic seed) per code name
_CODES = {
    "bcnav2": (48, "BDS3_BCNAV2_LDPC_H", 7),
    "bcnav1_sf2": (100, "BDS3_BCNAV1_SF2_LDPC_H", 11),
    "bcnav1_sf3": (44, "BDS3_BCNAV1_SF3_LDPC_H", 13),
}
_user_h: dict[str, np.ndarray] = {}


def _synthetic_h(k: int, seed: int) -> np.ndarray:
    """Deterministic placeholder H (k x 2k, GF(64) entries).

    Layout [A | B] with B unit-lower-banded (1s on the diagonal, one
    sub-band coefficient), so systematic encoding is forward
    substitution and H is full rank by construction.  A has column
    weight 3 over the k message symbols with nonzero random
    coefficients — enough structure for the decoder to show real coding
    gain, no claim of matching the ICD broadcast code.
    """
    rng = np.random.default_rng(seed)
    h = np.zeros((k, 2 * k), dtype=np.int64)
    for c in range(k):                           # message columns
        rows = rng.choice(k, size=3, replace=False)
        h[rows, c] = rng.integers(1, Q, size=3)
    for r in range(k):                           # parity block B
        h[r, k + r] = 1
        if r > 0:
            h[r, k + r - 1] = int(rng.integers(1, Q))
    return h


def _parse_h_file(path: str, k: int) -> np.ndarray:
    h = np.zeros((k, 2 * k), dtype=np.int64)
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            r, c, coeff = (int(t) for t in line.split())
            h[r, c] = coeff
    return h


def set_code_h(code: str, h: np.ndarray | None) -> None:
    """Install a user-supplied GF(64) parity-check matrix (the ICD
    broadcast code) for `code` in _CODES, or None to revert to the
    env/synthetic resolution."""
    k = _CODES[code][0]
    if h is None:
        _user_h.pop(code, None)
        return
    h = np.asarray(h, dtype=np.int64)
    if h.shape != (k, 2 * k):
        raise ValueError(f"{code}: H must be {k}x{2 * k}, got {h.shape}")
    _user_h[code] = h


def code_h(code: str) -> np.ndarray:
    k, env, seed = _CODES[code]
    if code in _user_h:
        return _user_h[code]
    path = os.environ.get(env, "")
    if path:
        return _parse_h_file(path, k)
    return _synthetic_h(k, seed)


def code_h_is_placeholder(code: str) -> bool:
    return code not in _user_h and not os.environ.get(_CODES[code][1], "")


def set_bcnav2_h(h: np.ndarray | None) -> None:
    set_code_h("bcnav2", h)


def bcnav2_h() -> np.ndarray:
    return code_h("bcnav2")


def bcnav2_h_is_placeholder() -> bool:
    return code_h_is_placeholder("bcnav2")


# --- bits <-> symbols ------------------------------------------------------

def bits_to_symbols(bits: np.ndarray) -> np.ndarray:
    """(6k,) 0/1 bits -> (k,) GF(64) symbols, MSB first per symbol."""
    b = np.asarray(bits, dtype=np.int64).reshape(-1, M_BITS)
    return (b << np.arange(M_BITS - 1, -1, -1)).sum(axis=1)


def symbols_to_bits(sym: np.ndarray) -> np.ndarray:
    s = np.asarray(sym, dtype=np.int64)[:, None]
    return ((s >> np.arange(M_BITS - 1, -1, -1)) & 1).astype(np.uint8).reshape(-1)


# --- encoder ---------------------------------------------------------------

def _gf_matvec(mat: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """GF(64) matrix-vector product via xor-reduce of gf_mul products."""
    prods = gf_mul(mat, vec[None, :])
    return np.bitwise_xor.reduce(prods, axis=1)


_binv_cache: dict[bytes, np.ndarray] = {}


def _parity_inverse(h: np.ndarray) -> np.ndarray:
    """B^{-1} over GF(64) for the parity block (cached per H)."""
    key = h.tobytes()
    if key in _binv_cache:
        return _binv_cache[key]
    k = h.shape[0]
    b = h[:, k:].copy()
    inv = np.eye(k, dtype=np.int64)
    for col in range(k):
        piv = col + int(np.argmax(b[col:, col] != 0))
        if b[piv, col] == 0:
            raise ValueError("parity block is singular")
        if piv != col:
            b[[col, piv]] = b[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        f = gf_inv(b[col, col])
        b[col] = gf_mul(b[col], f)
        inv[col] = gf_mul(inv[col], f)
        for r in range(k):
            if r != col and b[r, col]:
                f = b[r, col]
                b[r] = b[r] ^ gf_mul(f, b[col])
                inv[r] = inv[r] ^ gf_mul(f, inv[col])
    _binv_cache[key] = inv
    return inv


def encode(msg_bits: np.ndarray, h: np.ndarray | None = None) -> np.ndarray:
    """6k message bits -> 12k codeword bits (systematic [m | p]):
    H [m; p] = 0  =>  p = B^{-1} A m over GF(64).  Default code:
    B-CNAV2 (96,48); pass code_h("bcnav1_sf2"/"bcnav1_sf3") for the
    B-CNAV1 subframe codes."""
    h = bcnav2_h() if h is None else h
    k = h.shape[0]
    m = bits_to_symbols(msg_bits)
    if len(m) != k:
        raise ValueError(f"expected {k * M_BITS} message bits, got "
                         f"{len(msg_bits)}")
    rhs = _gf_matvec(h[:, :k], m)
    p = _gf_matvec(_parity_inverse(h), rhs)
    return np.concatenate([np.asarray(msg_bits, dtype=np.uint8),
                           symbols_to_bits(p)])


def parity_ok(cw_bits: np.ndarray, h: np.ndarray | None = None) -> bool:
    h = bcnav2_h() if h is None else h
    return not _gf_matvec(h, bits_to_symbols(cw_bits)).any()


# --- decoder ---------------------------------------------------------------

def _wht(v: np.ndarray) -> np.ndarray:
    """Walsh-Hadamard transform over the last axis (length 64 = 2^6)."""
    v = v.copy()
    n = v.shape[-1]
    h = 1
    while h < n:
        v = v.reshape(v.shape[:-1] + (n // (2 * h), 2, h))
        a = v[..., 0, :] + v[..., 1, :]
        b = v[..., 0, :] - v[..., 1, :]
        v = np.stack([a, b], axis=-2).reshape(v.shape[:-3] + (n,))
        h *= 2
    return v


def _bit_probs_to_symbol_probs(soft_bits: np.ndarray) -> np.ndarray:
    """(6k,) soft bipolar bits (+1 = bit 0) -> (k, 64) symbol probs."""
    s = np.asarray(soft_bits, dtype=np.float64).reshape(-1, M_BITS)
    p1 = 1.0 / (1.0 + np.exp(np.clip(2.0 * s, -40, 40)))   # P(bit = 1)
    sym = np.arange(Q)
    bits = ((sym[None, :] >> np.arange(M_BITS - 1, -1, -1)[:, None]) & 1)
    # (k, 6, 64): per-bit probability of matching each symbol's bit
    pb = np.where(bits[None, :, :] == 1, p1[:, :, None], 1.0 - p1[:, :, None])
    probs = pb.prod(axis=1)
    probs /= probs.sum(axis=1, keepdims=True)
    return probs


def decode(soft_bits: np.ndarray, h: np.ndarray | None = None,
           iters: int = 25) -> tuple[np.ndarray, bool]:
    """QSPA decode of one codeword.

    soft_bits: (576,) noisy bipolar symbol values (+1 = bit 0), any
    scale — the bit-confidence scale acts as the channel LLR scale.
    Returns (288 decoded message bits, parity_satisfied).
    """
    h = bcnav2_h() if h is None else h
    rows, cols = np.nonzero(h)
    coeffs = h[rows, cols]
    n_edges = len(rows)
    ch = _bit_probs_to_symbol_probs(soft_bits)       # (96, 64)

    # index permutations: edge value t = h*v.  P(t = x) = P(v = h^{-1}x),
    # so the to-check permutation reads index h^{-1}x and the from-check
    # permutation reads index h*v.
    vals = np.arange(Q)
    hv = gf_mul(coeffs[:, None], vals[None, :])      # h * x
    inv_h = gf_inv(coeffs)
    vh = gf_mul(inv_h[:, None], vals[None, :])       # h^{-1} * x

    m_v2c = np.repeat(ch[cols][None, :, :], 1, axis=0)[0]   # (E, 64)
    for _ in range(iters):
        # --- check nodes: product of WHTs of permuted messages ----------
        perm = np.take_along_axis(m_v2c, vh, axis=1)  # P(t=x) = P(v=h^-1 x)
        w = _wht(perm)
        # per-row product of all edges except self (log-domain for
        # stability: signs + log|.|)
        logw = np.log(np.maximum(np.abs(w), 1e-300))
        sgn = np.sign(w)
        sum_log = np.zeros((h.shape[0], Q))
        prod_sgn = np.ones((h.shape[0], Q))
        np.add.at(sum_log, rows, logw)
        np.multiply.at(prod_sgn, rows, sgn)
        ex_log = sum_log[rows] - logw
        ex_sgn = prod_sgn[rows] * sgn                # sgn^2 = 1 where != 0
        wext = ex_sgn * np.exp(np.clip(ex_log, -600, 600))
        m_c2v_p = _wht(wext) / Q
        m_c2v = np.take_along_axis(m_c2v_p, hv, axis=1)  # P(v=u) = P(t=h u)
        m_c2v = np.maximum(m_c2v, 1e-30)
        m_c2v /= m_c2v.sum(axis=1, keepdims=True)

        # --- variable nodes (log-domain product excluding self) ---------
        logc = np.log(m_c2v)
        sum_v = np.zeros((h.shape[1], Q))
        np.add.at(sum_v, cols, logc)
        post = np.log(np.maximum(ch, 1e-300)) + sum_v        # (96, 64)
        hard = post.argmax(axis=1)
        # early exit on parity satisfaction
        synd = np.zeros(h.shape[0], dtype=np.int64)
        contrib = gf_mul(coeffs, hard[cols])
        np.bitwise_xor.at(synd, rows, contrib)
        if not synd.any():
            return symbols_to_bits(hard)[: h.shape[0] * M_BITS], True
        ex = post[cols] - logc
        ex -= ex.max(axis=1, keepdims=True)
        m_v2c = np.exp(ex)
        m_v2c /= m_v2c.sum(axis=1, keepdims=True)

    hard = post.argmax(axis=1)
    return symbols_to_bits(hard)[: h.shape[0] * M_BITS], False
