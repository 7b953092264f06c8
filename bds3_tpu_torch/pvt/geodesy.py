"""Coordinate conversions and atmospheric/geometry helpers.

Numpy float64 host-side implementations of the classic SoftGNSS geodesy
stack (`Common/`): e_r_corr, topocent (via togeod), tropo (Goad-Goodman),
cart2geo, findUtmZone, cart2utm, and check_t.  These run at fix rate
(Hz), so they stay on host by design (SURVEY.md section 7.2 step 6).
"""
from __future__ import annotations

import cmath
import math

import numpy as np

OMEGA_E = 7.2921151467e-5   # Earth rotation rate [rad/s] (e_r_corr.m)
HALF_WEEK = 302400.0

# (a, finv) per ellipsoid index, cart2geo.m:22-26 ordering
ELLIPSOIDS = [
    (6378388.0, 297.0),        # 1: International
    (6378160.0, 298.247),      # 2: GRS 67
    (6378135.0, 298.26),       # 3: WGS 72
    (6378137.0, 298.257222101),  # 4: GRS 80
    (6378137.0, 298.257223563),  # 5: WGS 84
]


def check_t(time: float) -> float:
    """Half-week crossover correction (`include/check_t.m:19-30`)."""
    t = time
    if t > HALF_WEEK:
        t -= 2 * HALF_WEEK
    elif t < -HALF_WEEK:
        t += 2 * HALF_WEEK
    return t


def e_r_corr(travel_time: float, x_sat: np.ndarray) -> np.ndarray:
    """Rotate satellite ECEF by earth rotation during signal travel
    (`Common/e_r_corr.m:21-32`)."""
    omegatau = 7.292115147e-5 * travel_time  # rad (reference constant)
    c, s = math.cos(omegatau), math.sin(omegatau)
    r = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    return r @ np.asarray(x_sat, dtype=np.float64)


def togeod(a: float, finv: float, x: float, y: float, z: float):
    """ECEF -> geodetic (deg, deg, m), `Common/togeod.m:32-112`."""
    h = 0.0
    esq = 0.0 if finv < 1e-20 else (2 - 1 / finv) / finv
    oneesq = 1 - esq
    p = math.sqrt(x * x + y * y)
    dlambda = math.degrees(math.atan2(y, x)) if p > 1e-20 else 0.0
    if dlambda < 0:
        dlambda += 360.0
    r = math.sqrt(p * p + z * z)
    sinphi = z / r if r > 1e-20 else 0.0
    dphi = math.asin(sinphi)
    if r < 1e-20:
        return 0.0, dlambda, 0.0
    h = r - a * (1 - sinphi * sinphi / finv)
    for _ in range(10):
        sinphi, cosphi = math.sin(dphi), math.cos(dphi)
        n_phi = a / math.sqrt(1 - esq * sinphi * sinphi)
        dp = p - (n_phi + h) * cosphi
        dz = z - (n_phi * oneesq + h) * sinphi
        h += sinphi * dz + cosphi * dp
        dphi += (cosphi * dz - sinphi * dp) / (n_phi + h)
        if dp * dp + dz * dz < 1e-10:
            break
    return math.degrees(dphi), dlambda, h


def topocent(x: np.ndarray, dx: np.ndarray):
    """(az, el, dist) of vector dx from position x
    (`include/topocent.m:24-56`)."""
    dtr = math.pi / 180.0
    phi, lam, _ = togeod(6378137.0, 298.257223563, *np.asarray(x, float)[:3])
    cl, sl = math.cos(lam * dtr), math.sin(lam * dtr)
    cb, sb = math.cos(phi * dtr), math.sin(phi * dtr)
    f = np.array([
        [-sl, -sb * cl, cb * cl],
        [cl, -sb * sl, cb * sl],
        [0.0, cb, sb],
    ])
    local = f.T @ np.asarray(dx, dtype=np.float64)
    e, n, u = local
    hor_dis = math.hypot(e, n)
    if hor_dis < 1e-20:
        az, el = 0.0, 90.0
    else:
        az = math.degrees(math.atan2(e, n))
        el = math.degrees(math.atan2(u, hor_dis))
    if az < 0:
        az += 360.0
    return az, el, float(np.linalg.norm(dx))


def tropo(sinel: float, hsta: float, p: float, tkel: float, hum: float,
          hp: float, htkel: float, hhum: float) -> float:
    """Goad-Goodman tropospheric delay [m] (`Common/tropo.m:34-97`)."""
    a_e = 6378.137
    b0 = 7.839257e-5
    tlapse = -6.5
    tkhum = tkel + tlapse * (hhum - htkel)
    atkel = 7.5 * (tkhum - 273.15) / (237.3 + tkhum - 273.15)
    e0 = 0.0611 * hum * 10**atkel
    tksea = tkel - tlapse * htkel
    em = -978.77 / (2.8704e6 * tlapse * 1.0e-5)
    tkelh = tksea + tlapse * hhum
    e0sea = e0 * (tksea / tkelh) ** (4 * em)
    tkelp = tksea + tlapse * hp
    psea = p * (tksea / tkelp) ** em
    sinel = max(sinel, 0.0)
    result = 0.0
    refsea = 77.624e-6 / tksea
    htop = 1.1385e-5 / refsea
    refsea = refsea * psea
    ref = refsea * ((htop - hsta) / htop) ** 4
    done = False
    while True:
        rtop = (a_e + htop) ** 2 - (a_e + hsta) ** 2 * (1 - sinel**2)
        rtop = math.sqrt(max(rtop, 0.0)) - (a_e + hsta) * sinel
        a = -sinel / (htop - hsta)
        b = -b0 * (1 - sinel**2) / (htop - hsta)
        rn = np.array([rtop ** (i + 2) for i in range(8)])
        alpha = np.array([
            2 * a, 2 * a**2 + 4 * b / 3, a * (a**2 + 3 * b),
            a**4 / 5 + 2.4 * a**2 * b + 1.2 * b**2,
            2 * a * b * (a**2 + 3 * b) / 3,
            b**2 * (6 * a**2 + 4 * b) * 1.428571e-1, 0.0, 0.0,
        ])
        if b * b > 1.0e-35:
            alpha[6] = a * b**3 / 2
            alpha[7] = b**4 / 9
        dr = rtop + float(alpha @ rn)
        result += dr * ref * 1000
        if done:
            return result
        done = True
        refsea = (371900.0e-6 / tksea - 12.92e-6) / tksea
        htop = 1.1385e-5 * (1255 / tksea + 0.05) / refsea
        ref = refsea * e0sea * ((htop - hsta) / htop) ** 4


def cart2geo(x: float, y: float, z: float, i: int = 5):
    """ECEF -> (lat deg, lon deg, h m), iterative (`Common/cart2geo.m`)."""
    a, finv = ELLIPSOIDS[i - 1]
    f = 1.0 / finv
    lam = math.atan2(y, x)
    ex2 = (2 - f) * f / ((1 - f) ** 2)
    c = a * math.sqrt(1 + ex2)
    phi = math.atan(z / (math.hypot(x, y) * (1 - (2 - f) * f)))
    h = 0.1
    oldh = 0.0
    it = 0
    while abs(h - oldh) > 1e-12:
        oldh = h
        n = c / math.sqrt(1 + ex2 * math.cos(phi) ** 2)
        phi = math.atan(z / (math.hypot(x, y) * (1 - (2 - f) * f * n / (n + h))))
        h = math.hypot(x, y) / math.cos(phi) - n
        it += 1
        if it > 100:
            break
    return math.degrees(phi), math.degrees(lam), h


def geo2cart(lat_deg: float, lon_deg: float, h: float, i: int = 5):
    """Geodetic -> ECEF [m] (inverse of cart2geo; the reference carries
    this as `Common/geo2cart.m`)."""
    a, finv = ELLIPSOIDS[i - 1]
    f = 1.0 / finv
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    e2 = (2 - f) * f
    n = a / math.sqrt(1 - e2 * math.sin(lat) ** 2)
    x = (n + h) * math.cos(lat) * math.cos(lon)
    y = (n + h) * math.cos(lat) * math.sin(lon)
    z = (n * (1 - e2) + h) * math.sin(lat)
    return np.array([x, y, z])


def deg2dms(deg: float) -> tuple[int, int, float]:
    """Decimal degrees -> (deg, min, sec) (`Common/deg2dms.m` role)."""
    sign = -1 if deg < 0 else 1
    d = abs(deg)
    whole = int(d)
    m = int((d - whole) * 60)
    s = (d - whole - m / 60) * 3600
    return sign * whole, m, s


def find_utm_zone(latitude: float, longitude: float) -> int:
    """UTM zone from lat/lon in degrees (`Common/findUtmZone.m:20-71`)."""
    if longitude > 180 or longitude < -180 or latitude > 84 or latitude < -80:
        raise ValueError("coordinates out of UTM range")
    zone = int((longitude + 180) / 6) + 1
    if 56 <= latitude < 64 and 3 <= longitude < 12:
        zone = 32
    if latitude >= 72:
        if 0 <= longitude < 9:
            zone = 31
        elif 9 <= longitude < 21:
            zone = 33
        elif 21 <= longitude < 33:
            zone = 35
        elif 33 <= longitude < 42:
            zone = 37
    return zone


def geo2utm(lat_deg: float, lon_deg: float, zone: int):
    """Geodetic (WGS84) -> UTM easting/northing [m].

    Standard transverse-Mercator series.  Note: the reference `cart2utm.m`
    converts through the ED50 datum with a fixed translation for historic
    reasons; we use WGS84 directly, so E/N differ from the reference by a
    constant local offset (U and all *relative* position scatter match).
    """
    a = 6378137.0
    f = 1 / 298.257223563
    k0 = 0.9996
    e2 = f * (2 - f)
    ep2 = e2 / (1 - e2)
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    lon0 = math.radians((zone - 30.5) * 6.0)
    n = a / math.sqrt(1 - e2 * math.sin(lat) ** 2)
    t = math.tan(lat) ** 2
    c = ep2 * math.cos(lat) ** 2
    aa = (lon - lon0) * math.cos(lat)
    m = a * (
        (1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256) * lat
        - (3 * e2 / 8 + 3 * e2**2 / 32 + 45 * e2**3 / 1024) * math.sin(2 * lat)
        + (15 * e2**2 / 256 + 45 * e2**3 / 1024) * math.sin(4 * lat)
        - (35 * e2**3 / 3072) * math.sin(6 * lat)
    )
    easting = k0 * n * (
        aa + (1 - t + c) * aa**3 / 6
        + (5 - 18 * t + t**2 + 72 * c - 58 * ep2) * aa**5 / 120
    ) + 500000.0
    northing = k0 * (
        m + n * math.tan(lat) * (
            aa**2 / 2 + (5 - t + 9 * c + 4 * c**2) * aa**4 / 24
            + (61 - 58 * t + t**2 + 600 * c - 330 * ep2) * aa**6 / 720
        )
    )
    if lat_deg < 0:
        northing += 10000000.0
    return easting, northing


def _clenshaw_sin(coef, arg: float) -> float:
    """Clenshaw summation of sum_t coef[t-1]*sin(t*arg)
    (role of `Common/clsin.m:16-26`)."""
    hr1 = hr = 0.0
    ca = 2.0 * math.cos(arg)
    for c in reversed(coef):
        hr, hr1 = c + ca * hr - hr1, hr
    return hr * math.sin(arg)


def _clenshaw_sin_c(coef, zarg: complex) -> complex:
    """Clenshaw summation of sum_t coef[t-1]*sin(t*z) for complex z.

    Same recurrence as `Common/clksin.m:16-42`, which unrolls the real
    and imaginary parts by hand; native complex arithmetic is the
    identical computation (cos/sin of x+iy expand to the cosh/sinh
    products the reference carries explicitly)."""
    h1 = h = 0j
    ca = 2.0 * cmath.cos(zarg)
    for c in reversed(coef):
        h, h1 = c + ca * h - h1, h
    return h * cmath.sin(zarg)


def _gauss_krueger_coeffs(n: float):
    """Ellipsoidal<->spherical trigonometric series in the third
    flattening n (Koenig & Weise expansions; the polynomial forms the
    reference carries only as comments, `Common/cart2utm.m:94-116` —
    evaluated here instead of hard-coding their f=1/297 decimals)."""
    bg = [
        n * (-2 + n * (2 / 3 + n * (4 / 3 + n * (-82 / 45)))),
        n**2 * (5 / 3 + n * (-16 / 15 + n * (-13 / 9))),
        n**3 * (-26 / 15 + n * 34 / 21),
        n**4 * 1237 / 630,
    ]
    gtu = [
        n * (1 / 2 + n * (-2 / 3 + n * (5 / 16 + n * 41 / 180))),
        n**2 * (13 / 48 + n * (-3 / 5 + n * 557 / 1440)),
        n**3 * (61 / 240 + n * (-103 / 140)),
        n**4 * 49561 / 161280,
    ]
    return bg, gtu


def cart2utm_ed50(x: float, y: float, z: float, zone: int):
    """ECEF (ITRF) -> UTM (E, N, U) on the ED50 datum / International
    1924 ellipsoid — exact behavioral parity with the reference's
    `Common/cart2utm.m:48-168` (Kai Borre's Andersson-Poder routine):
    similarity transform to ED50, iterative geodetic conversion, then
    Gauss-Krueger via Clenshaw-summed series.  E/N from this path match
    the reference receiver's plotted coordinates; the WGS84 path below
    differs from it by the (position-dependent, locally constant) datum
    offset."""
    a = 6378388.0
    f = 1.0 / 297.0
    ex2 = (2 - f) * f / ((1 - f) ** 2)
    cc = a * math.sqrt(1 + ex2)

    # ITRF -> ED50 similarity transform (cart2utm.m:54-61)
    alpha = 0.756e-6
    vx, vy, vz = x, y, z - 4.5
    scale = 0.9999988
    v0 = scale * (vx - alpha * vy) + 89.5
    v1 = scale * (alpha * vx + vy) + 93.8
    v2 = scale * vz + 127.6

    lam = math.atan2(v1, v0)
    p = math.hypot(v0, v1)
    n1 = 6395000.0
    b = math.atan2(v2 / ((1 - f) ** 2 * n1), p / n1)
    u, old_u = 0.1, 0.0
    while abs(u - old_u) > 1e-4:
        old_u = u
        n1 = cc / math.sqrt(1 + ex2 * math.cos(b) ** 2)
        b = math.atan2(v2 / ((1 - f) ** 2 * n1 + u), p / (n1 + u))
        u = p / math.cos(b) - n1

    # normalized meridian quadrant (KW p.50)
    m0 = 0.0004
    n = f / (2 - f)
    m = n**2 * (0.25 + n * n / 64)
    q_n = a + (a * (-n - m0 + m * (1 - m0))) / (1 + n)

    e0 = 500000.0
    lon0 = math.radians((zone - 30) * 6 - 3)
    bg, gtu = _gauss_krueger_coeffs(n)

    b_abs = abs(b)
    bg_r = b_abs + _clenshaw_sin(bg, 2 * b_abs)
    lg_r = lam - lon0
    cos_bn = math.cos(bg_r)
    np_ = math.atan2(math.sin(bg_r), math.cos(lg_r) * cos_bn)
    ep_ = math.atanh(math.sin(lg_r) * cos_bn)
    d = _clenshaw_sin_c(gtu, 2 * (np_ + 1j * ep_))
    np_ += d.real
    ep_ += d.imag
    north = q_n * np_
    east = q_n * ep_ + e0
    if b < 0:
        north = -north + 20000000.0
    return east, north, u


def cart2utm(x: float, y: float, z: float, zone: int,
             datum: str = "wgs84"):
    """ECEF -> (E, N, U).  U is ellipsoidal height (see geo2utm note).

    datum="wgs84" (default): direct WGS84 transverse-Mercator.
    datum="ed50": the reference's historic ED50 path (`cart2utm.m`),
    for E/N parity with the reference's navigation plots."""
    if datum == "ed50":
        return cart2utm_ed50(x, y, z, zone)
    lat, lon, h = cart2geo(x, y, z, 5)
    e, n = geo2utm(lat, lon, zone)
    return e, n, h
