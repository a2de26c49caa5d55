"""Coordinate reference system math — closed form, no PROJ (a copy of
``atlite_tpu/gis/crs.py``).

atlite delegates every CRS transform to pyproj/PROJ (a C library; its
gis.py:87-101).  This module implements the projections the pipelines use
as closed-form array math, numpy on the host, or any namespace ``xp``
with numpy's function names (``torch`` through ``TorchNamespace``):

- EPSG:4326/4258  geographic lon/lat (degrees),
- EPSG:3035  ETRS89-extended / LAEA Europe (the exclusion-container
  default, gis.py:381-397) — Snyder's ellipsoidal oblique Lambert
  azimuthal equal-area,
- "cea"     equal-area cylindrical on the ellipsoid (used for basin /
  grid-cell areas, convert.py:1145, cutout.py:539-562),
- EPSG:3857 spherical web-mercator (common raster CRS),
- transverse Mercator (Krüger n^6 series): every UTM zone
  (EPSG:326xx/327xx/258xx), Gauss-Krüger proj4 variants, and
  EPSG:27700 (OSGB36 British National Grid, datum-shifted),
- Lambert conformal conic 2SP: EPSG:3034 (LCC Europe — CORDEX's
  native family), 2154 (Lambert-93), 31370 (Belgian Lambert 72,
  datum-shifted), and +proj=lcc strings,
- polar stereographic: EPSG:3413 (NSIDC Arctic), 3031 (Antarctic),
  and +proj=stere polar strings.

Datum-shifted CRSs go through a 7-parameter Helmert transform
(position-vector, EPSG method 9606) via geocentric coordinates; accuracy
is the published few-meter level of the single parameter sets.

All formulas from J.P. Snyder, "Map Projections — A Working Manual",
USGS PP 1395 (1987), and C.F.F. Karney, "Transverse Mercator with an
accuracy of a few nanometers", J. Geod. 85 (2011).
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

# GRS80 ellipsoid (ETRS89); WGS84 differs by <1e-9 in flattening
A = 6378137.0
E2 = 0.006694380022903416
E = np.sqrt(E2)

# EPSG:3035 parameters
LAEA_LAT0 = np.radians(52.0)
LAEA_LON0 = np.radians(10.0)
LAEA_FE = 4321000.0
LAEA_FN = 3210000.0


def _errstate(xp):
    return (np.errstate(invalid="ignore", divide="ignore")
            if xp is np else nullcontext())


def _q(sinphi, xp=np):
    """Authalic q function (Snyder 3-12)."""
    return (1 - E2) * (
        sinphi / (1 - E2 * sinphi**2)
        - (1 / (2 * E)) * xp.log((1 - E * sinphi) / (1 + E * sinphi))
    )


_QP = _q(1.0)


def _authalic_beta(phi, xp=np):
    return xp.arcsin(xp.clip(_q(xp.sin(phi), xp) / _QP, -1, 1))


def laea_forward(lon, lat, xp=np):
    """lon/lat degrees -> EPSG:3035 x/y meters (Snyder 24-4..24-14).

    All projection functions take ``xp`` (numpy by default) so the same
    closed-form math can run on another array namespace.
    """
    lam = xp.radians(lon)
    phi = xp.radians(lat)
    beta = _authalic_beta(phi, xp)
    beta1 = _authalic_beta(LAEA_LAT0)
    rq = A * np.sqrt(_QP / 2)
    d = A * np.cos(LAEA_LAT0) / (
        np.sqrt(1 - E2 * np.sin(LAEA_LAT0) ** 2) * rq * np.cos(beta1)
    )
    coslam = xp.cos(lam - LAEA_LON0)
    sinlam = xp.sin(lam - LAEA_LON0)
    b = rq * xp.sqrt(
        2 / (1 + np.sin(beta1) * xp.sin(beta) + np.cos(beta1) * xp.cos(beta) * coslam)
    )
    x = b * d * xp.cos(beta) * sinlam + LAEA_FE
    y = (b / d) * (
        np.cos(beta1) * xp.sin(beta) - np.sin(beta1) * xp.cos(beta) * coslam
    ) + LAEA_FN
    return x, y


def laea_inverse(x, y, xp=np):
    """EPSG:3035 x/y meters -> lon/lat degrees (Snyder 24-15..24-21, 3-18)."""
    dtype = float if xp is np else None
    x = xp.asarray(x, dtype=dtype) - LAEA_FE
    y = xp.asarray(y, dtype=dtype) - LAEA_FN
    beta1 = _authalic_beta(LAEA_LAT0)
    rq = A * np.sqrt(_QP / 2)
    d = A * np.cos(LAEA_LAT0) / (
        np.sqrt(1 - E2 * np.sin(LAEA_LAT0) ** 2) * rq * np.cos(beta1)
    )
    rho = xp.sqrt((x / d) ** 2 + (d * y) ** 2)
    ce = 2 * xp.arcsin(xp.clip(rho / (2 * rq), -1, 1))
    with _errstate(xp):
        beta = xp.arcsin(
            xp.clip(
                np.sin(beta1) * xp.cos(ce) + (d * y * xp.sin(ce) * np.cos(beta1)) / rho,
                -1, 1,
            )
        )
        lam = LAEA_LON0 + xp.arctan2(
            x * xp.sin(ce),
            d * rho * np.cos(beta1) * xp.cos(ce) - d**2 * y * np.sin(beta1) * xp.sin(ce),
        )
    beta = xp.where(rho == 0, beta1, beta)
    lam = xp.where(rho == 0, LAEA_LON0, lam)
    phi = _authalic_to_geodetic(beta, E2, xp)
    return xp.degrees(lam), xp.degrees(phi)


def cea_forward(lon, lat, xp=np):
    """Ellipsoidal cylindrical equal-area, std parallel 0 (Snyder 10-1/10-2):
    x = a*lam ; y = a*q/2.  Areas on this plane equal true ellipsoid area."""
    lam = xp.radians(lon)
    phi = xp.radians(lat)
    return A * lam, A * _q(xp.sin(phi), xp) / 2


def cea_inverse(x, y, xp=np):
    beta = xp.arcsin(xp.clip(2 * xp.asarray(y) / (A * _QP), -1, 1))
    phi = _authalic_to_geodetic(beta, E2, xp)
    return xp.degrees(xp.asarray(x) / A), xp.degrees(phi)


def make_cea(lat_ts=0.0, lon0=0.0, fe=0.0, fn=0.0, ellps="grs80"):
    """Parameterized ellipsoidal cylindrical equal-area (Snyder 10-1/10-2
    with a standard parallel): x = a*k0*(lam-lam0)+fe, y = a*q/(2*k0)+fn,
    k0 = cos(phi_s)/sqrt(1 - e^2 sin^2 phi_s).  EASE-Grid-family CRSs
    carry +lat_ts; dropping it puts coordinates hundreds of km off
    (pinned vs cs2cs in tests/test_crs_proj_goldens.py)."""
    a, _f, e2, e = _ellps(ellps)
    phi_s = np.radians(lat_ts)
    k0 = float(np.cos(phi_s) / np.sqrt(1.0 - e2 * np.sin(phi_s) ** 2))
    qp = float((1 - e2) * (1 / (1 - e2)
                           - (1 / (2 * e)) * np.log((1 - e) / (1 + e))))

    def q_of(sinphi, xp):
        return (1 - e2) * (
            sinphi / (1 - e2 * sinphi**2)
            - (1 / (2 * e)) * xp.log((1 - e * sinphi) / (1 + e * sinphi))
        )

    def fwd(lon, lat, xp=np):
        lam = xp.radians(xp.asarray(lon) - lon0)
        phi = xp.radians(lat)
        return (a * k0 * lam + fe,
                a * q_of(xp.sin(phi), xp) / (2 * k0) + fn)

    def inv(x, y, xp=np):
        beta = xp.arcsin(xp.clip(2 * k0 * (xp.asarray(y) - fn) / (a * qp),
                                 -1, 1))
        phi = _authalic_to_geodetic(beta, e2, xp)
        lon = lon0 + xp.degrees((xp.asarray(x) - fe) / (a * k0))
        return lon, xp.degrees(phi)

    return fwd, inv


def _authalic_to_geodetic(beta, e2, xp):
    """Authalic -> geodetic latitude series (Snyder 3-18)."""
    return beta + (
        (e2 / 3 + 31 * e2**2 / 180 + 517 * e2**3 / 5040) * xp.sin(2 * beta)
        + (23 * e2**2 / 360 + 251 * e2**3 / 3780) * xp.sin(4 * beta)
        + (761 * e2**3 / 45360) * xp.sin(6 * beta)
    )


def mercator_forward(lon, lat, xp=np):
    """EPSG:3857 spherical web mercator."""
    r = 6378137.0
    x = r * xp.radians(lon)
    y = r * xp.log(xp.tan(np.pi / 4 + xp.radians(lat) / 2))
    return x, y


def mercator_inverse(x, y, xp=np):
    r = 6378137.0
    lon = xp.degrees(xp.asarray(x) / r)
    lat = xp.degrees(2 * xp.arctan(xp.exp(xp.asarray(y) / r)) - np.pi / 2)
    return lon, lat


# ---------------------------------------------------------------------------
# Ellipsoids + datum shifts (Helmert 7-parameter, EPSG method 9606
# position-vector convention).  The reference delegates datum handling to
# PROJ (gis.py:87-101); here the handful of datums that common European
# exclusion rasters ship in are closed-form.  Accuracy of the single
# Helmert set is the published few-meter level (vs PROJ grid shifts) —
# far below the ~100 m exclusion-raster resolution this feeds.
# ---------------------------------------------------------------------------
ELLIPSOIDS = {
    # name -> (semi-major axis a [m], flattening f)
    "grs80": (6378137.0, 1 / 298.257222101),
    "wgs84": (6378137.0, 1 / 298.257223563),
    "airy": (6377563.396, 1 / 299.3249646),       # OSGB36
    "intl": (6378388.0, 1 / 297.0),               # International 1924 (BD72)
    "clrk66": (6378206.4, 1 / 294.978698214),     # Clarke 1866
    "bessel": (6377397.155, 1 / 299.1528128),     # DHDN Gauss-Krueger
    "krass": (6378245.0, 1 / 298.3),              # Krassowsky 1940
}

# datum -> (ellipsoid, Helmert WGS84 -> datum: tx, ty, tz [m],
#           rx, ry, rz [arc-sec, position-vector], ds [ppm])
DATUMS = {
    "osgb36": ("airy", (-446.448, 125.157, -542.060,
                        -0.1502, -0.2470, -0.8421, 20.4894)),
    # published set is BD72->WGS84 (-106.8686, +52.2978, -103.7239, ...,
    # -1.2747); stored here in this table's WGS84->BD72 direction
    # (translations/scale negated) — verified vs cs2cs to ~1 mm
    "bd72": ("intl", (106.8686, -52.2978, 103.7239,
                      -0.3366, 0.4570, -1.8422, 1.2747)),
    # DHDN (+datum=potsdam): published DHDN->WGS84 position-vector set
    # (598.1, 73.7, 418.2, 0.202", 0.045", -2.455", 6.7 ppm), negated to
    # this table's WGS84->datum direction — verified vs cs2cs
    "dhdn": ("bessel", (-598.1, -73.7, -418.2,
                        -0.202, -0.045, 2.455, -6.7)),
}


def _ellps(name):
    a, f = ELLIPSOIDS[name]
    e2 = f * (2 - f)
    return a, f, e2, np.sqrt(e2)


def _geodetic_to_geocentric(lon, lat, a, e2, xp):
    lam, phi = xp.radians(lon), xp.radians(lat)
    sinphi = xp.sin(phi)
    nu = a / xp.sqrt(1 - e2 * sinphi**2)
    x = nu * xp.cos(phi) * xp.cos(lam)
    y = nu * xp.cos(phi) * xp.sin(lam)
    z = nu * (1 - e2) * sinphi
    return x, y, z


def _geocentric_to_geodetic(x, y, z, a, e2, xp):
    lam = xp.arctan2(y, x)
    p = xp.sqrt(x**2 + y**2)
    # Bowring start + fixed-count iteration (lowers under jit)
    b = a * np.sqrt(1 - e2)
    ep2 = e2 / (1 - e2)
    theta = xp.arctan2(z * a, p * b)
    phi = xp.arctan2(z + ep2 * b * xp.sin(theta) ** 3,
                     p - e2 * a * xp.cos(theta) ** 3)
    for _ in range(3):
        sinphi = xp.sin(phi)
        nu = a / xp.sqrt(1 - e2 * sinphi**2)
        phi = xp.arctan2(z + e2 * nu * sinphi, p)
    return xp.degrees(lam), xp.degrees(phi)


def _helmert_apply(x, y, z, params, inverse, xp):
    tx, ty, tz, rx, ry, rz, ds = params
    s = 1.0 + ds * 1e-6
    arc = np.pi / (180.0 * 3600.0)
    rx, ry, rz = rx * arc, ry * arc, rz * arc
    if not inverse:
        x2 = tx + s * (x - rz * y + ry * z)
        y2 = ty + s * (rz * x + y - rx * z)
        z2 = tz + s * (-ry * x + rx * y + z)
        return x2, y2, z2
    # first-order inverse of the first-order forward — consistent with
    # the few-meter parameter accuracy
    x, y, z = (x - tx) / s, (y - ty) / s, (z - tz) / s
    x2 = x + rz * y - ry * z
    y2 = -rz * x + y + rx * z
    z2 = ry * x - rx * y + z
    return x2, y2, z2


def _datum_shift(lon, lat, datum, to_datum, xp):
    """WGS84 lon/lat -> datum lon/lat (to_datum=True) or back."""
    ellps_name, params = DATUMS[datum]
    a_d, _, e2_d, _ = _ellps(ellps_name)
    a_w, _, e2_w, _ = _ellps("wgs84")
    if to_datum:
        gx, gy, gz = _geodetic_to_geocentric(lon, lat, a_w, e2_w, xp)
        gx, gy, gz = _helmert_apply(gx, gy, gz, params, inverse=False, xp=xp)
        return _geocentric_to_geodetic(gx, gy, gz, a_d, e2_d, xp)
    gx, gy, gz = _geodetic_to_geocentric(lon, lat, a_d, e2_d, xp)
    gx, gy, gz = _helmert_apply(gx, gy, gz, params, inverse=True, xp=xp)
    return _geocentric_to_geodetic(gx, gy, gz, a_w, e2_w, xp)


def _with_datum(fwd, inv, datum):
    """Wrap a projection pair so its geographic side is a shifted datum."""
    if datum is None:
        return fwd, inv

    def fwd_d(lon, lat, xp=np):
        lon, lat = _datum_shift(lon, lat, datum, to_datum=True, xp=xp)
        return fwd(lon, lat, xp)

    def inv_d(x, y, xp=np):
        lon, lat = inv(x, y, xp)
        return _datum_shift(lon, lat, datum, to_datum=False, xp=xp)

    return fwd_d, inv_d


# ---------------------------------------------------------------------------
# Lambert conformal conic, 2 standard parallels (Snyder 15-1..15-11,
# ellipsoidal) — CORDEX's native grid and the LCC national grids
# (reference handles these through pyproj: atlite/gis.py:87-101,
# atlite/datasets/cordex.py).
# ---------------------------------------------------------------------------
def _conformal_t(phi, e, xp):
    sinphi = xp.sin(phi)
    return (xp.tan(np.pi / 4 - phi / 2)
            / ((1 - e * sinphi) / (1 + e * sinphi)) ** (e / 2))



def _phi_from_t(t, e, xp):
    """Fixed-point iteration for the conformal latitude inverse phi(t)
    (Snyder 7-9); 8 rounds reach f64 round-off.  Shared by the LCC and
    polar-stereographic inverses."""
    phi = np.pi / 2 - 2 * xp.arctan(t)
    for _ in range(8):
        sinphi = xp.sin(phi)
        phi = np.pi / 2 - 2 * xp.arctan(
            t * ((1 - e * sinphi) / (1 + e * sinphi)) ** (e / 2))
    return phi

def make_lcc(lat1, lat2, lat0, lon0, fe=0.0, fn=0.0, ellps="grs80",
             datum=None):
    """Build an LCC-2SP (forward, inverse) pair."""
    a, _, e2, e = _ellps(ellps)
    p1, p2, p0 = np.radians([lat1, lat2, lat0])

    def _m(phi):
        return np.cos(phi) / np.sqrt(1 - e2 * np.sin(phi) ** 2)

    t1, t2, t0 = (_conformal_t(p, e, np) for p in (p1, p2, p0))
    m1, m2 = _m(p1), _m(p2)
    n = (np.log(m1) - np.log(m2)) / (np.log(t1) - np.log(t2)) \
        if abs(lat1 - lat2) > 1e-12 else np.sin(p1)
    F = m1 / (n * t1**n)
    rho0 = a * F * t0**n

    def fwd(lon, lat, xp=np):
        phi = xp.radians(xp.asarray(lat, dtype=float))
        lam = xp.radians(xp.asarray(lon, dtype=float) - lon0)
        t = _conformal_t(phi, e, xp)
        rho = a * F * t**n
        theta = n * lam
        return (fe + rho * xp.sin(theta),
                fn + rho0 - rho * xp.cos(theta))

    def inv(x, y, xp=np):
        xs = xp.asarray(x, dtype=float) - fe
        ys = rho0 - (xp.asarray(y, dtype=float) - fn)
        sign = 1.0 if n >= 0 else -1.0
        rho = sign * xp.sqrt(xs**2 + ys**2)
        theta = xp.arctan2(sign * xs, sign * ys)
        t = (rho / (a * F)) ** (1.0 / n)
        phi = _phi_from_t(t, e, xp)
        return xp.degrees(theta / n) + lon0, xp.degrees(phi)

    return _with_datum(fwd, inv, datum)


# ---------------------------------------------------------------------------
# Polar stereographic, variant B (Snyder 21-32..21-41, ellipsoidal) —
# EPSG:3413 (NSIDC Arctic sea-ice grids), EPSG:3031 (Antarctic).
# ---------------------------------------------------------------------------
def make_polar_stereo(lat_ts, lon0, fe=0.0, fn=0.0, south=False,
                      ellps="wgs84", datum=None, k0=1.0):
    a, _, e2, e = _ellps(ellps)
    if abs(lat_ts) >= 90.0 - 1e-9:
        # variant A (scale given at the pole): the m_c/t_c ratio limit
        # (Snyder 21-33 with 21-39) — the generic formula is 0/0 there
        k = 2.0 * a * k0 / np.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e))
    else:
        pts = np.radians(abs(lat_ts))
        t_c = _conformal_t(pts, e, np)
        m_c = np.cos(pts) / np.sqrt(1 - e2 * np.sin(pts) ** 2)
        k = a * m_c / t_c  # rho = k * t

    def fwd(lon, lat, xp=np):
        phi = xp.radians(xp.asarray(lat, dtype=float))
        lam = xp.radians(xp.asarray(lon, dtype=float) - lon0)
        # south aspect (EPSG 9829): t uses -phi and northing flips sign
        t = _conformal_t(-phi if south else phi, e, xp)
        rho = k * t
        x = rho * xp.sin(lam)
        y = rho * xp.cos(lam) if south else -rho * xp.cos(lam)
        return fe + x, fn + y

    def inv(x, y, xp=np):
        xs = xp.asarray(x, dtype=float) - fe
        ys = xp.asarray(y, dtype=float) - fn
        rho = xp.sqrt(xs**2 + ys**2)
        t = rho / k
        phi = _phi_from_t(t, e, xp)
        lam = xp.arctan2(xs, ys) if south else xp.arctan2(xs, -ys)
        return xp.degrees(lam) + lon0, xp.degrees(-phi if south else phi)

    return _with_datum(fwd, inv, datum)


# ---------------------------------------------------------------------------
# Rotated-pole lon/lat (CF "rotated_latitude_longitude") — the native
# grid of CORDEX regional climate models (the reference's dead cordex
# module reads these through pyproj/cf-conventions,
# atlite/datasets/cordex.py).  The "projected"
# coordinates are rotated longitudes/latitudes in degrees; the rotated
# system's north pole sits at true (pole_lon, pole_lat), and the rotated
# origin (0, 0) lies at true (pole_lon + 180, 90 - pole_lat).
# Spherical rotation (CF convention); exact on the sphere.
# ---------------------------------------------------------------------------
def make_rotated_pole(pole_lon, pole_lat, lon_0=0.0):
    sp_ = np.sin(np.radians(pole_lat))
    cp_ = np.cos(np.radians(pole_lat))

    def fwd(lon, lat, xp=np):  # true lon/lat -> rotated lon/lat
        lam = xp.radians(xp.asarray(lon, dtype=float) - pole_lon - 180.0)
        phi = xp.radians(xp.asarray(lat, dtype=float))
        x1 = xp.cos(phi) * xp.cos(lam)
        y1 = xp.cos(phi) * xp.sin(lam)
        z1 = xp.sin(phi)
        x2 = x1 * sp_ + z1 * cp_
        z2 = -x1 * cp_ + z1 * sp_
        # PROJ ob_tran / CF north_pole_grid_longitude ADD the third
        # angle on the rotated side (verified vs `cct +proj=ob_tran`)
        rlon = xp.degrees(xp.arctan2(y1, x2)) + lon_0
        rlat = xp.degrees(xp.arcsin(xp.clip(z2, -1.0, 1.0)))
        return rlon, rlat

    def inv(rlon, rlat, xp=np):  # rotated lon/lat -> true lon/lat
        lam = xp.radians(xp.asarray(rlon, dtype=float) - lon_0)
        phi = xp.radians(xp.asarray(rlat, dtype=float))
        xr = xp.cos(phi) * xp.cos(lam)
        yr = xp.cos(phi) * xp.sin(lam)
        zr = xp.sin(phi)
        x1 = xr * sp_ - zr * cp_
        z1 = xr * cp_ + zr * sp_
        lat = xp.degrees(xp.arcsin(xp.clip(z1, -1.0, 1.0)))
        lon = xp.degrees(xp.arctan2(yr, x1)) + pole_lon + 180.0
        lon = xp.where(lon > 180.0, lon - 360.0, lon)
        lon = xp.where(lon < -180.0, lon + 360.0, lon)
        return lon, lat

    return fwd, inv


# ---------------------------------------------------------------------------
# Transverse Mercator (Krüger n-series, 6th order — Karney, "Transverse
# Mercator with an accuracy of a few nanometers", J. Geod. 85 (2011)).
# Covers every UTM zone: EPSG:326xx/327xx (WGS84 N/S), EPSG:258xx (ETRS89),
# and arbitrary lon0/k0/FE/FN Gauss-Krüger variants — the projections that
# land-use exclusion rasters most commonly ship in (reference delegates
# these to pyproj, gis.py:87-101).
# ---------------------------------------------------------------------------
def _tm_series(ellps="grs80"):
    """Krüger series coefficients in n (Karney 2011 eqs. 14, 35-36),
    order n^6, for any registered ellipsoid."""
    if ellps in _TM_CACHE:
        return _TM_CACHE[ellps]
    a, f, e2, e = _ellps(ellps)
    n = f / (2 - f)
    alpha = (
        n / 2 - 2 * n**2 / 3 + 5 * n**3 / 16 + 41 * n**4 / 180
        - 127 * n**5 / 288 + 7891 * n**6 / 37800,
        13 * n**2 / 48 - 3 * n**3 / 5 + 557 * n**4 / 1440 + 281 * n**5 / 630
        - 1983433 * n**6 / 1935360,
        61 * n**3 / 240 - 103 * n**4 / 140 + 15061 * n**5 / 26880
        + 167603 * n**6 / 181440,
        49561 * n**4 / 161280 - 179 * n**5 / 168 + 6601661 * n**6 / 7257600,
        34729 * n**5 / 80640 - 3418889 * n**6 / 1995840,
        212378941 * n**6 / 319334400,
    )
    beta = (
        n / 2 - 2 * n**2 / 3 + 37 * n**3 / 96 - n**4 / 360
        - 81 * n**5 / 512 + 96199 * n**6 / 604800,
        n**2 / 48 + n**3 / 15 - 437 * n**4 / 1440 + 46 * n**5 / 105
        - 1118711 * n**6 / 3870720,
        17 * n**3 / 480 - 37 * n**4 / 840 - 209 * n**5 / 4480
        + 5569 * n**6 / 90720,
        4397 * n**4 / 161280 - 11 * n**5 / 504 - 830251 * n**6 / 7257600,
        4583 * n**5 / 161280 - 108847 * n**6 / 3991680,
        20648693 * n**6 / 638668800,
    )
    a1 = a / (1 + n) * (1 + n**2 / 4 + n**4 / 64 + n**6 / 256)  # Karney 14
    _TM_CACHE[ellps] = (alpha, beta, a1, e, e2)
    return _TM_CACHE[ellps]


_TM_CACHE = {}


def tmerc_forward(lon, lat, lon0, k0=0.9996, fe=500000.0, fn=0.0, xp=np,
                  ellps="grs80"):
    """Ellipsoidal transverse Mercator forward (Karney 2011 eqs. 7-11)."""
    alpha, _, a1, e_, e2_ = _tm_series(ellps)
    lam = xp.radians(xp.asarray(lon, dtype=float) - lon0)
    phi = xp.radians(xp.asarray(lat, dtype=float))
    # conformal latitude via tau' (Karney eq. 7)
    tau = xp.tan(phi)
    sigma = xp.sinh(e_ * xp.arctanh(e_ * tau / xp.sqrt(1 + tau**2)))
    taup = tau * xp.sqrt(1 + sigma**2) - sigma * xp.sqrt(1 + tau**2)
    xi_p = xp.arctan2(taup, xp.cos(lam))
    eta_p = xp.arcsinh(xp.sin(lam) / xp.sqrt(taup**2 + xp.cos(lam) ** 2))
    xi, eta = xi_p, eta_p
    for j, a_j in enumerate(alpha, start=1):
        xi = xi + a_j * xp.sin(2 * j * xi_p) * xp.cosh(2 * j * eta_p)
        eta = eta + a_j * xp.cos(2 * j * xi_p) * xp.sinh(2 * j * eta_p)
    return k0 * a1 * eta + fe, k0 * a1 * xi + fn


def tmerc_inverse(x, y, lon0, k0=0.9996, fe=500000.0, fn=0.0, xp=np,
                  ellps="grs80"):
    """Ellipsoidal transverse Mercator inverse (Karney 2011 eqs. 19-22;
    fixed-count Newton iteration on tau so it lowers under jit)."""
    _, beta, a1, e_, e2_ = _tm_series(ellps)
    xi = (xp.asarray(y, dtype=float) - fn) / (k0 * a1)
    eta = (xp.asarray(x, dtype=float) - fe) / (k0 * a1)
    xi_p, eta_p = xi, eta
    for j, b_j in enumerate(beta, start=1):
        xi_p = xi_p - b_j * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
        eta_p = eta_p - b_j * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)
    taup = xp.sin(xi_p) / xp.sqrt(xp.sinh(eta_p) ** 2 + xp.cos(xi_p) ** 2)
    lam = xp.arctan2(xp.sinh(eta_p), xp.cos(xi_p))
    # invert tau'(tau) by Newton (Karney eq. 20-21); 5 iterations reach
    # f64 round-off for |lat| <= 89.9
    tau = taup
    for _ in range(5):
        sigma = xp.sinh(e_ * xp.arctanh(e_ * tau / xp.sqrt(1 + tau**2)))
        taup_i = tau * xp.sqrt(1 + sigma**2) - sigma * xp.sqrt(1 + tau**2)
        dtaup = (xp.sqrt((1 + sigma**2) * (1 + tau**2)) - sigma * tau) \
            * (1 - e2_) * xp.sqrt(1 + tau**2) / (1 + (1 - e2_) * tau**2)
        tau = tau + (taup - taup_i) / dtaup
    phi = xp.arctan(tau)
    return xp.degrees(lam) + lon0, xp.degrees(phi)



def _utm_params(epsg):
    """EPSG UTM code -> (lon0_deg, k0, false_easting, false_northing).

    326xx = WGS84 north, 327xx = WGS84 south, 258xx = ETRS89 north
    (zones 28-38). Zone z central meridian: 6*z - 183."""
    if 32601 <= epsg <= 32660:
        return 6.0 * (epsg - 32600) - 183.0, 0.9996, 500000.0, 0.0
    if 32701 <= epsg <= 32760:
        return 6.0 * (epsg - 32700) - 183.0, 0.9996, 500000.0, 10000000.0
    if 25828 <= epsg <= 25838:
        return 6.0 * (epsg - 25800) - 183.0, 0.9996, 500000.0, 0.0
    return None


def _make_tmerc(lon0, k0, fe, fn, lat0=0.0, ellps="grs80", datum=None):
    fn_eff = fn
    if lat0:
        # natural-origin latitude: subtract the scaled meridian arc to
        # lat0 (computed through the same Krüger series at lam=0)
        _, m0 = tmerc_forward(lon0, lat0, lon0, k0, 0.0, 0.0, np, ellps)
        fn_eff = fn - float(m0)

    def fwd(lon, lat, xp=np):
        return tmerc_forward(lon, lat, lon0, k0, fe, fn_eff, xp, ellps)

    def inv(x, y, xp=np):
        return tmerc_inverse(x, y, lon0, k0, fe, fn_eff, xp, ellps)

    return _with_datum(fwd, inv, datum)


# EPSG codes beyond the parametric UTM families: (factory, kwargs).
# Parameters from the EPSG registry entries for each code.
_EPSG_TABLE = {
    # ETRS89-extended / LCC Europe
    3034: lambda: make_lcc(35.0, 65.0, 52.0, 10.0, 4000000.0, 2800000.0,
                           ellps="grs80"),
    # RGF93 v1 / Lambert-93 (France)
    2154: lambda: make_lcc(44.0, 49.0, 46.5, 3.0, 700000.0, 6600000.0,
                           ellps="grs80"),
    # BD72 / Belgian Lambert 72 (datum-shifted, Intl 1924)
    31370: lambda: make_lcc(51 + 10 / 60 + 0.00204 / 3600,
                            49 + 50 / 60 + 0.00204 / 3600,
                            90.0, 4 + 22 / 60 + 2.952 / 3600,
                            150000.013, 5400088.438,
                            ellps="intl", datum="bd72"),
    # OSGB36 / British National Grid (datum-shifted, Airy 1830)
    27700: lambda: _make_tmerc(-2.0, 0.9996012717, 400000.0, -100000.0,
                               lat0=49.0, ellps="airy", datum="osgb36"),
    # WGS84 / NSIDC Sea Ice Polar Stereographic North
    3413: lambda: make_polar_stereo(70.0, -45.0, ellps="wgs84"),
    # WGS84 / Antarctic Polar Stereographic
    3031: lambda: make_polar_stereo(-71.0, 0.0, south=True, ellps="wgs84"),
}


_FORWARD = {4326: None, 4258: None,  # 4258 = ETRS89 geographic ≡ lon/lat
            3035: laea_forward, "cea": cea_forward, 3857: mercator_forward}
_INVERSE = {4326: None, 4258: None,
            3035: laea_inverse, "cea": cea_inverse, 3857: mercator_inverse}


def register_projection(key, forward, inverse):
    """Register a custom projection pair.  ``forward(lon, lat, xp=np)``
    must map EPSG:4326 degrees to projected coordinates and ``inverse``
    back; ``xp`` receives numpy or another namespace with numpy's
    function names (for a later device path).  This is the one-function-per-projection
    dispatch that replaces the reference's blanket pyproj dependency."""
    _FORWARD[key] = forward
    _INVERSE[key] = inverse


def _resolve(key):
    """Lazily materialize parameterized projection families (UTM zones,
    EPSG-table codes, proj4-derived tmerc/lcc/stere keys)."""
    if key in _FORWARD:
        return True
    if isinstance(key, int):
        utm = _utm_params(key)
        if utm is not None:
            fwd, inv = _make_tmerc(*utm)
            register_projection(key, fwd, inv)
            return True
        if key in _EPSG_TABLE:
            fwd, inv = _EPSG_TABLE[key]()
            register_projection(key, fwd, inv)
            return True
    if isinstance(key, tuple) and key:
        if key[0] == "cea":
            *cea_params, cea_datum = key[1:]
            fwd, inv = make_cea(*cea_params)
            if cea_datum is not None:
                fwd, inv = _with_datum(fwd, inv, cea_datum)
        elif key[0] == "tmerc":
            fwd, inv = _make_tmerc(*key[1:])
        elif key[0] == "lcc":
            fwd, inv = make_lcc(*key[1:])
        elif key[0] == "rotpole":
            fwd, inv = make_rotated_pole(*key[1:])
        elif key[0] == "stere":
            lat_ts, south, k0, lon0, fe, fn, ellps, datum = key[1:]
            fwd, inv = make_polar_stereo(lat_ts, lon0, fe, fn,
                                         south=south, ellps=ellps, k0=k0,
                                         datum=datum)
        else:
            return False
        register_projection(key, fwd, inv)
        return True
    return False


def normalize_crs(crs):
    """Accept ints, 'EPSG:xxxx' strings, {'proj': 'cea'} dicts, and
    proj4-style '+proj=utm +zone=NN [+south]' / '+proj=tmerc ...' strings
    (normalized to a ('tmerc', lon0, k0, fe, fn, lat0, ellps, datum)
    key; lcc/stere/rotpole strings get analogous parameter keys)."""
    if crs is None:
        return 4326
    if isinstance(crs, tuple):
        return crs  # already a parameterized projection key
    if isinstance(crs, dict):
        if "grid_north_pole_longitude" in crs:  # CF rotated-pole attrs
            return ("rotpole", float(crs["grid_north_pole_longitude"]),
                    float(crs["grid_north_pole_latitude"]),
                    float(crs.get("north_pole_grid_longitude", 0.0)))
        if crs.get("proj") in ("cea", "utm", "tmerc", "lcc", "stere",
                               "ob_tran"):
            return _proj_dict_key(crs)
        raise ValueError(f"unsupported proj dict {crs}")
    if isinstance(crs, str):
        s = crs.lower().replace("epsg:", "")
        if s == "cea":
            return "cea"
        if any(f"proj={p}" in s
               for p in ("cea", "utm", "tmerc", "lcc", "stere", "ob_tran")):
            return _proj_dict_key(_parse_proj4(s))
        if "proj=" in s:
            # out-of-family proj4 string: opaque key served by the system
            # PROJ host fallback (the reference accepts ANY pyproj CRS,
            # gis.py:87-101; device paths still require a native family)
            return ("proj4", " ".join(crs.split()))
        return int(s)
    if hasattr(crs, "to_epsg"):
        return crs.to_epsg()
    return int(crs)


def _parse_proj4(s):
    d = {}
    for tok in s.split():
        tok = tok.lstrip("+")
        if "=" in tok:
            k, v = tok.split("=", 1)
            d[k] = v
        else:
            d[tok] = True
    return d


_PROJ4_ELLPS = {"grs80": "grs80", "wgs84": "wgs84", "airy": "airy",
                "intl": "intl", "clrk66": "clrk66", "bessel": "bessel",
                "krass": "krass"}

# proj4 +datum= -> (datum-shift table entry or None, implied ellipsoid).
# WGS84/NAD83 need no Helmert shift at this table's few-meter accuracy.
_PROJ4_DATUMS = {"wgs84": (None, "wgs84"), "nad83": (None, "grs80"),
                 "osgb36": ("osgb36", "airy"), "potsdam": ("dhdn", "bessel")}


def _proj_dict_key(d):
    proj = d.get("proj")
    datum = None
    ellps = None
    if "datum" in d:
        dn = str(d["datum"]).lower()
        if dn not in _PROJ4_DATUMS:
            raise ValueError(
                f"unsupported proj4 +datum={d['datum']} (supported: "
                f"{sorted(_PROJ4_DATUMS)}); pass +ellps/+towgs84 explicitly")
        datum, ellps = _PROJ4_DATUMS[dn]
    if "ellps" in d:
        en = str(d["ellps"]).lower()
        if en not in _PROJ4_ELLPS:
            # silently defaulting to grs80 put bessel/krass grids
            # hundreds of meters off — refuse instead
            raise ValueError(f"unsupported proj4 +ellps={d['ellps']} "
                             f"(supported: {sorted(_PROJ4_ELLPS)})")
        ellps = _PROJ4_ELLPS[en]
    ellps = ellps or "grs80"
    if proj == "cea":
        lat_ts = float(d.get("lat_ts", 0.0))
        lon0 = float(d.get("lon_0", 0.0))
        fe = float(d.get("x_0", 0.0))
        fn = float(d.get("y_0", 0.0))
        if (lat_ts, lon0, fe, fn) == (0.0, 0.0, 0.0, 0.0) \
                and ellps == "grs80" and datum is None:
            return "cea"  # the default basin-area key
        # EASE-Grid-family CRSs carry +lat_ts — dropping it shifts
        # coordinates by hundreds of km; the datum must travel too
        return ("cea", lat_ts, lon0, fe, fn, ellps, datum)
    if proj == "utm":
        zone = int(d["zone"])
        south = bool(d.get("south", False))
        return ("tmerc", 6.0 * zone - 183.0, 0.9996, 500000.0,
                10000000.0 if south else 0.0, 0.0, ellps, datum)
    if proj == "lcc":
        lat1 = float(d.get("lat_1", 0.0))
        return ("lcc", lat1, float(d.get("lat_2", lat1)),
                float(d.get("lat_0", 0.0)), float(d.get("lon_0", 0.0)),
                float(d.get("x_0", 0.0)), float(d.get("y_0", 0.0)), ellps,
                datum)
    if proj == "ob_tran":
        if str(d.get("o_proj", "")).lower() not in ("longlat", "latlon", "lonlat"):
            raise ValueError("only +proj=ob_tran +o_proj=longlat (rotated "
                             "pole) is supported")
        # PROJ convention: o_lat_p is the pole latitude and lon_0 is the
        # pole longitude + 180 (coordinates treated as degrees, CF-style)
        pole_lat = float(d.get("o_lat_p", 90.0))
        pole_lon = float(d.get("lon_0", 180.0)) - 180.0
        return ("rotpole", pole_lon, pole_lat, float(d.get("o_lon_p", 0.0)))
    if proj == "stere":
        lat0 = float(d.get("lat_0", 90.0))
        if lat0 not in (90.0, -90.0):
            raise ValueError("only polar stereographic (+lat_0=+-90) is supported")
        # hemisphere comes from lat_0's sign; lat_ts defaults to the pole
        # (variant A, scale +k_0 there — the ratio's limit form applies)
        lat_ts = abs(float(d.get("lat_ts", lat0)))
        k0 = float(d.get("k_0", d.get("k", 1.0)))
        return ("stere", lat_ts, lat0 < 0, k0,
                float(d.get("lon_0", 0.0)),
                float(d.get("x_0", 0.0)), float(d.get("y_0", 0.0)), ellps,
                datum)
    # generic tmerc / Gauss-Krueger: keep lat_0 and the parsed ellipsoid
    # (dropping them silently shifted OSGB-style strings by ~5400 km)
    return ("tmerc", float(d.get("lon_0", 0.0)), float(d.get("k_0", d.get("k", 1.0))),
            float(d.get("x_0", 0.0)), float(d.get("y_0", 0.0)),
            float(d.get("lat_0", 0.0)), ellps, datum)


# ---------------------------------------------------------------------------
# system-PROJ host fallback (general CRSs)
# ---------------------------------------------------------------------------
# The reference handles ANY pyproj CRS (atlite/gis.py:87-101).
# CRSs outside the native closed-form families are transformed on the host
# by batching points through the installed PROJ's cs2cs, when there is
# one.  Array-namespace paths (transform_points_xp) keep requiring a
# native family: a subprocess cannot run there.
_LONLAT_P4 = "+proj=longlat +datum=WGS84 +no_defs"
_SYSTEM_P4_CACHE = {}


def _system_proj4(key):
    """A proj4 string for a normalized key that the native families do not
    cover, resolved through the system PROJ database; None if unknown."""
    if key in _SYSTEM_P4_CACHE:
        return _SYSTEM_P4_CACHE[key]
    import shutil
    import subprocess

    p4 = None
    if isinstance(key, tuple) and len(key) == 2 and key[0] == "proj4":
        p4 = key[1]
    elif isinstance(key, int):
        exe = shutil.which("projinfo")
        if exe is not None:
            try:
                r = subprocess.run(
                    [exe, "-o", "PROJ", "-q", f"EPSG:{key}"],
                    capture_output=True, text=True, timeout=30)
                if r.returncode == 0:
                    for line in r.stdout.splitlines():
                        line = line.strip()
                        if line.startswith("+proj"):
                            p4 = line
                            break
            except (OSError, subprocess.TimeoutExpired):
                p4 = None
    _SYSTEM_P4_CACHE[key] = p4
    return p4


def _cs2cs_batch(x, y, src_p4, dst_p4):
    """Transform point arrays with one cs2cs subprocess call (proj4-string
    CRSs -> traditional lon/lat axis order, no EPSG axis-order surprises).
    Failed points come back NaN (matching pyproj's errcheck=False)."""
    import shutil
    import subprocess

    exe = shutil.which("cs2cs")
    if exe is None:
        raise NotImplementedError(
            "general-CRS transform needs the system PROJ (cs2cs not found)")
    xa = np.asarray(x, dtype=float)
    ya = np.asarray(y, dtype=float)
    xa, ya = np.broadcast_arrays(xa, ya)
    shape = xa.shape
    xf, yf = xa.ravel(), ya.ravel()
    # non-finite inputs must stay NaN: the literal text 'nan' parses as
    # a coordinate in cs2cs and comes back as bogus FINITE coordinates
    # (this is how a NaN from a failed first leg survives a mixed
    # two-subprocess transform as NaN, matching pyproj)
    finite = np.isfinite(xf) & np.isfinite(yf)
    xs, ys = xf[finite], yf[finite]
    ox = np.full(xf.size, np.nan)
    oy = np.full(yf.size, np.nan)
    if xs.size:
        inp = "\n".join(f"{xi:.12f} {yi:.12f}" for xi, yi in zip(xs, ys))
        r = subprocess.run(
            [exe, "-f", "%.10f", *src_p4.split(), "+to", *dst_p4.split()],
            input=inp, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise NotImplementedError(
                f"cs2cs failed for {src_p4!r} -> {dst_p4!r}: "
                f"{r.stderr.strip()[:200]}")
        lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
        if len(lines) != xs.size:
            raise ValueError(f"cs2cs returned {len(lines)} points, "
                             f"expected {xs.size}")
        tx = np.full(xs.size, np.nan)
        ty = np.full(ys.size, np.nan)
        for i, ln in enumerate(lines):
            parts = ln.split()
            try:
                tx[i] = float(parts[0])
                ty[i] = float(parts[1])
            except (ValueError, IndexError):
                pass  # '*' markers for untransformable points -> NaN
        ox[finite] = tx
        oy[finite] = ty
    return ox.reshape(shape), oy.reshape(shape)


def _transform_points_system(x, y, src, dst):
    """Mixed native/system-PROJ transform via lon/lat."""
    xa = np.asarray(x, dtype=float)
    ya = np.asarray(y, dtype=float)
    if _resolve(src):
        if _INVERSE[src] is not None:
            xa, ya = _INVERSE[src](xa, ya)
        xa, ya = np.asarray(xa, float), np.asarray(ya, float)
    else:
        p4 = _system_proj4(src)
        if p4 is None:
            raise NotImplementedError(f"CRS {src} not supported (not a "
                                      "native family, system PROJ cannot "
                                      "resolve it)")
        xa, ya = _cs2cs_batch(xa, ya, p4, _LONLAT_P4)
    if _resolve(dst):
        if _FORWARD[dst] is not None:
            xa, ya = _FORWARD[dst](xa, ya)
        xa, ya = np.asarray(xa, float), np.asarray(ya, float)
    else:
        p4 = _system_proj4(dst)
        if p4 is None:
            raise NotImplementedError(f"CRS {dst} not supported (not a "
                                      "native family, system PROJ cannot "
                                      "resolve it)")
        xa, ya = _cs2cs_batch(xa, ya, _LONLAT_P4, p4)
    return xa, ya


def transform_points(x, y, src, dst):
    """Transform coordinate arrays between CRSs (via lon/lat).  Native
    closed-form families run in-process (and under jit through
    transform_points_xp); anything else falls back to the system PROJ."""
    src, dst = normalize_crs(src), normalize_crs(dst)
    if src == dst:
        return np.asarray(x, dtype=float), np.asarray(y, dtype=float)
    if not _resolve(src) or not _resolve(dst):
        return _transform_points_system(x, y, src, dst)
    if _INVERSE[src] is not None:
        x, y = _INVERSE[src](x, y)
    if _FORWARD[dst] is not None:
        x, y = _FORWARD[dst](x, y)
    return np.asarray(x, dtype=float), np.asarray(y, dtype=float)


class TorchNamespace:
    """numpy's names, as the projections call them, over torch tensors on
    one device: ``radians``/``degrees`` are torch's ``deg2rad``/``rad2deg``,
    and ``asarray`` puts arrays on the device, ``float`` meaning float32 (the
    device path computes in float32, as the JAX package does on its chip
    with x64 off).  Every other name is torch's own."""

    def __init__(self, device):
        self.device = device

    def __getattr__(self, name):
        return getattr(torch, name)

    radians = staticmethod(torch.deg2rad)
    degrees = staticmethod(torch.rad2deg)

    def asarray(self, a, dtype=None):
        dtype = torch.float32 if dtype is float else dtype
        return torch.as_tensor(a, dtype=dtype, device=self.device)


def transform_points_xp(x, y, src, dst, xp):
    """transform_points with an explicit array namespace ``xp`` (the
    projections are elementwise closed forms): numpy, a namespace with
    numpy's function names, or ``torch``, which runs them on the device of
    ``x`` (``TorchNamespace``).  The device path of the availability matrix
    maps its pixel centres so."""
    src, dst = normalize_crs(src), normalize_crs(dst)
    if src == dst:
        return x, y
    if not _resolve(src) or not _resolve(dst):
        raise NotImplementedError(
            f"CRS transform {src} -> {dst} has no native closed form for "
            "the device path (host paths fall back to the system PROJ)")
    if xp is torch:
        xp = TorchNamespace(x.device if isinstance(x, torch.Tensor) else y.device)
    if _INVERSE[src] is not None:
        x, y = _INVERSE[src](x, y, xp)
    if _FORWARD[dst] is not None:
        x, y = _FORWARD[dst](x, y, xp)
    return x, y
