"""Astropy/katpoint-free ephemeris math for the data loaders.

The reference computes per-antenna UVW coordinates and parallactic/feed
angles with katpoint (``loader_katdal.py:376-397``) or astropy CIRS/AltAz
(``loader_ms.py:244-306``).  Neither package is a dependency of this
build, so this module provides the required subset from first principles:

- Greenwich Mean Sidereal Time from UNIX time (IAU 1982-class polynomial,
  good to well under an arcsecond over decades);
- per-antenna (u, v, w) projections toward a (ra, dec) target, in the
  standard radio-interferometry frame (u east, v north on the celestial
  sphere, w toward the source) — baseline uvw = uvw[ant2] - uvw[ant1],
  matching the ``loader_core`` sign convention (position2 - position1);
- parallactic angle and elevation via the hour angle at the antenna's
  geodetic (WGS84) site.

Apparent place: :func:`apparent_radec` converts catalogue (ICRS/J2000)
coordinates to the apparent place of date — IAU 1976 precession, IAU 1980
nutation (20 leading terms, |neglected| < 0.01"), and annual aberration
with the elliptic terms — and the geometry functions below take
``apparent=True`` to use it together with apparent sidereal time.  This
matches the reference's katpoint path (``loader_katdal.py:376-397``) /
astropy CIRS (``loader_ms.py:244-306``) to ~arcseconds; the residual is
dominated by UT1-UTC (unmodelled, < 0.9 s of rotation, i.e. < 13") plus
polar motion (< 0.3") and gravitational light deflection (< 0.05" beyond
10 degrees from the Sun).  doc/DEVIATIONS.md records the residual terms.

The port's own copy of :mod:`katsdpimager_tpu.ephem` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

#: UNIX epoch as Julian Date
_JD_UNIX = 2440587.5
#: J2000.0 epoch as Julian Date
_JD_J2000 = 2451545.0

# WGS84 ellipsoid
_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2.0 - _WGS84_F)


def gmst(unix_time):
    """Greenwich Mean Sidereal Time (radians) from UNIX seconds.

    Meeus (1998) eq. 12.4, treating UTC as UT1 (|UT1-UTC| < 0.9 s, i.e.
    < 0.014 arcsec of rotation — negligible here).
    """
    t = np.asarray(unix_time, np.float64)
    jd = _JD_UNIX + t / 86400.0
    d = jd - _JD_J2000
    tc = d / 36525.0
    gmst_deg = (280.46061837 + 360.98564736629 * d
                + 0.000387933 * tc * tc - tc ** 3 / 38710000.0)
    return np.deg2rad(gmst_deg % 360.0)


# ---------------------------------------------------------------------------
# Apparent place: precession + nutation + annual aberration
#
# Time scale: the series below are functions of TT.  TT = UTC + 32.184 s +
# (TAI - UTC); leap seconds since 1999 are tabulated (earlier epochs clamp
# to 32 s — a few seconds of TT error moves the slow series arguments by
# far less than a milliarcsecond).

_TT_MINUS_TAI = 32.184
_LEAPS = (  # (UNIX time the offset took effect, TAI-UTC seconds)
    (1136073600.0, 33.0),   # 2006-01-01
    (1230768000.0, 34.0),   # 2009-01-01
    (1341100800.0, 35.0),   # 2012-07-01
    (1435708800.0, 36.0),   # 2015-07-01
    (1483228800.0, 37.0),   # 2017-01-01
)

_ARCSEC = np.pi / (180.0 * 3600.0)


def _tt_centuries(unix_time):
    """Julian centuries of TT since J2000.0 from UNIX (UTC) seconds."""
    t = np.asarray(unix_time, np.float64)
    tai_utc = np.full(np.shape(t), 32.0)
    for epoch, off in _LEAPS:
        tai_utc = np.where(t >= epoch, off, tai_utc)
    tt = t + _TT_MINUS_TAI + tai_utc
    return (tt / 86400.0 + _JD_UNIX - _JD_J2000) / 36525.0


def _rx(a):
    """Frame rotation about x: components of a fixed vector in the frame
    rotated by ``a`` (radians, array ok) -> (..., 3, 3)."""
    c, s = np.cos(a), np.sin(a)
    o, i = np.zeros_like(c), np.ones_like(c)
    return np.stack([np.stack([i, o, o], -1),
                     np.stack([o, c, s], -1),
                     np.stack([o, -s, c], -1)], -2)


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    o, i = np.zeros_like(c), np.ones_like(c)
    return np.stack([np.stack([c, o, -s], -1),
                     np.stack([o, i, o], -1),
                     np.stack([s, o, c], -1)], -2)


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    o, i = np.zeros_like(c), np.ones_like(c)
    return np.stack([np.stack([c, s, o], -1),
                     np.stack([-s, c, o], -1),
                     np.stack([o, o, i], -1)], -2)


def _precession_from_T(T):
    """IAU 1976 precession matrix (J2000 mean -> mean of date).

    Lieske et al. equatorial angles zeta_A, z_A, theta_A;
    P = R3(-z) R2(theta) R3(-zeta)."""
    zeta = (2306.2181 * T + 0.30188 * T ** 2 + 0.017998 * T ** 3) * _ARCSEC
    z = (2306.2181 * T + 1.09468 * T ** 2 + 0.018203 * T ** 3) * _ARCSEC
    theta = (2004.3109 * T - 0.42665 * T ** 2 - 0.041833 * T ** 3) * _ARCSEC
    return _rz(-z) @ _ry(theta) @ _rz(-zeta)


def _mean_obliquity_from_T(T):
    """IAU 1980 mean obliquity of the ecliptic (radians)."""
    return (84381.448 - 46.8150 * T - 0.00059 * T ** 2
            + 0.001813 * T ** 3) * _ARCSEC


# IAU 1980 nutation, 20 leading terms: multiples of the Delaunay
# arguments (D, M, M', F, Omega) then (psi_0, psi_t, eps_0, eps_t) in
# units of 0.1 mas (and 0.1 mas/century for the T-coefficients).
_NUT_TERMS = np.array([
    [0, 0, 0, 0, 1, -171996, -174.2, 92025, 8.9],
    [-2, 0, 0, 2, 2, -13187, -1.6, 5736, -3.1],
    [0, 0, 0, 2, 2, -2274, -0.2, 977, -0.5],
    [0, 0, 0, 0, 2, 2062, 0.2, -895, 0.5],
    [0, 1, 0, 0, 0, 1426, -3.4, 54, -0.1],
    [0, 0, 1, 0, 0, 712, 0.1, -7, 0],
    [-2, 1, 0, 2, 2, -517, 1.2, 224, -0.6],
    [0, 0, 0, 2, 1, -386, -0.4, 200, 0],
    [0, 0, 1, 2, 2, -301, 0, 129, -0.1],
    [-2, -1, 0, 2, 2, 217, -0.5, -95, 0.3],
    [-2, 0, 1, 0, 0, -158, 0, 0, 0],
    [-2, 0, 0, 2, 1, 129, 0.1, -70, 0],
    [0, 0, -1, 2, 2, 123, 0, -53, 0],
    [2, 0, 0, 0, 0, 63, 0, 0, 0],
    [0, 0, 1, 0, 1, 63, 0.1, -33, 0],
    [2, 0, -1, 2, 2, -59, 0, 26, 0],
    [0, 0, -1, 0, 1, -58, -0.1, 32, 0],
    [0, 0, 1, 2, 1, -51, 0, 27, 0],
    [-2, 0, 2, 0, 0, 48, 0, 0, 0],
    [0, 0, -2, 2, 1, 46, 0, -24, 0],
], np.float64)


def _delaunay_from_T(T):
    """Fundamental lunisolar arguments (radians): D, M, M', F, Omega."""
    T = np.asarray(T, np.float64)
    d = (297.85036 + 445267.111480 * T - 0.0019142 * T ** 2
         + T ** 3 / 189474.0)
    m = (357.52772 + 35999.050340 * T - 0.0001603 * T ** 2
         - T ** 3 / 300000.0)
    mp = (134.96298 + 477198.867398 * T + 0.0086972 * T ** 2
          + T ** 3 / 56250.0)
    f = (93.27191 + 483202.017538 * T - 0.0036825 * T ** 2
         + T ** 3 / 327270.0)
    om = (125.04452 - 1934.136261 * T + 0.0020708 * T ** 2
          + T ** 3 / 450000.0)
    return np.deg2rad(np.stack([d, m, mp, f, om], axis=-1) % 360.0)


def _nutation_from_T(T):
    """(delta_psi, delta_eps) in radians from the truncated 1980 series."""
    T = np.asarray(T, np.float64)
    args = _delaunay_from_T(T)                       # (..., 5)
    phase = args @ _NUT_TERMS[:, :5].T               # (..., 20)
    tt = T[..., None]
    dpsi = np.sum((_NUT_TERMS[:, 5] + _NUT_TERMS[:, 6] * tt)
                  * np.sin(phase), axis=-1)
    deps = np.sum((_NUT_TERMS[:, 7] + _NUT_TERMS[:, 8] * tt)
                  * np.cos(phase), axis=-1)
    return dpsi * 1e-4 * _ARCSEC, deps * 1e-4 * _ARCSEC


def nutation_angles(unix_time):
    """Nutation in longitude and obliquity (radians)."""
    return _nutation_from_T(_tt_centuries(unix_time))


def mean_obliquity(unix_time):
    return _mean_obliquity_from_T(_tt_centuries(unix_time))


def precession_matrix(unix_time):
    """(..., 3, 3): J2000 mean equatorial -> mean equatorial of date."""
    return _precession_from_T(_tt_centuries(unix_time))


def nutation_matrix(unix_time):
    """(..., 3, 3): mean of date -> true of date,
    N = R1(-eps - deps) R3(-dpsi) R1(eps)."""
    T = _tt_centuries(unix_time)
    eps0 = _mean_obliquity_from_T(T)
    dpsi, deps = _nutation_from_T(T)
    return _rx(-(eps0 + deps)) @ _rz(-dpsi) @ _rx(eps0)


def _sun_longitude_from_T(T):
    """Geometric solar longitude of date (radians), low-precision
    (Meeus ch. 25; ~20 arcsec, which perturbs aberration by < 0.003")."""
    l0 = 280.46646 + 36000.76983 * T + 0.0003032 * T ** 2
    m = np.deg2rad((357.52911 + 35999.05029 * T
                    - 0.0001537 * T ** 2) % 360.0)
    c = ((1.914602 - 0.004817 * T - 0.000014 * T ** 2) * np.sin(m)
         + (0.019993 - 0.000101 * T) * np.sin(2 * m)
         + 0.000289 * np.sin(3 * m))
    return np.deg2rad((l0 + c) % 360.0)


#: Aberration constant (arcsec)
_KAPPA = 20.49552


def aberration_velocity(unix_time):
    """Earth barycentric velocity / c in the TRUE equatorial frame of date
    (..., 3), first-order annual aberration with the elliptic terms.

    Ecliptic components kappa*(sin ls - e sin pi, -(cos ls - e cos pi), 0)
    reproduce the classical displacement formulas
    d(lambda)*cos(beta) = -kappa cos(ls - lambda) + e kappa cos(pi - lambda),
    d(beta) = -kappa sin(beta) (sin(ls - lambda) - e sin(pi - lambda)).
    """
    T = _tt_centuries(unix_time)
    ls = _sun_longitude_from_T(T)
    e = 0.016708634 - 0.000042037 * T - 0.0000001267 * T ** 2
    peri = np.deg2rad((102.93735 + 1.71946 * T + 0.00046 * T ** 2) % 360.0)
    k = _KAPPA * _ARCSEC
    v_ecl = np.stack([k * (np.sin(ls) - e * np.sin(peri)),
                      -k * (np.cos(ls) - e * np.cos(peri)),
                      np.zeros_like(ls)], axis=-1)
    eps = _mean_obliquity_from_T(T)
    return np.einsum("...ij,...j->...i", _rx(-eps), v_ecl)


def apparent_radec(ra, dec, unix_time):
    """Apparent place of date from catalogue (ICRS/J2000) coordinates.

    Applies IAU 1976 precession, truncated IAU 1980 nutation and annual
    aberration; returns (ra, dec) w.r.t. the true equinox of date, each
    broadcast over ``unix_time``.  Use with :func:`gast` for hour angles.
    (Reference path: katpoint apparent_radec / astropy CIRS,
    loader_katdal.py:376-397, loader_ms.py:244-306.)
    """
    t = np.asarray(unix_time, np.float64)
    T = _tt_centuries(t)
    shape = np.shape(T)
    cd = np.cos(dec)
    p = np.stack(np.broadcast_arrays(
        cd * np.cos(ra) * np.ones(shape),
        cd * np.sin(ra) * np.ones(shape),
        np.sin(dec) * np.ones(shape)), axis=-1)
    frame = nutation_matrix(t) @ precession_matrix(t)
    p_app = np.einsum("...ij,...j->...i", frame, p) + aberration_velocity(t)
    p_app = p_app / np.linalg.norm(p_app, axis=-1, keepdims=True)
    ra_a = np.arctan2(p_app[..., 1], p_app[..., 0]) % (2 * np.pi)
    dec_a = np.arcsin(np.clip(p_app[..., 2], -1.0, 1.0))
    return ra_a, dec_a


def gast(unix_time):
    """Greenwich Apparent Sidereal Time (radians): GMST + the equation of
    the equinoxes (complementary terms < 0.003" are dropped)."""
    T = _tt_centuries(unix_time)
    dpsi, _deps = _nutation_from_T(T)
    return gmst(unix_time) + dpsi * np.cos(_mean_obliquity_from_T(T))


def ecef_to_geodetic(xyz):
    """(lat, lon, height) in radians/metres from ECEF (Bowring's method)."""
    x, y, z = np.asarray(xyz, np.float64).T
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    b = _WGS84_A * (1.0 - _WGS84_F)
    e2b = _WGS84_E2 / (1.0 - _WGS84_E2)
    theta = np.arctan2(z * _WGS84_A, p * b)
    lat = np.arctan2(z + e2b * b * np.sin(theta) ** 3,
                     p - _WGS84_E2 * _WGS84_A * np.cos(theta) ** 3)
    n = _WGS84_A / np.sqrt(1.0 - _WGS84_E2 * np.sin(lat) ** 2)
    height = p / np.cos(lat) - n
    return lat.T, lon.T, height.T


def geodetic_to_ecef(lat, lon, height=0.0):
    """ECEF (3,) from geodetic latitude/longitude (radians) and height."""
    n = _WGS84_A / np.sqrt(1.0 - _WGS84_E2 * np.sin(lat) ** 2)
    x = (n + height) * np.cos(lat) * np.cos(lon)
    y = (n + height) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - _WGS84_E2) + height) * np.sin(lat)
    return np.stack([x, y, z], axis=-1)


def enu_to_ecef_matrix(lat, lon):
    """(3, 3) matrix taking local (east, north, up) offsets to ECEF."""
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array([[-so, -sl * co, cl * co],
                     [co, -sl * so, cl * so],
                     [0.0, cl, sl]])


def source_ecef(ra, dec, unix_time, apparent=False):
    """Unit vector(s) toward (ra, dec) in the rotating ECEF frame.

    A source with RA ``alpha`` crosses the Greenwich meridian (+x) when
    the sidereal time equals alpha; shape broadcast of ``unix_time``
    against scalars.  With ``apparent=True`` the catalogue position is
    converted to the apparent place of date and paired with apparent
    sidereal time (the katpoint-equivalent geometry).
    """
    if apparent:
        ra, dec = apparent_radec(ra, dec, unix_time)
        ha_g = gast(unix_time) - ra      # Greenwich hour angle
    else:
        ha_g = gmst(unix_time) - ra      # Greenwich hour angle
    cd = np.cos(dec)
    return np.stack([cd * np.cos(-ha_g), cd * np.sin(-ha_g),
                     np.sin(dec) * np.ones_like(ha_g)], axis=-1)


def uvw_basis(ra, dec, unix_time, apparent=False):
    """(3, 3) orthonormal (u_hat, v_hat, w_hat) rows in ECEF per time.

    w toward the source; u toward increasing RA (east on the sky);
    v completes the right-handed set (north).  For array input of T times
    the result is (T, 3, 3).
    """
    w_hat = source_ecef(ra, dec, unix_time, apparent=apparent)
    z = np.zeros_like(w_hat)
    z[..., 2] = 1.0
    u_hat = np.cross(z, w_hat)
    norm = np.linalg.norm(u_hat, axis=-1, keepdims=True)
    # At the celestial pole u is degenerate; pick x (never hit in practice)
    u_hat = np.where(norm > 1e-12, u_hat / np.where(norm > 0, norm, 1.0),
                     np.array([1.0, 0.0, 0.0]))
    v_hat = np.cross(w_hat, u_hat)
    return np.stack([u_hat, v_hat, w_hat], axis=-2)


def antenna_uvw(positions_ecef, ra, dec, unix_time, ref_position=None,
                apparent=False):
    """Per-antenna (u, v, w) in metres toward the target.

    Parameters: ``positions_ecef`` (A, 3); ``unix_time`` scalar or (T,);
    ``ref_position`` (3,) defaults to the mean antenna position.  Returns
    (A, 3) for scalar time or (A, T, 3) — baseline uvw for (a, b) is
    ``out[b] - out[a]`` (reference loader_katdal.py:394-395).
    """
    pos = np.asarray(positions_ecef, np.float64)
    if ref_position is None:
        ref_position = pos.mean(axis=0)
    rel = pos - np.asarray(ref_position, np.float64)
    basis = uvw_basis(ra, dec, unix_time, apparent=apparent)  # (..., 3, 3)
    out = np.einsum("...ij,aj->a...i", basis, rel)
    return out


def hour_angle(lon, ra, unix_time):
    """Local hour angle of a catalogue (mean-place) RA (radians, wrapped
    to [-pi, pi)).  Apparent-place hour angles couple RA and dec through
    precession, so the apparent geometry functions compute theirs from
    :func:`apparent_radec` + :func:`gast` directly."""
    ha = gmst(unix_time) + lon - ra
    return (ha + np.pi) % (2 * np.pi) - np.pi


def parallactic_angle(lat, lon, ra, dec, unix_time, apparent=False):
    """Parallactic angle (radians): the position angle of the local
    vertical (toward zenith) measured at the source from celestial north,
    positive toward east."""
    if apparent:
        ra, dec = apparent_radec(ra, dec, unix_time)
        ha = (gast(unix_time) + lon - ra + np.pi) % (2 * np.pi) - np.pi
    else:
        ha = hour_angle(lon, ra, unix_time)
    return np.arctan2(
        np.cos(lat) * np.sin(ha),
        np.sin(lat) * np.cos(dec) - np.cos(lat) * np.sin(dec) * np.cos(ha))


def elevation(lat, lon, ra, dec, unix_time, apparent=False):
    """Source elevation (radians) above the horizon."""
    if apparent:
        ra, dec = apparent_radec(ra, dec, unix_time)
        ha = (gast(unix_time) + lon - ra + np.pi) % (2 * np.pi) - np.pi
    else:
        ha = hour_angle(lon, ra, unix_time)
    s = (np.sin(lat) * np.sin(dec)
         + np.cos(lat) * np.cos(dec) * np.cos(ha))
    return np.arcsin(np.clip(s, -1.0, 1.0))
