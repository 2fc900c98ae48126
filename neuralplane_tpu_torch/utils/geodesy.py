"""WGS-84 geodetic <-> ECEF <-> ENU conversions (counterpart of
neuralplane_tpu/utils/geodesy.py, with its own copy of the constants).

Host-side numpy in float64, vectorized: the ACMI writer converts local ENU
flight positions to latitude/longitude with it.
"""
from __future__ import annotations

import numpy as np

A = 6378137.0           # WGS-84 semi-major axis (m)
B = 6356752.3142        # WGS-84 semi-minor axis (m)
F = (A - B) / A
E_SQ = F * (2.0 - F)


def geodetic_to_ecef(lat, lon, h):
    """(deg, deg, m) -> ECEF (m). Vectorized."""
    lat = np.radians(np.asarray(lat, dtype=np.float64))
    lon = np.radians(np.asarray(lon, dtype=np.float64))
    h = np.asarray(h, dtype=np.float64)
    s = np.sin(lat)
    N = A / np.sqrt(1.0 - E_SQ * s * s)
    x = (h + N) * np.cos(lat) * np.cos(lon)
    y = (h + N) * np.cos(lat) * np.sin(lon)
    z = (h + (1.0 - E_SQ) * N) * np.sin(lat)
    return x, y, z


def ecef_to_enu(x, y, z, lat0, lon0, h0):
    """ECEF (m) -> local ENU (m) about reference geodetic point."""
    x0, y0, z0 = geodetic_to_ecef(lat0, lon0, h0)
    lat0 = np.radians(lat0)
    lon0 = np.radians(lon0)
    sl, cl = np.sin(lat0), np.cos(lat0)
    sp, cp = np.sin(lon0), np.cos(lon0)
    xd, yd, zd = x - x0, y - y0, z - z0
    east = -sp * xd + cp * yd
    north = -cp * sl * xd - sp * sl * yd + cl * zd
    up = cl * cp * xd + cl * sp * yd + sl * zd
    return east, north, up


def enu_to_ecef(east, north, up, lat0, lon0, h0):
    """Local ENU (m) -> ECEF (m)."""
    x0, y0, z0 = geodetic_to_ecef(lat0, lon0, h0)
    lat0 = np.radians(lat0)
    lon0 = np.radians(lon0)
    sl, cl = np.sin(lat0), np.cos(lat0)
    sp, cp = np.sin(lon0), np.cos(lon0)
    t = cl * up - sl * north
    zd = sl * up + cl * north
    xd = cp * t - sp * east
    yd = sp * t + cp * east
    return xd + x0, yd + y0, zd + z0


def ecef_to_geodetic(x, y, z):
    """ECEF (m) -> geodetic (deg, deg, m). Closed-form (Ferrari), vectorized."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    x2, y2, z2 = x * x, y * y, z * z
    e = np.sqrt(1.0 - (B / A) ** 2)
    b2 = B * B
    e2 = e * e
    ep = e * (A / B)
    r = np.sqrt(x2 + y2)
    r2 = r * r
    E2 = A * A - B * B
    Fq = 54.0 * b2 * z2
    G = r2 + (1.0 - e2) * z2 - e2 * E2
    c = (e2 * e2 * Fq * r2) / (G * G * G)
    s = np.cbrt(1.0 + c + np.sqrt(c * c + 2.0 * c))
    P = Fq / (3.0 * (s + 1.0 / s + 1.0) ** 2 * G * G)
    Q = np.sqrt(1.0 + 2.0 * e2 * e2 * P)
    ro = -(P * e2 * r) / (1.0 + Q) + np.sqrt(
        np.maximum(
            (A * A / 2.0) * (1.0 + 1.0 / Q)
            - (P * (1.0 - e2) * z2) / (Q * (1.0 + Q))
            - P * r2 / 2.0,
            0.0,
        ))
    tmp = (r - e2 * ro) ** 2
    U = np.sqrt(tmp + z2)
    V = np.sqrt(tmp + (1.0 - e2) * z2)
    zo = (b2 * z) / (A * V)
    height = U * (1.0 - b2 / (A * V))
    lat = np.arctan((z + ep * ep * zo) / r)
    lon = np.arctan2(y, x)
    return np.degrees(lat), np.degrees(lon), height


def geodetic_to_enu(lat, lon, h, lat_ref, lon_ref, h_ref):
    return ecef_to_enu(*geodetic_to_ecef(lat, lon, h), lat_ref, lon_ref, h_ref)


def enu_to_geodetic(east, north, up, lat_ref, lon_ref, h_ref):
    return ecef_to_geodetic(*enu_to_ecef(east, north, up, lat_ref, lon_ref, h_ref))
