"""Solar ephemeris: sun (elevation, azimuth) for a time and location.

The counterpart of ``season_nerf_tpu/geometry/solar.py``: the NOAA/Meeus
low-precision solar position algorithm in numpy float64, the same
operations in the same order, so both packages give the same bits.  The
reference computes this with astropy, which neither package needs; the
algorithm is accurate to well under 0.1 degrees for 1950-2050.
"""

from __future__ import annotations

from datetime import datetime

import numpy as np


def _julian_day(dt: datetime) -> float:
    """Julian day from a UTC datetime (Fliegel–Van Flandern)."""
    y, m = dt.year, dt.month
    d = (dt.day + dt.hour / 24 + dt.minute / 1440
         + (dt.second + dt.microsecond / 1e6) / 86400)
    if m <= 2:
        y -= 1
        m += 12
    a = y // 100
    b = 2 - a + a // 4
    return int(365.25 * (y + 4716)) + int(30.6001 * (m + 1)) + d + b - 1524.5


def solar_el_az(lat_deg, lon_deg, dt: datetime):
    """Sun elevation and azimuth (degrees) at ``(lat, lon)`` and UTC time ``dt``.

    NOAA solar position algorithm (Meeus, *Astronomical Algorithms*, ch. 25).
    Azimuth is measured clockwise from north, matching the reference's
    convention (astropy AltAz).
    """
    jd = _julian_day(dt)
    T = (jd - 2451545.0) / 36525.0

    # geometric mean longitude / anomaly of the sun (deg)
    L0 = (280.46646 + 36000.76983 * T + 0.0003032 * T * T) % 360.0
    M = 357.52911 + 35999.05029 * T - 0.0001537 * T * T
    e = 0.016708634 - 0.000042037 * T - 0.0000001267 * T * T

    Mr = np.deg2rad(M)
    C = ((1.914602 - 0.004817 * T - 0.000014 * T * T) * np.sin(Mr)
         + (0.019993 - 0.000101 * T) * np.sin(2 * Mr)
         + 0.000289 * np.sin(3 * Mr))
    true_long = L0 + C
    omega = 125.04 - 1934.136 * T
    lam = true_long - 0.00569 - 0.00478 * np.sin(np.deg2rad(omega))  # apparent longitude

    # obliquity of the ecliptic (corrected)
    eps0 = 23 + (26 + (21.448 - T * (46.8150 + T * (0.00059 - T * 0.001813))) / 60) / 60
    eps = eps0 + 0.00256 * np.cos(np.deg2rad(omega))

    lam_r, eps_r = np.deg2rad(lam), np.deg2rad(eps)
    decl = np.arcsin(np.sin(eps_r) * np.sin(lam_r))
    ra = np.arctan2(np.cos(eps_r) * np.sin(lam_r), np.cos(lam_r))

    # equation of time (minutes)
    y = np.tan(eps_r / 2) ** 2
    L0r = np.deg2rad(L0)
    eot = 4 * np.rad2deg(
        y * np.sin(2 * L0r) - 2 * e * np.sin(Mr)
        + 4 * e * y * np.sin(Mr) * np.cos(2 * L0r)
        - 0.5 * y * y * np.sin(4 * L0r) - 1.25 * e * e * np.sin(2 * Mr))

    frac_day = (dt.hour + dt.minute / 60 + (dt.second + dt.microsecond / 1e6) / 3600) / 24
    true_solar_min = (frac_day * 1440 + eot + 4 * np.asarray(lon_deg)) % 1440
    hour_angle = true_solar_min / 4 - 180.0  # NOAA ha = tst/4 - 180, tst in [0,1440)

    lat_r = np.deg2rad(np.asarray(lat_deg))
    ha_r = np.deg2rad(hour_angle)
    cos_zen = (np.sin(lat_r) * np.sin(decl)
               + np.cos(lat_r) * np.cos(decl) * np.cos(ha_r))
    cos_zen = np.clip(cos_zen, -1, 1)
    zen = np.arccos(cos_zen)
    el = 90.0 - np.rad2deg(zen)

    # azimuth from north, clockwise
    az_r = np.arctan2(np.sin(ha_r),
                      np.cos(ha_r) * np.sin(lat_r) - np.tan(decl) * np.cos(lat_r))
    az = (np.rad2deg(az_r) + 180.0) % 360.0
    return float(el), float(az)


def solar_el_az_utc(lat_deg, lon_deg, year, month, day, hour, minute, second=0.0):
    dt = datetime(year, month, day, hour, minute, int(second),
                  int((second - int(second)) * 1e6))
    return solar_el_az(lat_deg, lon_deg, dt)
