"""``geometry/solar.py`` of the port against the JAX package's: the sun's
elevation and azimuth over a grid of places (both hemispheres, both sides
of the date line, the poles' neighbourhoods) and UTC times (every month,
round the clock, leap days, second fractions, 1950-2049), bit-equal: the
same numpy float64 operations in the same order.  Under 1 s."""

from datetime import datetime

import numpy as np
import pytest

from season_nerf_torch.geometry import solar as t_solar
from season_nerf_tpu.geometry import solar as j_solar

PLACES = [(lat, lon) for lat in (-89.5, -45.0, -12.3, 0.0, 23.44, 39.7,
                                 66.6, 89.9)
          for lon in (-179.9, -122.4, -77.0, 0.0, 31.2, 139.7, 180.0)]


def _times():
    rng = np.random.default_rng(0)
    out = [datetime(2020, 2, 29, 12, 0), datetime(2000, 1, 1, 0, 0),
           datetime(1950, 1, 1, 23, 59, 59, 999999),
           datetime(2049, 12, 31, 6, 30, 15, 250000)]
    for month in range(1, 13):
        for hour in (0, 5, 11, 17, 23):
            out.append(datetime(int(rng.integers(1990, 2030)), month,
                                int(rng.integers(1, 29)), hour,
                                int(rng.integers(0, 60)),
                                int(rng.integers(0, 60)),
                                int(rng.integers(0, 1_000_000))))
    return out


@pytest.mark.parametrize("lat,lon", PLACES)
def test_solar_el_az_is_bit_equal(lat, lon):
    for dt in _times():
        got = t_solar.solar_el_az(lat, lon, dt)
        assert got == j_solar.solar_el_az(lat, lon, dt), (lat, lon, dt)
        assert -90 <= got[0] <= 90 and 0 <= got[1] < 360


def test_solar_el_az_utc_is_bit_equal():
    for lat, lon in PLACES[::5]:
        for args in ((2019, 6, 21, 17, 0), (2019, 12, 21, 4, 45, 30.5),
                     (2016, 2, 29, 23, 59, 59.999)):
            assert t_solar.solar_el_az_utc(lat, lon, *args) == \
                j_solar.solar_el_az_utc(lat, lon, *args)
    # the Julian day of the J2000 epoch
    assert t_solar._julian_day(datetime(2000, 1, 1, 12)) == 2451545.0
