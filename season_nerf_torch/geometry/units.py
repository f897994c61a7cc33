"""Unit conversions (numpy float64, host side).

The counterpart of ``season_nerf_tpu/geometry/units.py``, with the same
math: haversine distances, WGS84 to UTM, the similarity that scales a site
into the [-1, 1]^3 cube, and (elevation, azimuth) directions to unit vectors
in the cube, bare or through the saved world-to-local similarity of
``W2C_W2L_H.npy``.
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS_KM = 6378.137


def lat_lon_to_meters(lat1, lon1, lat2, lon2):
    """Haversine distance in meters, vectorized over array inputs."""
    lat1, lon1, lat2, lon2 = (np.asarray(a, dtype=np.float64)
                              for a in (lat1, lon1, lat2, lon2))
    dlat = np.deg2rad(lat2 - lat1)
    dlon = np.deg2rad(lon2 - lon1)
    a = (np.sin(dlat / 2) ** 2 + np.cos(np.deg2rad(lat1))
         * np.cos(np.deg2rad(lat2)) * np.sin(dlon / 2) ** 2)
    c = 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))
    return EARTH_RADIUS_KM * c * 1000.0


def lat_lon_shift(lat, lon, d_lat_m, d_lon_m):
    """Shift (lat, lon) by meters north / east."""
    dlat = d_lat_m / (1000.0 * EARTH_RADIUS_KM)
    dlon = d_lon_m / (1000.0 * EARTH_RADIUS_KM * np.cos(np.deg2rad(lat)))
    return lat + np.rad2deg(dlat), lon + np.rad2deg(dlon)


def lla_get_vec(lla_center, theta_deg, rho_deg):
    """Point in LLA space one (scaled) unit away from ``lla_center`` toward
    azimuth ``theta_deg`` / elevation ``rho_deg``, with the /1000 scaling
    of the direction vector."""
    y = np.cos(np.deg2rad(theta_deg))
    x = np.sin(np.deg2rad(theta_deg))
    z = np.tan(np.deg2rad(rho_deg)) * np.sqrt(x ** 2 + y ** 2)
    norm = np.sqrt(x ** 2 + y ** 2 + z ** 2) / 1000.0
    x, y, z = x / norm, y / norm, z / norm
    new_lat, new_lon = lat_lon_shift(lla_center[0], lla_center[1], y, x)
    return np.array([new_lat, new_lon, lla_center[2] + z])


def world_angle_2_local_vec(world_el, world_az, world_center, world2local_h):
    """World (elevation, azimuth) -> unit vector in the [-1, 1]^3 cube;
    ``world2local_h`` is the 4x4 similarity ``S`` of ``W2C_W2L_H.npy``."""
    ans = lla_get_vec(world_center, world_az, world_el)
    temp = (np.asarray(world2local_h)
            @ np.array([ans[0], ans[1], ans[2], 1.0]))[:3]
    return temp / np.sqrt(np.sum(temp ** 2))


def angles_to_vec_from_site(world_center, w2l_h):
    """(el, az) -> cube-frame unit vector, closed over the saved similarity."""
    def to_vec(el, az):
        return world_angle_2_local_vec(el, az, world_center, w2l_h)
    return to_vec


def sun_frame_from_site(world_center, w2l_h) -> np.ndarray:
    """[3, 3] linear ENU -> cube map (exact for the affine similarity), so
    that the trainer draws random sun directions in the frame of
    :func:`world_angle_2_local_vec`."""
    to_vec = angles_to_vec_from_site(world_center, w2l_h)
    # images of the ENU basis: az 90 = east, az 0 = north, el 90 = up
    east = to_vec(0.0, 90.0)
    north = to_vec(0.0, 0.0)
    up = to_vec(90.0, 0.0)
    return np.stack([east, north, up], axis=1)


def local_vec_2_world_angle(vec, world_center, local2world_h):
    """Inverse of :func:`world_angle_2_local_vec`: a unit direction in the
    cube back to world (el, az), by pushing a point along it through the
    local-to-world similarity."""
    vec = np.asarray(vec, dtype=np.float64)
    p0 = np.asarray(world_center, dtype=np.float64)
    p1h = np.asarray(local2world_h) @ np.array([vec[0], vec[1], vec[2], 1.0])
    p1 = p1h[:3] / p1h[3]
    d_north = (lat_lon_to_meters(p0[0], p0[1], p1[0], p0[1])
               * np.sign(p1[0] - p0[0]))
    d_east = (lat_lon_to_meters(p0[0], p0[1], p0[0], p1[1])
              * np.sign(p1[1] - p0[1]))
    d_up = p1[2] - p0[2]
    az = np.rad2deg(np.arctan2(d_east, d_north))
    el = np.rad2deg(np.arctan2(d_up, np.hypot(d_north, d_east)))
    return el, az


def elevation_azimuth_to_vec(el_deg, az_deg):
    """Sun/view angle to unit vector, azimuth measured from north
    (x = cos az)."""
    v = np.array([np.cos(np.deg2rad(az_deg)), np.sin(np.deg2rad(az_deg)),
                  np.tan(np.deg2rad(el_deg))])
    return v / np.sqrt(np.sum(v ** 2))


class OutOfRangeError(ValueError):
    pass


def wgs84_to_utm(latitude, longitude, force_zone_number=None):
    """WGS84 -> UTM (easting, northing, zone_number, zone_letter): the
    standard series expansion, vectorized over latitude and longitude
    arrays.  The zone is that of the first point unless forced."""
    latitude = np.asarray(latitude, dtype=np.float64)
    longitude = np.asarray(longitude, dtype=np.float64)
    if np.any(latitude < -80.0) or np.any(latitude > 84.0):
        raise OutOfRangeError("latitude out of range (must be between 80 deg "
                              "S and 84 deg N)")
    if np.any(longitude < -180.0) or np.any(longitude > 180.0):
        raise OutOfRangeError("longitude out of range (must be between 180 "
                              "deg W and 180 deg E)")

    K0 = 0.9996
    E = 0.00669438
    E2, E3 = E * E, E * E * E
    E_P2 = E / (1.0 - E)
    M1 = 1 - E / 4 - 3 * E2 / 64 - 5 * E3 / 256
    M2 = 3 * E / 8 + 3 * E2 / 32 + 45 * E3 / 1024
    M3 = 15 * E2 / 256 + 45 * E3 / 1024
    M4 = 35 * E3 / 3072
    R = 6378137.0

    lat_rad = np.deg2rad(latitude)
    lat_sin, lat_cos = np.sin(lat_rad), np.cos(lat_rad)
    lat_tan = lat_sin / lat_cos
    lat_tan2 = lat_tan * lat_tan
    lat_tan4 = lat_tan2 * lat_tan2

    first_lat = float(np.ravel(latitude)[0])
    if force_zone_number is None:
        zone_number = latlon_to_zone_number(first_lat,
                                            float(np.ravel(longitude)[0]))
    else:
        zone_number = force_zone_number
    zone_letter = latitude_to_zone_letter(first_lat)

    lon_rad = np.deg2rad(longitude)
    central_lon_rad = np.deg2rad(
        zone_number_to_central_longitude(zone_number))

    n = R / np.sqrt(1 - E * lat_sin ** 2)
    c = E_P2 * lat_cos ** 2
    a = lat_cos * (lon_rad - central_lon_rad)
    a2, a3 = a * a, a * a * a
    a4, a5, a6 = a3 * a, a3 * a * a, a3 * a3

    m = R * (M1 * lat_rad - M2 * np.sin(2 * lat_rad)
             + M3 * np.sin(4 * lat_rad) - M4 * np.sin(6 * lat_rad))

    easting = K0 * n * (a + a3 / 6 * (1 - lat_tan2 + c)
                        + a5 / 120 * (5 - 18 * lat_tan2 + lat_tan4 + 72 * c
                                      - 58 * E_P2)) + 500000
    northing = K0 * (m + n * lat_tan * (
        a2 / 2 + a4 / 24 * (5 - lat_tan2 + 9 * c + 4 * c ** 2)
        + a6 / 720 * (61 - 58 * lat_tan2 + lat_tan4 + 600 * c
                      - 330 * E_P2)))
    northing = np.where(latitude < 0, northing + 10000000.0, northing)
    return easting, northing, zone_number, zone_letter


def latitude_to_zone_letter(latitude):
    ZONE_LETTERS = "CDEFGHJKLMNPQRSTUVWXX"
    if -80 <= latitude <= 84:
        return ZONE_LETTERS[int(latitude + 80) >> 3]
    return None


def latlon_to_zone_number(latitude, longitude):
    if 56 <= latitude < 64 and 3 <= longitude < 12:
        return 32
    if 72 <= latitude <= 84 and longitude >= 0:
        if longitude <= 9:
            return 31
        elif longitude <= 21:
            return 33
        elif longitude <= 33:
            return 35
        elif longitude <= 42:
            return 37
    return int((longitude + 180) / 6) + 1


def zone_number_to_central_longitude(zone_number):
    return (zone_number - 1) * 6 - 180 + 3


def make_similarity(original_bounds, new_bounds):
    """4x4 axis-aligned similarity mapping ``original_bounds`` (3x2 [min,
    max] per axis) onto ``new_bounds``: the world-to-local ``S`` that
    scales a site into the cube."""
    original_bounds = np.asarray(original_bounds, dtype=np.float64)
    new_bounds = np.asarray(new_bounds, dtype=np.float64)
    r = new_bounds[:, 1] - new_bounds[:, 0]
    d = original_bounds[:, 1] - original_bounds[:, 0]
    S = np.eye(4)
    for i in range(3):
        S[i, i] = r[i] / d[i]
        S[i, 3] = -r[i] * original_bounds[i, 0] / d[i] + new_bounds[i, 0]
    return S
