"""Angles to unit vectors in the scene cube (numpy, host side).

The two helpers the render path needs, with the same math as
``season_nerf_tpu/geometry/units.py``: a bare (elevation, azimuth) to a unit
vector, and the site-aware map through the saved world-to-local similarity
of ``W2C_W2L_H.npy``.
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS_KM = 6378.137


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


def elevation_azimuth_to_vec(el_deg, az_deg):
    """Sun/view angle to unit vector, azimuth measured from north
    (x = cos az)."""
    v = np.array([np.cos(np.deg2rad(az_deg)), np.sin(np.deg2rad(az_deg)),
                  np.tan(np.deg2rad(el_deg))])
    return v / np.sqrt(np.sum(v ** 2))
