"""The ground-truth lidar DSM of a DFC2019 site (Track 3).

The counterpart of ``season_nerf_tpu/data/lidar.py``: read
``<site>_DSM.tif`` and its UTM sidecar ``<site>_DSM.txt`` (easting,
northing, pixels, ground sample distance), resample it onto the site's
lat/lon grid by a WGS84 -> UTM pixel lookup, and normalize heights into
[-1, 1] by the site's height bounds.  NaN marks no data.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from season_nerf_torch.data.io import read_tiff
from season_nerf_torch.geometry.units import (latlon_to_zone_number,
                                              wgs84_to_utm)


def build_gt_dsm_utm(dsm_path: str, out_hw: Tuple[int, int],
                     bounds_lla: np.ndarray, utm_path: str) -> np.ndarray:
    """[H, W] ground-truth heights (meters) over the site's grid, row 0 at
    the largest latitude."""
    img = read_tiff(dsm_path)
    if img.ndim == 3:
        img = img[..., 0]
    easting, northing, _pixels, gsd = np.loadtxt(utm_path)

    H, W = out_hw
    vx = np.repeat(np.arange(H), W)
    vy = np.tile(np.arange(W), H)
    lat = (vx / max(H - 1, 1) * (bounds_lla[0][1] - bounds_lla[0][0])
           + bounds_lla[0][0])
    lon = (vy / max(W - 1, 1) * (bounds_lla[1][1] - bounds_lla[1][0])
           + bounds_lla[1][0])
    # every conversion in the zone of the site's centre: a site across a
    # zone boundary needs one frame, the sidecar's
    zone = latlon_to_zone_number(float(np.mean(bounds_lla[0])),
                                 float(np.mean(bounds_lla[1])))
    e, n, _, _ = wgs84_to_utm(lat, lon, force_zone_number=zone)
    gx = np.round((n - northing) / gsd).astype(int)
    gy = np.round((e - easting) / gsd).astype(int)
    good = (gx >= 0) & (gx < img.shape[0]) & (gy >= 0) & (gy < img.shape[1])
    out = np.full((H, W), np.nan, np.float64)
    out[vx[good], vy[good]] = img[gx[good], gy[good]]
    return np.flip(out, 0)


def get_gt_dsm(gt_dir: str, site_name: str, out_hw: Tuple[int, int],
               bounds_lla: np.ndarray) -> np.ndarray:
    """The ground-truth DSM on the site's grid, normalized to [-1, 1] by the
    height bounds."""
    dsm = os.path.join(gt_dir, f"{site_name}_DSM.tif")
    utm = dsm[:-3] + "txt"
    gt = build_gt_dsm_utm(dsm, out_hw, bounds_lla, utm)
    h0, h1 = bounds_lla[2][0], bounds_lla[2][1]
    return (gt - h0) / (h1 - h0) * 2.0 - 1.0


def height_range_from_dsm(gt_dir: str, site_name: str,
                          margin: float = 5.0) -> Tuple[float, float]:
    """(lowest - margin, highest + margin) meters of the lidar DSM."""
    img = read_tiff(os.path.join(gt_dir, f"{site_name}_DSM.tif"))
    if img.ndim == 3:
        img = img[..., 0]
    return float(np.nanmin(img) - margin), float(np.nanmax(img) + margin)
