"""Site preprocessing (images + RPCs + IMD -> scaled cameras and bounds) and
the site's world-frame artifact of a model directory (``W2C_W2L_H.npy``).

The counterpart of ``season_nerf_tpu/data/ingest.py``: scan the site's RGB
GeoTIFFs, load each one's RPC (the corrected ``.ikono`` unless bundle
adjustment is skipped), parse the IMD sun, view and time metadata, take the
height range from the lidar DSM +- 5 m (or the caller's), fit the 3x4
camera of every image and check it against its RPC, shrink-fit the common
lat/lon bounds, and scale everything into the [-1, 1]^3 cube.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from season_nerf_torch.data import io as data_io
from season_nerf_torch.data.lidar import height_range_from_dsm
from season_nerf_torch.geometry.camera import (Camera, find_bounds,
                                               fit_camera_from_rpc,
                                               test_accuracy)
from season_nerf_torch.geometry.time_enc import CaptureTime


@dataclasses.dataclass
class SiteData:
    cameras: List[Camera]          # scaled into the cube, .image set
    bounds_lla: np.ndarray         # [[lat0, lat1], [lon0, lon1], [h0, h1]]
    accuracy: dict                 # the projective fits' reprojection errors


def load_site_images(root_dir: str, site_name: str, rpc_dir: str,
                     cache_dir: str, imd_dir: Optional[str] = None,
                     skip_bundle_adjust: bool = False):
    """-> [(name, image [H, W, C] in [0, 1], rpc, imd fields)]."""
    entries = []
    found = data_io.find_site_images(root_dir, site_name)
    if not found:
        raise FileNotFoundError(f"no {site_name}_*_RGB.tif under {root_dir}")
    for name, path in found:
        img = data_io.read_tiff(path, nodata_to_nan=False)
        if img.max() > 1.5:
            img = img / 255.0
        rpc = data_io.load_rpc_for_image(
            name, path, cache_dir, prefer_corrected=not skip_bundle_adjust)
        imd_path = find_imd(name, [imd_dir, rpc_dir, root_dir])
        if imd_path is None:
            raise FileNotFoundError(f"no IMD metadata for {name}")
        entries.append((name, img, rpc, data_io.parse_imd(imd_path)))
    return entries


def find_imd(name: str, search_dirs) -> Optional[str]:
    """The IMD file of image ``name`` (``<PFX>_<site#>_<img-id>_RGB``), or
    None: ``<name>.IMD``, ``<PFX>/<id without its first character>.IMD``
    (the DFC layout), ``<PFX>/<id>.IMD`` or ``<id>.IMD`` in each directory
    of ``search_dirs`` in turn."""
    parts = name.split("_")
    sid = parts[2] if len(parts) >= 3 else name
    for cand_dir in search_dirs:
        if cand_dir is None:
            continue
        for cand in (os.path.join(cand_dir, name + ".IMD"),
                     os.path.join(cand_dir, parts[0], sid[1:] + ".IMD"),
                     os.path.join(cand_dir, parts[0], sid + ".IMD"),
                     os.path.join(cand_dir, sid + ".IMD")):
            if os.path.exists(cand):
                return cand
    return None


def preprocess_site(root_dir: str, site_name: str, rpc_dir: str,
                    cache_dir: str, gt_dir: Optional[str] = None,
                    height_range: Optional[Tuple[float, float]] = None,
                    skip_bundle_adjust: bool = False,
                    camera_model: str = "Pinhole",
                    cache: bool = True) -> SiteData:
    """The site's scaled cameras (images attached), bounds and fit errors;
    with ``cache``, the bounds also go to ``bounds_LLA[_Refined].npy`` in
    ``cache_dir``."""
    tag = "" if skip_bundle_adjust else "_Refined"
    entries = load_site_images(root_dir, site_name, rpc_dir, cache_dir,
                               skip_bundle_adjust=skip_bundle_adjust)
    if height_range is None:
        if gt_dir is None:
            raise ValueError("need gt_dir or an explicit height_range")
        height_range = height_range_from_dsm(gt_dir, site_name)
    h_min, h_max = height_range

    cams, errs = [], []
    for name, img, rpc, meta in entries:
        cam = fit_camera_from_rpc(rpc, img.shape, h_min, h_max, name=name,
                                  affine=(camera_model == "Parallel"))
        errs.append(test_accuracy(cam, h_min, h_max))
        t = CaptureTime.parse(meta["first_line_time"])
        cam = dataclasses.replace(
            cam, sun_el_az=(meta["sun_el"], meta["sun_az"]),
            view_el_az=(90.0 - meta.get("off_nadir", 0.0),
                        meta.get("view_az", 0.0)),
            time_frac=t.year_frac, day_frac=t.day_frac, rpc=rpc)
        cam.image = img
        cams.append(cam)

    bounds = find_bounds(cams, (h_min, h_max))
    scaled = []
    for cam in cams:
        sc = cam.scale(bounds)
        sc.image = cam.image
        scaled.append(sc)

    errs = np.array(errs)
    acc = {"mean_px": float(errs[:, 0].mean()),
           "std_px": float(errs[:, 1].mean()),
           "min_px": float(errs[:, 2].min()),
           "max_px": float(errs[:, 3].max())}
    site = SiteData(cameras=scaled, bounds_lla=np.asarray(bounds),
                    accuracy=acc)
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(os.path.join(cache_dir, f"bounds_LLA{tag}.npy"),
                site.bounds_lla)
    return site


def world_transform(site: SiteData):
    """(world_center, world-to-local similarity) of the site."""
    cam = site.cameras[0]
    return cam.get_world_center(), cam.S


def save_w2c_w2l(path: str, site: SiteData):
    wc, S = world_transform(site)
    save_world_artifact(path, wc, S, tuple(site.bounds_lla[2]))


def save_world_artifact(path: str, wc, S, h_range=None):
    """Write ``W2C_W2L_H.npy``: (world_center, world-to-local similarity,
    site height range in meters).  Any field may be None (synthetic sites
    have no world frame)."""
    arr = np.empty(3, object)
    arr[0], arr[1], arr[2] = wc, S, h_range
    np.save(path, arr, allow_pickle=True)


def load_w2c_w2l(path: str):
    """-> (world_center, similarity, h_range or None).  Reads the
    3-element artifact and the older 2-element one (no height range).

    The file is a pickled object array: load only model directories you
    trust, as with any pickle."""
    arr = np.load(path, allow_pickle=True)
    h_range = arr[2] if arr.shape[0] > 2 else None
    if h_range is not None:
        h_range = (float(h_range[0]), float(h_range[1]))
    return arr[0], arr[1], h_range
