"""Satellite cameras: RPC models and their 3x4 approximations (numpy
float64, host side).

The counterpart of ``season_nerf_tpu/geometry/camera.py``: a camera is a
dataclass of numpy arrays; projection and back-projection at a fixed height
are closed forms vectorized over whole pixel grids; a camera is fitted to an
RPC model by a DLT over Chebyshev or uniform samples, checked against the
RPC, and scaled into the [-1, 1]^3 cube with the site's common bounds.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from season_nerf_torch.geometry import units
from season_nerf_torch.geometry.rpc import RPCModel


def project_P(P, x, y, z):
    """Apply a 3x4 camera: world (x, y, z) -> image (row, col)."""
    x, y, z = (np.asarray(a, dtype=np.float64) for a in (x, y, z))
    r = P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]
    c = P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]
    w = P[2, 0] * x + P[2, 1] * y + P[2, 2] * z + P[2, 3]
    return r / w, c / w


def backproject_P(P, row, col, h):
    """Closed-form inverse of a 3x4 camera at the fixed height ``h``: the
    2x2 linear system of the two projection equations with z = h."""
    row = np.asarray(row, dtype=np.float64)
    col = np.asarray(col, dtype=np.float64)
    h = np.broadcast_to(np.asarray(h, dtype=np.float64),
                        np.broadcast(row, col).shape)
    b1 = P[0, 2] * h + P[0, 3] - P[2, 2] * h * row - P[2, 3] * row
    b2 = P[1, 2] * h + P[1, 3] - P[2, 2] * h * col - P[2, 3] * col
    a11 = P[0, 0] - P[2, 0] * row
    a12 = P[0, 1] - P[2, 1] * row
    a21 = P[1, 0] - P[2, 0] * col
    a22 = P[1, 1] - P[2, 1] * col
    det = a11 * a22 - a12 * a21
    x = (a12 * b2 - a22 * b1) / det
    y = (a21 * b1 - a11 * b2) / det
    return x, y, h


def fit_projective_dlt(lat, lon, h, rows, cols, affine=False):
    """DLT fit of a 3x4 camera from ground <-> image correspondences.

    Ground coordinates are normalized to [0, 1000] per axis for
    conditioning, and the normalization is composed back into P.  With
    ``affine=True`` (``camera_model="Parallel"``) the bottom row is fixed
    to [0, 0, 0, 1]."""
    lat = np.asarray(lat, dtype=np.float64).ravel()
    lon = np.asarray(lon, dtype=np.float64).ravel()
    h = np.asarray(h, dtype=np.float64).ravel()
    rows = np.asarray(rows, dtype=np.float64).ravel()
    cols = np.asarray(cols, dtype=np.float64).ravel()
    n = lat.shape[0]

    def norm_params(v):
        lo = np.min(v)
        sc = np.max(v - lo)
        return lo, (sc if sc > 0 else 1.0)

    lat0, lat_s = norm_params(lat)
    lon0, lon_s = norm_params(lon)
    h0, h_s = norm_params(h)
    latn = (lat - lat0) / lat_s * 1000.0
    lonn = (lon - lon0) / lon_s * 1000.0
    hn = (h - h0) / h_s * 1000.0

    if not affine:
        # the 11-unknown DLT, P[2, 3] = 1
        X = np.zeros([2 * n, 11])
        Y = np.zeros([2 * n])
        X[0::2, 0:4] = np.stack([latn, lonn, hn, np.ones(n)], -1)
        X[0::2, 8:11] = -rows[:, None] * np.stack([latn, lonn, hn], -1)
        Y[0::2] = rows
        X[1::2, 4:8] = np.stack([latn, lonn, hn, np.ones(n)], -1)
        X[1::2, 8:11] = -cols[:, None] * np.stack([latn, lonn, hn], -1)
        Y[1::2] = cols
        coef, *_ = np.linalg.lstsq(X, Y, rcond=None)
        P = np.ones([3, 4])
        P[0, :] = coef[0:4]
        P[1, :] = coef[4:8]
        P[2, 0:3] = coef[8:11]
    else:
        A = np.stack([latn, lonn, hn, np.ones(n)], -1)
        cr, *_ = np.linalg.lstsq(A, rows, rcond=None)
        cc, *_ = np.linalg.lstsq(A, cols, rcond=None)
        P = np.zeros([3, 4])
        P[0, :] = cr
        P[1, :] = cc
        P[2, 3] = 1.0

    A = np.array([[1000 / lat_s, 0, 0, -1000 * lat0 / lat_s],
                  [0, 1000 / lon_s, 0, -1000 * lon0 / lon_s],
                  [0, 0, 1000 / h_s, -1000 * h0 / h_s],
                  [0, 0, 0, 1]])
    P = P @ A
    return P / P[-1, -1]


def chebyshev_grid(img_shape, h_min, h_max, n_per_axis):
    """Chebyshev samples over image rows x cols x the height range."""
    c = np.cos((2 * np.arange(0, n_per_axis + 1) + 1)
               / (2 * (n_per_axis + 1)) * np.pi)
    xs = (img_shape[0] - 0) / 2 * (c + 1)
    ys = (img_shape[1] - 0) / 2 * (c + 1)
    zs = (h_max - h_min) / 2 * (c + 1) + h_min
    X, Y, Z = np.meshgrid(xs, ys, zs)
    return X.ravel(), Y.ravel(), Z.ravel()


def uniform_grid(img_shape, h_min, h_max, n_steps):
    xs = np.linspace(0, img_shape[0], n_steps + 1)
    ys = np.linspace(0, img_shape[1], n_steps + 1)
    zs = np.linspace(h_min, h_max, n_steps + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs)
    return X.ravel(), Y.ravel(), Z.ravel()


@dataclass
class Camera:
    """A satellite view: a 3x4 camera and its metadata.

    ``P`` maps scaled world coordinates (the [-1, 1]^3 cube) to (row,
    col); ``S`` is the world-to-local similarity and ``S_inv`` its
    inverse; ``sun_vec`` is the sun direction in the cube; ``time_enc`` the
    periodic time encoding."""
    name: str
    P: np.ndarray
    img_shape: tuple
    S: np.ndarray = field(default_factory=lambda: np.eye(4))
    S_inv: np.ndarray = field(default_factory=lambda: np.eye(4))
    sun_el_az: tuple = (90.0, 0.0)
    sun_vec: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0]))
    view_el_az: tuple = (90.0, 0.0)
    time_frac: float = 0.5
    day_frac: float = 0.5
    weight: float = 1.0
    rpc: Optional[RPCModel] = None
    scaled: bool = False
    image: Optional[np.ndarray] = None

    def project(self, x, y, z):
        return project_P(self.P, x, y, z)

    def backproject(self, row, col, h):
        return backproject_P(self.P, row, col, h)

    def pixel_rays(self, downscale=1, bounds=((-1, 1), (-1, 1), (-1, 1))):
        """Every pixel's ray of the image downscaled by ``downscale``, from
        the top to the bottom of ``bounds`` -> (img_pts [N, 2] in the
        downscaled image, tops [N, 3], bots [N, 3], valid [N]); ``valid``
        marks rays whose two ends stay inside the x and y bounds."""
        rows = np.arange(0, self.img_shape[0] // downscale)
        cols = np.arange(0, self.img_shape[1] // downscale)
        RR, CC = np.meshgrid(rows, cols, indexing="ij")
        img_pts = np.stack([RR.ravel(), CC.ravel()], -1)
        r, c = img_pts[:, 0] * downscale, img_pts[:, 1] * downscale
        tx, ty, tz = self.backproject(r, c, bounds[2][1])
        bx, by, bz = self.backproject(r, c, bounds[2][0])
        tops = np.stack([tx, ty, tz], -1)
        bots = np.stack([bx, by, bz], -1)
        valid = ((tx <= bounds[0][1]) & (tx >= bounds[0][0])
                 & (ty <= bounds[1][1]) & (ty >= bounds[1][0])
                 & (bx <= bounds[0][1]) & (bx >= bounds[0][0])
                 & (by <= bounds[1][1]) & (by >= bounds[1][0]))
        return img_pts, tops, bots, valid

    def scale(self, original_bounds, new_bounds=None):
        """Compose the world -> [-1, 1]^3 similarity into P and re-derive
        the sun vector in the cube."""
        if new_bounds is None:
            new_bounds = np.array([[-1.0, 1], [-1, 1], [-1, 1]])
        original_bounds = np.asarray(original_bounds, dtype=np.float64)
        S = units.make_similarity(original_bounds, new_bounds)
        S_inv = np.linalg.inv(S)
        P = self.P @ S_inv
        P = P / P[-1, -1]
        area_center = np.mean(original_bounds, 1)
        ans = units.lla_get_vec(area_center, self.sun_el_az[1],
                                self.sun_el_az[0])
        temp = (S @ np.array([ans[0], ans[1], ans[2], 1.0]))[:3]
        sun_vec = temp / np.sqrt(np.sum(temp ** 2))
        return replace(self, P=P, S=S, S_inv=S_inv, sun_vec=sun_vec,
                       scaled=True)

    def get_world_center(self):
        c = self.S_inv @ np.array([0.0, 0, 0, 1])
        return c[:3] / c[3]

    def world_angle_2_local_vec(self, el, az):
        return units.world_angle_2_local_vec(el, az, self.get_world_center(),
                                             self.S)

    @property
    def time_enc(self):
        tf, df = self.time_frac, self.day_frac
        return np.array([np.cos(2 * np.pi * tf), np.sin(2 * np.pi * tf),
                         np.cos(2 * np.pi * df), np.sin(2 * np.pi * df)])


def fit_camera_from_rpc(rpc: RPCModel, img_shape, h_min, h_max, name="cam",
                        n_train=10, affine=False, method="chebyshev"):
    """The 3x4 camera (projective, or affine with ``affine``) fitted to an
    RPC over a Chebyshev (or uniform) grid of its image and heights."""
    grid = chebyshev_grid if method == "chebyshev" else uniform_grid
    r, c, z = grid(img_shape, h_min, h_max, n_train)
    lat, lon, h = rpc.localize(r, c, z)
    P = fit_projective_dlt(lat, lon, h, r, c, affine=affine)
    return Camera(name=name, P=P, img_shape=tuple(img_shape), rpc=rpc)


def test_accuracy(cam: Camera, h_min, h_max, n_test=50):
    """Reprojection error of the 3x4 camera against its exact RPC on a
    uniform grid -> (mean, std, min, max) in pixels."""
    if cam.rpc is None:
        raise ValueError(f"camera {cam.name} has no RPC to check against")
    r, c, z = uniform_grid(cam.img_shape, h_min, h_max, n_test)
    lat, lon, h = cam.rpc.localize(r, c, z)
    r_gt, c_gt = cam.rpc.project(lat, lon, h)
    if cam.scaled:
        hom = np.stack([lat, lon, h, np.ones_like(lat)], 0)
        local = cam.S @ hom
        lat, lon, h = (local[0] / local[3], local[1] / local[3],
                       local[2] / local[3])
    r_est, c_est = cam.project(lat, lon, h)
    err = np.sqrt((r_est - r_gt) ** 2 + (c_est - c_gt) ** 2)
    return (float(np.mean(err)), float(np.std(err)), float(np.min(err)),
            float(np.max(err)))


def find_bounds(cameras, h_bounds, shrink_iters=40):
    """The largest lat/lon box, centred on the intersection of the
    footprints at both heights, whose corners project inside every image
    (a bisection on its half-span) -> [[lat0, lat1], [lon0, lon1], [h0,
    h1]]."""
    h_min, h_max = h_bounds
    lo = np.array([-np.inf, -np.inf])
    hi = np.array([np.inf, np.inf])
    for cam in cameras:
        rows = np.array([0, 0, cam.img_shape[0] - 1, cam.img_shape[0] - 1],
                        dtype=np.float64)
        cols = np.array([0, cam.img_shape[1] - 1, 0, cam.img_shape[1] - 1],
                        dtype=np.float64)
        for h in (h_min, h_max):
            if cam.rpc is not None:
                lat, lon, _ = cam.rpc.localize(rows, cols,
                                               np.full(4, float(h)))
            else:
                lat, lon, _ = cam.backproject(rows, cols, float(h))
            lo = np.maximum(lo, [np.min(lat), np.min(lon)])
            hi = np.minimum(hi, [np.max(lat), np.max(lon)])

    center = (lo + hi) / 2
    half = (hi - lo) / 2

    def all_inside(half_span):
        cl = center - half_span
        ch = center + half_span
        lats = np.array([cl[0], cl[0], ch[0], ch[0]] * 2)
        lons = np.array([cl[1], ch[1], cl[1], ch[1]] * 2)
        hs = np.array([h_min] * 4 + [h_max] * 4)
        for cam in cameras:
            if cam.rpc is not None:
                r, c = cam.rpc.project(lats, lons, hs)
            else:
                r, c = cam.project(lats, lons, hs)
            if (np.any(r < 0) or np.any(r > cam.img_shape[0] - 1)
                    or np.any(c < 0) or np.any(c > cam.img_shape[1] - 1)):
                return False
        return True

    scale_lo, scale_hi = 0.0, 1.0
    for _ in range(shrink_iters):
        mid = (scale_lo + scale_hi) / 2
        if all_inside(half * mid):
            scale_lo = mid
        else:
            scale_hi = mid
    half = half * scale_lo
    return np.array([[center[0] - half[0], center[0] + half[0]],
                     [center[1] - half[1], center[1] + half[1]],
                     [h_min, h_max]])
