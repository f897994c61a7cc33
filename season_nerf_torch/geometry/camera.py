"""Projective satellite cameras (numpy, host side).

The counterpart of the projective half of
``season_nerf_tpu/geometry/camera.py``: a camera is a dataclass of numpy
arrays, and projection and back-projection at a fixed height are closed
forms vectorized over whole pixel grids.  Fitting a camera to an RPC model
and scaling a site into the cube are not ported yet (real sites).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


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
    rpc: Optional[object] = None
    scaled: bool = False
    image: Optional[np.ndarray] = None

    def project(self, x, y, z):
        return project_P(self.P, x, y, z)

    def backproject(self, row, col, h):
        return backproject_P(self.P, row, col, h)

    def pixel_rays(self):
        """Every pixel's ray, from the top (z = 1) to the bottom (z = -1) of
        the cube -> (img_pts [N, 2], tops [N, 3], bots [N, 3], valid [N]);
        ``valid`` marks rays whose two ends stay inside the cube's x and y
        bounds."""
        RR, CC = np.meshgrid(np.arange(self.img_shape[0]),
                             np.arange(self.img_shape[1]), indexing="ij")
        img_pts = np.stack([RR.ravel(), CC.ravel()], -1)
        r, c = img_pts[:, 0], img_pts[:, 1]
        tops = np.stack(self.backproject(r, c, 1.0), -1)
        bots = np.stack(self.backproject(r, c, -1.0), -1)
        valid = np.all(np.abs(np.concatenate([tops[:, :2], bots[:, :2]], 1))
                       <= 1.0, axis=1)
        return img_pts, tops, bots, valid

    @property
    def time_enc(self):
        tf, df = self.time_frac, self.day_frac
        return np.array([np.cos(2 * np.pi * tf), np.sin(2 * np.pi * tf),
                         np.cos(2 * np.pi * df), np.sin(2 * np.pi * df)])
