"""Overview figures of a site's data and of a model's season grid.

The counterpart of ``season_nerf_tpu/eval/summary_images.py``:
- ``angle_scatter``: the view and sun angles of the cameras;
- ``proto_time_plot``: the capture times on a year clock and the
  prototype images;
- ``season_sun_grid``: renders over sun angles x times of year;
- ``best_time_match``: the render time whose colours are nearest (EM) a
  target image.

The JAX package draws them with matplotlib; here each figure is raster
panels written by ``utils/png.py``.  A polar plot is a disc: the radius is
90 - elevation (the centre is the zenith, the rim the horizon) and the
angle the azimuth, counter-clockwise from the right as matplotlib's polar
axes draw it; test cameras are red dots, training cameras blue dots, walk
points green crosses.  Titles and tick labels are not drawn.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from season_nerf_torch.eval.emd import color_signature, emd_exact
from season_nerf_torch.eval.img_eval import _resize
from season_nerf_torch.utils.png import write_panels

# matplotlib's tab:red, tab:blue and tab:green
RED = (0.839, 0.153, 0.157)
BLUE = (0.122, 0.467, 0.706)
GREEN = (0.173, 0.627, 0.173)
DISC_PX = 241                   # a polar panel's side (odd: a centre pixel)
_RIM = 8                        # px between the disc and the panel's edge
_MARK = 4                       # a marker's radius, px


def _disc(rings=(1 / 3, 2 / 3, 1.0), ticks: int = 0) -> np.ndarray:
    """A white panel with a light disc, grey rings at the given fractions of
    its radius and ``ticks`` short marks on the rim."""
    c, R = (DISC_PX - 1) / 2, (DISC_PX - 1) / 2 - _RIM
    y, x = np.mgrid[:DISC_PX, :DISC_PX]
    r = np.hypot(x - c, y - c)
    img = np.ones((DISC_PX, DISC_PX, 3))
    img[r <= R] = 0.95
    for f in rings:
        img[np.abs(r - f * R) < 0.6] = 0.7
    ang = np.arctan2(c - y, x - c) % (2 * np.pi)
    for k in range(ticks):
        a = 2 * np.pi * k / ticks
        d = np.abs((ang - a + np.pi) % (2 * np.pi) - np.pi) * r
        img[(d < 0.7) & (r > R - 6) & (r <= R)] = 0.4
    return img


def _polar_xy(radius_frac, theta):
    """A polar point (radius as a fraction of the disc's, angle in radians
    counter-clockwise from the right) -> (column, row) in the panel."""
    c, R = (DISC_PX - 1) / 2, (DISC_PX - 1) / 2 - _RIM
    return (c + R * radius_frac * np.cos(theta),
            c - R * radius_frac * np.sin(theta))


def _dot(img, xy, rgb):
    y, x = np.mgrid[:img.shape[0], :img.shape[1]]
    img[np.hypot(x - xy[0], y - xy[1]) <= _MARK] = rgb


def _cross(img, xy, rgb):
    y, x = np.mgrid[:img.shape[0], :img.shape[1]]
    dx, dy = np.abs(x - xy[0]), np.abs(y - xy[1])
    img[(np.abs(dx - dy) <= 0.6) & (np.maximum(dx, dy) <= _MARK)] = rgb


def _angle_disc(angles_el_az, colors, walk=None) -> np.ndarray:
    """Dots at (el, az) with their colours, crosses at the walk points."""
    img = _disc()
    for (el, az), rgb in zip(angles_el_az, colors):
        _dot(img, _polar_xy((90 - el) / 90, np.deg2rad(az)), rgb)
    if walk is not None and len(walk):
        for el, az in np.asarray(walk):
            _cross(img, _polar_xy((90 - el) / 90, np.deg2rad(az)), GREEN)
    return img


def angle_scatter(cams: Sequence, test_idx: Sequence[int], output_path: str,
                  walk_view: Optional[np.ndarray] = None,
                  walk_sun: Optional[np.ndarray] = None):
    """Two discs, the cameras' view angles and their sun angles (red: test,
    blue: training), with the walk points, as a PNG."""
    test_idx = set(test_idx)
    colors = [RED if i in test_idx else BLUE for i in range(len(cams))]
    write_panels([[
        _angle_disc([c.view_el_az for c in cams], colors, walk_view),
        _angle_disc([c.sun_el_az for c in cams], colors, walk_sun)]],
        output_path)


def proto_time_plot(cams: Sequence, train_idx, test_idx, proto_idx,
                    walk_times: np.ndarray, output_path: str):
    """A year clock (January to the right, counter-clockwise, a tick a
    month) with the capture times on the rim (blue: training, red: test)
    and the walk times as crosses inside it, then the prototype images at
    the clock's height, as a PNG."""
    img = _disc(rings=(1.0,), ticks=12)
    for idx_set, rgb in ((train_idx, BLUE), (test_idx, RED)):
        for i in idx_set:
            _dot(img, _polar_xy(1.0, 2 * np.pi * cams[i].time_frac), rgb)
    for t in np.atleast_1d(walk_times):
        _cross(img, _polar_xy(0.8, 2 * np.pi * t), GREEN)
    panels = [img]
    for i in proto_idx:
        im = cams[i].image
        if im is None:
            panels.append(np.ones((DISC_PX, DISC_PX, 3)))
            continue
        im = np.clip(np.asarray(im, np.float32), 0, 1)
        w = max(1, round(im.shape[1] * DISC_PX / im.shape[0]))
        panels.append(_resize(im, (DISC_PX, w)))
    write_panels([panels], output_path)


def season_sun_grid(renderer, times: Sequence[float],
                    sun_angles: Sequence, view_el_az, out_size: int,
                    output_path: str, angles_to_vec=None):
    """Renders of ``view_el_az`` over sun angles (rows) x times (columns)
    as one PNG grid -> ``output_path``."""
    rows = [[np.clip(renderer.render_img(
        view_el_az, tuple(sun), float(t), out_size,
        angles_to_vec=angles_to_vec)["Col_Img"], 0, 1) for t in times]
        for sun in sun_angles]
    write_panels(rows, output_path)
    return output_path


def best_time_match(renderer, target_img: np.ndarray, view_el_az, sun_el_az,
                    out_size: int, n_times: int = 26, angles_to_vec=None):
    """The render time (of ``n_times`` over the year) whose colours are
    nearest the target's by exact EM -> (best time, its render, the
    distance at every time)."""
    target_sig = color_signature(target_img)
    ts = np.linspace(0, 1, n_times, endpoint=False)
    best = (None, None, np.inf)
    dists = []
    for t in ts:
        out = renderer.render_img(view_el_az, sun_el_az, float(t), out_size,
                                  angles_to_vec=angles_to_vec)
        sig = color_signature(out["Col_Img"])
        d = emd_exact(target_sig, sig)
        dists.append(d)
        if d < best[2]:
            best = (float(t), out["Col_Img"], d)
    return best[0], best[1], np.array(dists)
