"""Walking points for the evaluation sweeps.

The counterpart of ``season_nerf_tpu/eval/walks.py``: view spirals,
sun-angle walks fitted to the site's elevation-azimuth relation, times
kept near the captures, and the angle grids of the shadow tests
(training / testing / near-training / full).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def get_walking_points(cams: Sequence, n_view: int, n_sun: int, n_time: int,
                       min_day_sep: float = 20.0):
    """(walk_view [V,2], walk_sun [S,2], walk_times [T]) el/az degrees.

    View: spiral from nadir down to the dataset's min elevation over a full
    azimuth turn.  Sun: cubic poly fit az(el) through the dataset sun
    angles, walked over the el range +-5 deg.  Times: uniform year fractions
    kept only within ``min_day_sep`` days of a training capture.
    """
    sun = np.array([c.sun_el_az for c in cams], float)
    view = np.array([c.view_el_az for c in cams], float)
    times = np.array([c.time_frac for c in cams], float)

    min_el = max(sun[:, 0].min() - 5.0, 0.0)
    max_el = min(sun[:, 0].max() + 5.0, 90.0)
    deg = min(3, len(cams) - 1) if len(cams) > 1 else 0
    coeffs = np.polyfit(sun[:, 0], sun[:, 1], deg=max(deg, 0)) \
        if len(cams) > 1 else np.array([sun[0, 1]])
    gen = np.poly1d(coeffs)
    sun_el = np.linspace(min_el, max_el, n_sun)
    walk_sun = np.stack([sun_el, gen(sun_el)], 1)

    walk_times = np.linspace(0, 1, n_time, endpoint=False)
    thresh = min_day_sep / 365.24
    if min_day_sep > 0:
        n = 1
        while True:
            d = np.abs(walk_times[:, None] - times[None, :])
            d = np.minimum(d, 1.0 - d).min(1)
            good = d <= thresh
            if good.sum() >= min(n_time, len(walk_times)) or n > 1000:
                break
            walk_times = np.linspace(0, 1, n_time + n, endpoint=False)
            n += 1
        walk_times = walk_times[good]

    min_view = max(view[:, 0].min() - 5.0, 0.0)
    view_el = np.linspace(90, min_view, n_view + 1)[1:]
    view_az = np.linspace(0, 360, n_view)
    walk_view = np.stack([view_el, view_az], 1)
    return walk_view, walk_sun, walk_times


def shadow_walk_points(train_cams: Sequence, test_cams: Sequence,
                       points_in_space: int = 16,
                       points_across_angles: int = 6,
                       thresh: float = 5.0):
    """Angle sets for the shadow verification walks.

    Returns dict with Training / Testing / Near_Walk / Full_Walk sun-angle
    arrays [K, 2] and the (x, y) ground grid [G, 2].
    """
    train_sun = np.array([c.sun_el_az for c in train_cams], float)
    test_sun = np.array([c.sun_el_az for c in test_cams], float) \
        if test_cams else np.zeros((0, 2))

    # near-walk: grid points within `thresh` degrees of a training angle
    near = np.zeros((0, 2))
    c = 0
    while near.shape[0] < points_across_angles ** 2 and c < 64:
        g = np.stack(np.meshgrid(
            np.linspace(train_sun[:, 0].min() - thresh,
                        train_sun[:, 0].max() + thresh,
                        points_across_angles + c),
            np.linspace(train_sun[:, 1].min() - thresh,
                        train_sun[:, 1].max() + thresh,
                        points_across_angles + c),
            indexing="ij"), -1).reshape(-1, 2)
        d = np.sqrt(((g[:, None] - train_sun[None]) ** 2).sum(-1)).min(1)
        near = g[d < thresh]
        c += 1

    full = np.stack(np.meshgrid(
        np.linspace(5, 90, points_across_angles),
        np.linspace(0, 360, points_across_angles, endpoint=False),
        indexing="ij"), -1).reshape(-1, 2)

    ground = np.stack(np.meshgrid(
        np.linspace(-1, 1, points_in_space),
        np.linspace(-1, 1, points_in_space),
        indexing="ij"), -1).reshape(-1, 2)

    return {"Training": train_sun, "Testing": test_sun, "Near_Walk": near,
            "Full_Walk": full, "Ground_Points": ground}
