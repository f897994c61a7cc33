"""Natural cubic splines with constant-speed (arc-length) reparametrization.

The counterpart of ``season_nerf_tpu/geometry/spline.py``, for the movie
maker's camera paths: scipy's ``CubicSpline`` and the same float64
arc-length table, so both packages sample a script at the same points.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline


class Spline3:
    """Natural cubic spline through 3-D (or N-D) keyframe points, queryable
    by either parameter ``t`` in [0, 1] or by normalized arc length."""

    def __init__(self, points, n_arc_samples=2048):
        points = np.asarray(points, dtype=np.float64)
        if points.ndim == 1:
            points = points[:, None]
        self.points = points
        self._t_knots = np.linspace(0, 1, points.shape[0])
        self._cs = CubicSpline(self._t_knots, points, bc_type="natural")
        # arc-length table for constant-speed traversal
        ts = np.linspace(0, 1, n_arc_samples)
        xs = self._cs(ts)
        seg = np.sqrt(np.sum(np.diff(xs, axis=0) ** 2, axis=1))
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        self.total_length = float(arc[-1])
        self._arc_norm = arc / max(arc[-1], 1e-12)
        self._ts = ts

    def at(self, t):
        """Evaluate at spline parameter t in [0, 1]."""
        return self._cs(np.clip(t, 0.0, 1.0))

    def at_arc(self, s):
        """Evaluate at normalized arc length s in [0, 1] (constant speed)."""
        t = np.interp(np.clip(s, 0.0, 1.0), self._arc_norm, self._ts)
        return self._cs(t)

    def derivative(self, t):
        return self._cs(np.clip(t, 0.0, 1.0), 1)
