"""Rational polynomial camera (RPC) model (numpy float64, host side).

The counterpart of ``season_nerf_tpu/geometry/rpc.py``, with the same
formulas and iteration counts:

- :class:`RPCModel`: the standard 78-coefficient model, normalized cubic
  rational polynomials, vectorized ``project`` and the Newton ``localize``
  (image + height -> ground) on a finite-difference Jacobian;
- :func:`parse_rpc_file`: RPB (``key = value;``) and IKONOS / ``_RPC.TXT``
  (``KEY_n: value``) coefficient files;
- :func:`fit_rpc_from_projector`: RPC coefficients fitted to any projection
  function by linear least squares.

RPCs are used at preprocessing time only, to fit the 3x4 cameras; float64
throughout, since latitudes near 39 degrees and scales of order 1e-3 leave
float32 a sizeable part of a pixel.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

# Ordering of the 20 cubic monomials — the standard RPC00B term order used
# by GeoEye/DigitalGlobe metadata.  With P = lat_n, L = lon_n, H = alt_n:
_TERM_EXPONENTS = [
    (0, 0, 0),  # 1
    (0, 1, 0),  # L
    (1, 0, 0),  # P
    (0, 0, 1),  # H
    (1, 1, 0),  # L*P
    (0, 1, 1),  # L*H
    (1, 0, 1),  # P*H
    (0, 2, 0),  # L^2
    (2, 0, 0),  # P^2
    (0, 0, 2),  # H^2
    (1, 1, 1),  # P*L*H
    (0, 3, 0),  # L^3
    (2, 1, 0),  # L*P^2
    (0, 1, 2),  # L*H^2
    (1, 2, 0),  # L^2*P
    (3, 0, 0),  # P^3
    (1, 0, 2),  # P*H^2
    (0, 2, 1),  # L^2*H
    (2, 0, 1),  # P^2*H
    (0, 0, 3),  # H^3
]


def monomials(lat_n, lon_n, alt_n):
    """[N, 20] matrix of RPC00B cubic monomials of the normalized coords."""
    lat_n = np.asarray(lat_n, dtype=np.float64).ravel()
    lon_n = np.asarray(lon_n, dtype=np.float64).ravel()
    alt_n = np.asarray(alt_n, dtype=np.float64).ravel()
    cols = [lat_n ** p * lon_n ** l * alt_n ** h for (p, l, h) in _TERM_EXPONENTS]
    return np.stack(cols, axis=-1)


@dataclass
class RPCModel:
    """Standard RPC sensor model.

    ``row`` is the image line, ``col`` the image sample.  Offsets/scales
    normalize ground and image coordinates to roughly [-1, 1].
    """
    row_num: np.ndarray
    row_den: np.ndarray
    col_num: np.ndarray
    col_den: np.ndarray
    lat_offset: float
    lat_scale: float
    lon_offset: float
    lon_scale: float
    alt_offset: float
    alt_scale: float
    row_offset: float
    row_scale: float
    col_offset: float
    col_scale: float

    def project(self, lat, lon, alt):
        """(lat, lon, alt) -> (row, col).  Vectorized."""
        shape = np.broadcast(np.asarray(lat), np.asarray(lon), np.asarray(alt)).shape
        p = (np.asarray(lat, dtype=np.float64) - self.lat_offset) / self.lat_scale
        l = (np.asarray(lon, dtype=np.float64) - self.lon_offset) / self.lon_scale
        h = (np.asarray(alt, dtype=np.float64) - self.alt_offset) / self.alt_scale
        M = monomials(np.broadcast_to(p, shape), np.broadcast_to(l, shape),
                      np.broadcast_to(h, shape))
        row_n = (M @ self.row_num) / (M @ self.row_den)
        col_n = (M @ self.col_num) / (M @ self.col_den)
        row = row_n.reshape(shape) * self.row_scale + self.row_offset
        col = col_n.reshape(shape) * self.col_scale + self.col_offset
        return row, col

    def localize(self, row, col, alt, n_iter=20, tol=1e-10):
        """(row, col, alt) -> (lat, lon, alt): invert the RPC at a fixed
        height by Newton steps on the 2x2 finite-difference Jacobian, from
        the offset point.  The early exit tests the largest residual over
        all points."""
        row = np.asarray(row, dtype=np.float64)
        col = np.asarray(col, dtype=np.float64)
        alt = np.broadcast_to(np.asarray(alt, dtype=np.float64), row.shape).copy()
        lat = np.full_like(row, self.lat_offset, dtype=np.float64)
        lon = np.full_like(row, self.lon_offset, dtype=np.float64)
        eps_lat = self.lat_scale * 1e-6
        eps_lon = self.lon_scale * 1e-6
        for _ in range(n_iter):
            r0, c0 = self.project(lat, lon, alt)
            dr, dc = row - r0, col - c0
            if np.max(np.abs(dr)) < tol and np.max(np.abs(dc)) < tol:
                break
            r_la, c_la = self.project(lat + eps_lat, lon, alt)
            r_lo, c_lo = self.project(lat, lon + eps_lon, alt)
            # Jacobian entries
            j11 = (r_la - r0) / eps_lat  # d row / d lat
            j12 = (r_lo - r0) / eps_lon  # d row / d lon
            j21 = (c_la - c0) / eps_lat
            j22 = (c_lo - c0) / eps_lon
            det = j11 * j22 - j12 * j21
            det = np.where(np.abs(det) < 1e-18, 1e-18, det)
            lat = lat + (j22 * dr - j12 * dc) / det
            lon = lon + (-j21 * dr + j11 * dc) / det
        return lat, lon, alt

    # ---- serialization ----------------------------------------------------
    def to_dict(self):
        d = {k: (v.tolist() if isinstance(v, np.ndarray) else float(v))
             for k, v in self.__dict__.items()}
        return d

    @classmethod
    def from_dict(cls, d):
        kw = dict(d)
        for k in ("row_num", "row_den", "col_num", "col_den"):
            kw[k] = np.asarray(kw[k], dtype=np.float64)
        return cls(**kw)


_KEY_ALIASES = {
    "linenumcoef": "row_num", "linedencoef": "row_den",
    "sampnumcoef": "col_num", "sampdencoef": "col_den",
    "lineoffset": "row_offset", "linescale": "row_scale",
    "sampoffset": "col_offset", "sampscale": "col_scale",
    "latoffset": "lat_offset", "latscale": "lat_scale",
    "longoffset": "lon_offset", "longscale": "lon_scale",
    "heightoffset": "alt_offset", "heightscale": "alt_scale",
    # IKONOS / _RPC.TXT style
    "linenumcoeff": "row_num", "linedencoeff": "row_den",
    "sampnumcoeff": "col_num", "sampdencoeff": "col_den",
    "lineoff": "row_offset", "sampoff": "col_offset",
    "latoff": "lat_offset", "longoff": "lon_offset", "heightoff": "alt_offset",
}


def parse_rpc_file(path_or_text):
    """Parse an RPB or IKONOS-style RPC text (a path or the text itself)
    into an :class:`RPCModel`: both ``key = value;`` (RPB) and ``KEY_n:
    value`` (``_RPC.TXT``, ``.ikono``) layouts, units ignored."""
    if "\n" in str(path_or_text) or ":" in str(path_or_text)[:200] and "=" in str(path_or_text)[:200]:
        text = str(path_or_text)
    else:
        try:
            with open(path_or_text, "r") as fin:
                text = fin.read()
        except (OSError, ValueError):
            text = str(path_or_text)

    scalars = {}
    vectors = {}
    # RPB style: key = value; and lists in parentheses
    for m in re.finditer(r"(\w+)\s*=\s*\(([^)]*)\)", text, re.S):
        key = m.group(1).lower().replace("_", "")
        vals = [float(v) for v in re.split(r"[,\s]+", m.group(2).strip()) if v]
        vectors[key] = np.array(vals)
    for m in re.finditer(r"(\w+)\s*=\s*([-+0-9.eE]+)\s*;", text):
        key = m.group(1).lower().replace("_", "")
        scalars[key] = float(m.group(2))
    # _RPC.TXT style: LINE_NUM_COEFF_1: val
    coeff_lists = {}
    for m in re.finditer(r"([A-Za-z_]+?)_?(\d+)?\s*:\s*([-+0-9.eE]+)", text):
        key = m.group(1).lower().replace("_", "")
        if m.group(2) is not None:
            coeff_lists.setdefault(key, {})[int(m.group(2))] = float(m.group(3))
        else:
            scalars.setdefault(key, float(m.group(3)))
    for key, d in coeff_lists.items():
        vectors[key] = np.array([d[i] for i in sorted(d)])

    fields = {}
    for src, dst in _KEY_ALIASES.items():
        if src in vectors:
            fields[dst] = vectors[src]
        elif src in scalars and dst not in fields:
            fields[dst] = scalars[src]
    missing = {f for f in RPCModel.__dataclass_fields__} - set(fields)
    if missing:
        raise ValueError(f"RPC file missing fields: {sorted(missing)}")
    return RPCModel(**fields)


def fit_rpc_from_projector(project_fn, lat_range, lon_range, alt_range,
                           n_grid=12, degree_terms=None):
    """Fit RPC coefficients to any ``project_fn(lat, lon, alt) -> (row,
    col)`` over an ``n_grid``^3 grid of the given ranges: linear least
    squares on the rational form, 39 unknowns a coordinate (20 numerator
    terms, 19 denominator terms with den[0] fixed to 1)."""
    lats = np.linspace(*lat_range, n_grid)
    lons = np.linspace(*lon_range, n_grid)
    alts = np.linspace(*alt_range, n_grid)
    G = np.stack(np.meshgrid(lats, lons, alts, indexing="ij"), -1).reshape(-1, 3)
    rows, cols = project_fn(G[:, 0], G[:, 1], G[:, 2])
    rows, cols = np.asarray(rows, dtype=np.float64), np.asarray(cols, dtype=np.float64)

    lat_off, lat_sc = np.mean(lat_range), max((lat_range[1] - lat_range[0]) / 2, 1e-9)
    lon_off, lon_sc = np.mean(lon_range), max((lon_range[1] - lon_range[0]) / 2, 1e-9)
    alt_off, alt_sc = np.mean(alt_range), max((alt_range[1] - alt_range[0]) / 2, 1e-9)
    row_off, row_sc = np.mean(rows), max(np.max(np.abs(rows - np.mean(rows))), 1e-9)
    col_off, col_sc = np.mean(cols), max(np.max(np.abs(cols - np.mean(cols))), 1e-9)

    p = (G[:, 0] - lat_off) / lat_sc
    l = (G[:, 1] - lon_off) / lon_sc
    h = (G[:, 2] - alt_off) / alt_sc
    M = monomials(p, l, h)

    def solve(target_n):
        # target_n = (M @ num) / (M @ den), den[0] = 1
        # => M @ num - target_n * (M[:,1:] @ den[1:]) = target_n
        A = np.concatenate([M, -target_n[:, None] * M[:, 1:]], axis=1)
        coef, *_ = np.linalg.lstsq(A, target_n, rcond=None)
        num = coef[:20]
        den = np.concatenate([[1.0], coef[20:]])
        return num, den

    rn, rd = solve((rows - row_off) / row_sc)
    cn, cd = solve((cols - col_off) / col_sc)
    return RPCModel(row_num=rn, row_den=rd, col_num=cn, col_den=cd,
                    lat_offset=float(lat_off), lat_scale=float(lat_sc),
                    lon_offset=float(lon_off), lon_scale=float(lon_sc),
                    alt_offset=float(alt_off), alt_scale=float(alt_sc),
                    row_offset=float(row_off), row_scale=float(row_sc),
                    col_offset=float(col_off), col_scale=float(col_sc))
