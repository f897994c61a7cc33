"""HSLuv <-> sRGB, pure numpy float64 and vectorized.

``season_nerf_tpu/utils/hsluv.py`` in both directions.  With ``use_HSLuv``
the ray table stores each pixel's color as normalized HSLuv
(:func:`rgb_to_hsluv_normalized`, ``data/rays.build_ray_table``), the model
learns and renders in that space, and the renderer and the validation
report convert composited colors back to sRGB
(:func:`hsluv_normalized_to_rgb`).
"""

from __future__ import annotations

import numpy as np

# XYZ (D65) -> linear sRGB, and back
_M = np.array([[3.240969941904521, -1.537383177570093, -0.498610760293],
               [-0.96924363628087, 1.87596750150772, 0.041555057407175],
               [0.055630079696993, -0.20397695888897, 1.056971514242878]])
_M_INV = np.linalg.inv(_M)
_REF_U = 0.19783000664283
_REF_V = 0.46831999493879
_KAPPA = 903.2962962
_EPSILON = 0.0088564516


def _to_linear(c):
    c = np.asarray(c, np.float64)
    return np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _from_linear(c):
    return np.where(c > 0.0031308, 1.055 * np.maximum(c, 1e-12) ** (1 / 2.4)
                    - 0.055, 12.92 * c)


def _y_to_l(y):
    return np.where(y <= _EPSILON, y * _KAPPA,
                    116 * np.maximum(y, 1e-12) ** (1 / 3.0) - 16)


def _l_to_y(l):
    return np.where(l <= 8, l / _KAPPA, ((l + 16) / 116) ** 3)


def _bounds(l):
    """Chroma bounds: 6 lines per lightness (getBounds).  l: [...]."""
    sub1 = ((l + 16) ** 3) / 1560896
    sub2 = np.where(sub1 > _EPSILON, sub1, l / _KAPPA)
    lines = []
    for c in range(3):
        m1, m2, m3 = _M[c]
        for t in (0, 1):
            top1 = (284517 * m1 - 94839 * m3) * sub2
            top2 = ((838422 * m3 + 769860 * m2 + 731718 * m1) * l * sub2
                    - 769860 * t * l)
            bottom = (632260 * m3 - 126452 * m2) * sub2 + 126452 * t
            lines.append((top1 / bottom, top2 / bottom))
    return lines


def _max_chroma(l, h):
    """Max in-gamut chroma for (L, H degrees) (maxChromaForLH)."""
    hrad = np.deg2rad(h)
    s, c = np.sin(hrad), np.cos(hrad)
    best = np.full(np.shape(l), np.inf)
    for slope, intercept in _bounds(l):
        denom = s - slope * c
        length = np.where(np.abs(denom) > 1e-12,
                          intercept / denom, np.inf)
        best = np.where((length >= 0) & (length < best), length, best)
    return best


def rgb_to_hsluv(rgb):
    """[..., 3] sRGB in [0, 1] -> HSLuv (H in [0, 360), S, L in [0, 100])."""
    rgb = np.clip(np.asarray(rgb, np.float64), 0, 1)
    xyz = _to_linear(rgb) @ _M_INV.T
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    l = _y_to_l(y)
    div = x + 15 * y + 3 * z
    div = np.where(div == 0, 1e-12, div)
    u = 13 * l * (4 * x / div - _REF_U)
    v = 13 * l * (9 * y / div - _REF_V)
    c = np.hypot(u, v)
    h = np.rad2deg(np.arctan2(v, u)) % 360
    mx = _max_chroma(l, h)
    s = np.where((l > 99.9999) | (l < 1e-8), 0.0,
                 np.clip(c / np.where(mx > 0, mx, 1e-12) * 100, 0, 100))
    return np.stack([h, s, np.clip(l, 0, 100)], axis=-1)


def hsluv_to_rgb(hsl):
    """HSLuv (H in [0, 360), S, L in [0, 100]) -> sRGB in [0, 1]."""
    hsl = np.asarray(hsl, np.float64)
    h, s, l = hsl[..., 0], hsl[..., 1], hsl[..., 2]
    mx = _max_chroma(l, h)
    c = mx / 100 * s
    hrad = np.deg2rad(h)
    u = np.cos(hrad) * c
    v = np.sin(hrad) * c
    y = _l_to_y(l)
    l13 = np.where(l == 0, 1e-12, 13 * l)
    var_u = u / l13 + _REF_U
    var_v = v / l13 + _REF_V
    x = np.where(l == 0, 0.0,
                 -(9 * y * var_u) / ((var_u - 4) * var_v - var_u * var_v))
    z = np.where(l == 0, 0.0,
                 (9 * y - (15 * var_v * y) - (var_v * x)) / (3 * var_v))
    xyz = np.stack([x, y, z], axis=-1)
    lin = xyz @ _M.T
    return np.clip(_from_linear(lin), 0, 1)


def rgb_to_hsluv_normalized(rgb):
    """sRGB -> HSLuv scaled to [0, 1] channels (the training targets)."""
    return rgb_to_hsluv(rgb) / np.array([360.0, 100.0, 100.0])


def hsluv_normalized_to_rgb(hsl01):
    """HSLuv scaled to [0, 1] channels (the training targets) -> sRGB."""
    return hsluv_to_rgb(np.asarray(hsl01) * np.array([360.0, 100.0, 100.0]))
