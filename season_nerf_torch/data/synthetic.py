"""Synthetic Season-NeRF sites: ground truth for tests and the card check.

The counterpart of ``season_nerf_tpu/data/synthetic.py``, with the same
numpy arithmetic and seeds, so both packages build the same site: a height
field with buildings, near-nadir projective cameras, per-view sun angles
with ray-marched cast shadows and sky light, a seasonal tint of the albedo,
and a noisy prior DSM standing in for space carving.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from season_nerf_torch.data.rays import build_ray_table, train_test_split
from season_nerf_torch.geometry.camera import Camera
from season_nerf_torch.geometry.units import elevation_azimuth_to_vec


def make_heightmap(grid=128, seed=0, n_buildings=6):
    """[G, G] heights over the cube footprint, about [-0.6, 0.4]: rolling
    ground and rectangular buildings."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-1, 1, grid)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    ground = -0.5 + 0.06 * np.sin(2.1 * X + 0.5) * np.cos(1.7 * Y - 0.3)
    hm = ground.copy()
    for _ in range(n_buildings):
        cx, cy = rng.uniform(-0.7, 0.7, 2)
        w, h = rng.uniform(0.08, 0.3, 2)
        height = rng.uniform(0.15, 0.8)
        box = ((np.abs(X - cx) < w) & (np.abs(Y - cy) < h))
        hm = np.where(box, ground + height, hm)
    return hm.astype(np.float32)


def hm_lookup(hm, x, y):
    """Nearest-cell height at cube coordinates (the prior's indexing)."""
    g = hm.shape[0]
    xi = np.clip(((np.asarray(x) + 1) / 2 * (g - 1)).astype(int), 0, g - 1)
    yi = np.clip(((np.asarray(y) + 1) / 2 * (hm.shape[1] - 1)).astype(int),
                 0, hm.shape[1] - 1)
    return hm[xi, yi]


def surface_hit(tops, bots, hm, n_march=256):
    """First crossing of each ray below the height field -> (hit [N, 3],
    hit_mask [N]): the first marched sample below the terrain, linearly
    interpolated with the one before."""
    ts = np.linspace(0.0, 1.0, n_march)[None, :, None]
    pts = tops[:, None, :] * (1 - ts) + bots[:, None, :] * ts
    terrain = hm_lookup(hm, pts[..., 0], pts[..., 1])
    below = pts[..., 2] <= terrain
    first = np.argmax(below, axis=1)
    hit_mask = below.any(axis=1)
    i0 = np.maximum(first - 1, 0)
    n = np.arange(tops.shape[0])
    p_lo, p_hi = pts[n, i0], pts[n, first]
    z_lo = p_lo[:, 2] - terrain[n, i0]
    z_hi = p_hi[:, 2] - terrain[n, first]
    w = np.where(np.abs(z_lo - z_hi) > 1e-9,
                 z_lo / np.maximum(z_lo - z_hi, 1e-9), 0.0)
    w = np.clip(w, 0, 1)[:, None]
    return p_lo * (1 - w) + p_hi * w, hit_mask


def shadowed(pts, sun_vec, hm, n_march=128, eps=2e-2):
    """True where the terrain blocks the sun from a point."""
    span = 2.2 / max(sun_vec[2], 1e-3)
    ts = np.linspace(eps, span, n_march)[None, :, None]
    ray = pts[:, None, :] + ts * sun_vec[None, None, :]
    inside = ((np.abs(ray[..., 0]) <= 1) & (np.abs(ray[..., 1]) <= 1)
              & (ray[..., 2] <= 1.01))
    terrain = hm_lookup(hm, ray[..., 0], ray[..., 1])
    return (inside & (ray[..., 2] < terrain - 1e-3)).any(axis=1)


def albedo(x, y):
    """Ground texture in [0.15, 0.85], RGB."""
    r = 0.5 + 0.3 * np.sin(7.0 * x) * np.cos(5.0 * y)
    g = 0.5 + 0.3 * np.cos(6.0 * x + 1.0) * np.sin(4.0 * y + 0.5)
    b = 0.45 + 0.25 * np.sin(3.0 * (x + y))
    return np.clip(np.stack([r, g, b], -1), 0.15, 0.85)


def season_factors(year_frac):
    """(green, snow) over the year: snow at new year, green mid-year."""
    green = 0.5 - 0.5 * np.cos(2 * np.pi * year_frac)
    snow = np.maximum(0.0, np.cos(2 * np.pi * year_frac)) ** 3
    return green, snow


def shade_colors(hit_pts, shadow, year_frac, sun_el_deg):
    """Albedo, seasonal tint, and sun and shadow shading."""
    base = albedo(hit_pts[:, 0], hit_pts[:, 1])
    green, snow = season_factors(year_frac)
    tinted = base.copy()
    tinted[:, 1] = np.clip(tinted[:, 1] * (1 + 0.5 * green), 0, 1)
    tinted = tinted * (1 - 0.7 * snow) + 0.95 * snow
    direct = 0.45 + 0.45 * np.sin(np.deg2rad(sun_el_deg))
    skylight = 0.35
    lit = np.where(shadow[:, None], tinted * skylight,
                   tinted * (skylight + direct))
    return np.clip(lit, 0, 1)


def make_projective_camera(name, el_deg, az_deg, img_size=64, cam_dist=25.0,
                           focal_mult=11.0):
    """A near-nadir projective camera looking at the cube's origin from
    (el, az): narrow field of view from far away."""
    v = elevation_azimuth_to_vec(el_deg, az_deg)
    c = cam_dist * v
    fwd = -v
    right = np.cross(fwd, np.array([0.0, 0, 1.0]))
    right = right / max(np.linalg.norm(right), 1e-9)
    down = np.cross(fwd, right)
    R = np.stack([down, right, fwd])
    t = -R @ c
    f = img_size * focal_mult
    K = np.array([[f, 0, img_size / 2], [0, f, img_size / 2], [0, 0, 1.0]])
    P = K @ np.concatenate([R, t[:, None]], 1)
    P = P / P[-1, -1]
    return Camera(name=name, P=P, img_shape=(img_size, img_size, 3),
                  view_el_az=(el_deg, az_deg), scaled=True)


@dataclass
class SyntheticScene:
    cameras: list
    images: list
    hm: np.ndarray                 # ground-truth heights [G, G]
    prior_hm: np.ndarray           # noisy prior DSM
    year_fracs: np.ndarray


def render_view(cam: Camera, hm, n_march=256):
    """The ground-truth image of a camera, ray-marched per pixel."""
    img_pts, tops, bots, valid = cam.pixel_rays()
    hit, hit_mask = surface_hit(tops, bots, hm, n_march=n_march)
    shadow = shadowed(hit, cam.sun_vec, hm)
    colors = shade_colors(hit, shadow, cam.time_frac, cam.sun_el_az[0])
    colors[~(valid & hit_mask)] = 0.0
    img = np.zeros(cam.img_shape, np.float32)
    img[img_pts[:, 0], img_pts[:, 1]] = colors
    return img


def make_scene(n_views=8, img_size=64, grid=96, seed=0,
               prior_noise=0.05) -> SyntheticScene:
    """A whole synthetic site: cameras spread in azimuth and off-nadir
    angle, sun angles and capture times spread over the year (shuffled, so
    the linspace split does not hold out the winter views), and the noisy
    prior."""
    rng = np.random.default_rng(seed)
    cams, imgs = [], []
    year_fracs = (np.linspace(0.03, 0.97, n_views)
                  + rng.uniform(-0.02, 0.02, n_views))
    rng.shuffle(year_fracs)
    for i in range(n_views):
        el = 90.0 - rng.uniform(4.0, 25.0)
        az = (360.0 * i / n_views + rng.uniform(-15, 15)) % 360
        cam = make_projective_camera(f"synth_{i:02d}", el, az,
                                     img_size=img_size)
        sun_el = rng.uniform(35.0, 70.0)
        sun_az = rng.uniform(120.0, 240.0)
        cam.sun_el_az = (sun_el, sun_az)
        cam.sun_vec = elevation_azimuth_to_vec(sun_el, sun_az)
        cam.time_frac = float(year_fracs[i] % 1.0)
        cam.day_frac = float(rng.uniform(0.4, 0.8))
        cams.append(cam)
    hm = make_heightmap(grid=grid, seed=seed)
    for cam in cams:
        img = render_view(cam, hm)
        cam.image = img
        imgs.append(img)
    prior = hm + rng.normal(0, prior_noise, hm.shape).astype(np.float32)
    return SyntheticScene(cameras=cams, images=imgs, hm=hm,
                          prior_hm=prior.astype(np.float32),
                          year_fracs=year_fracs)


def scene_ray_tables(scene: SyntheticScene, testing_size=2):
    """(train_table, val_table) of a synthetic scene."""
    table = build_ray_table(scene.cameras, scene.images)
    train_idx, val_idx = train_test_split(len(scene.cameras),
                                          testing_size=testing_size)
    return table.split(train_idx), table.split(val_idx)
