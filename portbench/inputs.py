"""Everything a run feeds both the program and the reference, made from
``--seed``: the weights, the synthetic site and its ray table, the draws
of every training step, and the frames' views, suns and times.

The site is the synthetic Season-NeRF site (a height field with buildings,
near-nadir projective cameras, per-view sun and season, cast shadows, a
noisy prior DSM), written here from the description of the program's
``data/synthetic.py`` so that the yardstick does not move with it.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

# names of the sine layers that SIREN initialises as first layers
FIRST_LAYERS = ("G_NeRF_net.fc1", "G_NeRF_net.fc_solar_1",
                "G_NeRF_net.fc_sky_color_1", "time_layer_1")
OMEGA = 30.0


def entropy(*keys) -> int:
    """A 63-bit seed from any whole numbers (the run seed may exceed 32
    bits)."""
    return int(np.random.SeedSequence([int(k) for k in keys])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, *keys) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(entropy(*keys))
    return g


# -- weights --------------------------------------------------------------
def _bound(name: str, fan_in: int) -> float:
    """The init bound of a weight: SIREN's for a sine layer (1 / fan_in
    for a first layer, sqrt(6 / fan_in) / omega for the others),
    ``nn.Linear``'s 1 / sqrt(fan_in) for a dense head."""
    if name.endswith(".linear.weight"):
        return 1.0 / fan_in if name.rsplit(".", 2)[0] in FIRST_LAYERS \
            else math.sqrt(6.0 / fan_in) / OMEGA
    return 1.0 / math.sqrt(fan_in)


def make_weights(shapes: Dict[str, tuple], seed: int, device,
                 n_calib: int = 4096) -> Dict[str, torch.Tensor]:
    """float32 weights for a state dict of ``shapes``, drawn on ``device``
    in one call, with every BatchNorm's running statistics those of its
    own pre-activation over ``n_calib`` random points of the cube."""
    g = generator(device, seed, 1)
    names = [k for k in shapes if not k.endswith("num_batches_tracked")]
    total = sum(math.prod(shapes[k]) for k in names)
    u = torch.rand(total, generator=g, device=device) * 2 - 1
    out, at = {}, 0
    for k in names:
        n = math.prod(shapes[k])
        v = u[at:at + n].reshape(shapes[k])
        at += n
        if k.endswith(".norm.weight"):
            out[k] = 1.0 + 0.5 * v
        elif k.endswith(".norm.bias"):
            out[k] = 0.35 * v
        elif k.endswith((".running_mean", ".running_var")):
            out[k] = torch.zeros(shapes[k], device=device)
        elif k.endswith(".bias"):
            out[k] = v / math.sqrt(shapes[k.replace(".bias", ".weight")][1])
        else:
            out[k] = v * _bound(k, shapes[k][1])
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
    calibrate(out, seed, device, n_calib)
    return out


@torch.no_grad()
def calibrate(w: Dict[str, torch.Tensor], seed: int, device, n: int):
    """Running mean and biased variance of each trunk layer's
    pre-activation, layer by layer over random points."""
    from portbench.reference.model import Net
    net = Net(w)
    net.training = False
    g = generator(device, seed, 2)
    x = torch.rand(n, 3, generator=g, device=device) * 2 - 1
    from portbench.reference.model import positional, PE_POSE
    pe = positional(x, PE_POSE)
    h = torch.sin(OMEGA * net.dense("G_NeRF_net.fc1.linear", pe))
    for i in list(range(2, net.n_layers + 1)) + [9]:
        name = f"G_NeRF_net.fc{i}"
        ins = (h, pe) if i == net.skip else (h,)
        z = OMEGA * net.dense(name + ".linear", *ins)
        w[name + ".norm.running_mean"].copy_(z.mean(0))
        w[name + ".norm.running_var"].copy_(z.var(0, unbiased=False))
        h = torch.sin(net.batchnorm(name + ".norm", z))


# -- the synthetic site ---------------------------------------------------
def _vec(el_deg, az_deg):
    el, az = np.deg2rad(el_deg), np.deg2rad(az_deg)
    v = np.array([np.cos(az), np.sin(az), np.tan(el)])
    return v / np.linalg.norm(v)


def _heights(rng, grid, n_buildings=6):
    xs = np.linspace(-1, 1, grid)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    ground = -0.5 + 0.06 * np.sin(2.1 * X + 0.5) * np.cos(1.7 * Y - 0.3)
    hm = ground.copy()
    for _ in range(n_buildings):
        cx, cy = rng.uniform(-0.7, 0.7, 2)
        w, h = rng.uniform(0.08, 0.3, 2)
        box = (np.abs(X - cx) < w) & (np.abs(Y - cy) < h)
        hm = np.where(box, ground + rng.uniform(0.15, 0.8), hm)
    return hm.astype(np.float32)


def _lookup(hm, x, y):
    g = hm.shape[0]
    xi = np.clip(((x + 1) / 2 * (g - 1)).astype(int), 0, g - 1)
    yi = np.clip(((y + 1) / 2 * (g - 1)).astype(int), 0, g - 1)
    return hm[xi, yi]


def _camera(el, az, px, dist=25.0, focal=11.0):
    """A near-nadir projective camera ``P`` [3, 4] looking at the origin."""
    v = _vec(el, az)
    fwd = -v
    right = np.cross(fwd, [0.0, 0, 1.0])
    right /= max(np.linalg.norm(right), 1e-9)
    R = np.stack([np.cross(fwd, right), right, fwd])
    K = np.array([[px * focal, 0, px / 2], [0, px * focal, px / 2],
                  [0, 0, 1.0]])
    P = K @ np.concatenate([R, (-R @ (dist * v))[:, None]], 1)
    return P / P[-1, -1]


def _backproject(P, row, col, h):
    """The point at height ``h`` that ``P`` images at (row, col)."""
    b1 = P[0, 2] * h + P[0, 3] - P[2, 2] * h * row - P[2, 3] * row
    b2 = P[1, 2] * h + P[1, 3] - P[2, 2] * h * col - P[2, 3] * col
    a11, a12 = P[0, 0] - P[2, 0] * row, P[0, 1] - P[2, 1] * row
    a21, a22 = P[1, 0] - P[2, 0] * col, P[1, 1] - P[2, 1] * col
    det = a11 * a22 - a12 * a21
    return (a12 * b2 - a22 * b1) / det, (a21 * b1 - a11 * b2) / det


def _shade(hit, sun, year, sun_el, hm):
    """Albedo with a seasonal tint, lit by the sun unless the terrain
    casts a shadow, plus sky light."""
    x, y = hit[:, 0], hit[:, 1]
    base = np.clip(np.stack([
        0.5 + 0.3 * np.sin(7.0 * x) * np.cos(5.0 * y),
        0.5 + 0.3 * np.cos(6.0 * x + 1.0) * np.sin(4.0 * y + 0.5),
        0.45 + 0.25 * np.sin(3.0 * (x + y))], -1), 0.15, 0.85)
    green = 0.5 - 0.5 * np.cos(2 * np.pi * year)
    snow = max(0.0, np.cos(2 * np.pi * year)) ** 3
    base[:, 1] = np.clip(base[:, 1] * (1 + 0.5 * green), 0, 1)
    base = base * (1 - 0.7 * snow) + 0.95 * snow
    ts = np.linspace(2e-2, 2.2 / max(sun[2], 1e-3), 128)[None, :, None]
    ray = hit[:, None, :] + ts * sun[None, None, :]
    inside = ((np.abs(ray[..., 0]) <= 1) & (np.abs(ray[..., 1]) <= 1)
              & (ray[..., 2] <= 1.01))
    shadow = (inside & (ray[..., 2] < _lookup(hm, ray[..., 0], ray[..., 1])
                        - 1e-3)).any(1)
    direct = 0.45 + 0.45 * np.sin(np.deg2rad(sun_el))
    lit = np.where(shadow[:, None], base * 0.35, base * (0.35 + direct))
    return np.clip(lit, 0, 1)


def make_site(seed: int, views: int, px: int, grid: int, held_out: int = 1,
              prior_noise: float = 0.05):
    """-> (rows [N, 22] float32 of the training views, prior DSM [G, G]).

    Row layout: image point (2), ray top at z = +1 (3), bottom at z = -1
    (3), view direction (3), sun direction (3), time code (4), sample
    weight (1), colour (3).  The first ``held_out`` views are left out."""
    rng = np.random.default_rng(entropy(seed, 3))
    years = np.linspace(0.03, 0.97, views) + rng.uniform(-0.02, 0.02, views)
    rng.shuffle(years)
    hm = _heights(rng, grid)
    rows = []
    for i in range(views):
        el, az = 90.0 - rng.uniform(4.0, 25.0), \
            (360.0 * i / views + rng.uniform(-15, 15)) % 360
        sun_el, sun_az = rng.uniform(35.0, 70.0), rng.uniform(120.0, 240.0)
        year, day = float(years[i] % 1.0), float(rng.uniform(0.4, 0.8))
        if i < held_out:
            continue
        P = _camera(el, az, px)
        rr, cc = np.meshgrid(np.arange(px), np.arange(px), indexing="ij")
        rr, cc = rr.ravel().astype(float), cc.ravel().astype(float)
        tx, ty = _backproject(P, rr, cc, 1.0)
        bx, by = _backproject(P, rr, cc, -1.0)
        ok = ((np.abs(tx) <= 1) & (np.abs(ty) <= 1) & (np.abs(bx) <= 1)
              & (np.abs(by) <= 1))
        tops = np.stack([tx, ty, np.ones_like(tx)], -1)[ok]
        bots = np.stack([bx, by, -np.ones_like(bx)], -1)[ok]
        t = np.linspace(0.0, 1.0, 256)[None, :, None]
        pts = tops[:, None] * (1 - t) + bots[:, None] * t
        terrain = _lookup(hm, pts[..., 0], pts[..., 1])
        below = pts[..., 2] <= terrain
        first, n = np.argmax(below, 1), np.arange(len(tops))
        i0 = np.maximum(first - 1, 0)
        z0 = pts[n, i0, 2] - terrain[n, i0]
        z1 = pts[n, first, 2] - terrain[n, first]
        f = np.clip(np.where(np.abs(z0 - z1) > 1e-9,
                             z0 / np.maximum(z0 - z1, 1e-9), 0.0), 0, 1)
        hit = pts[n, i0] * (1 - f[:, None]) + pts[n, first] * f[:, None]
        sun = _vec(sun_el, sun_az)
        colour = _shade(hit, sun, year, sun_el, hm)
        colour[~below.any(1)] = 0.0
        view = bots - tops
        r = np.empty((len(tops), 22), np.float32)
        r[:, 0], r[:, 1] = rr[ok], cc[ok]
        r[:, 2:5], r[:, 5:8] = tops, bots
        r[:, 8:11] = view / np.linalg.norm(view, axis=1, keepdims=True)
        r[:, 11:14] = sun
        r[:, 14:18] = [np.cos(2 * np.pi * year), np.sin(2 * np.pi * year),
                       np.cos(2 * np.pi * day), np.sin(2 * np.pi * day)]
        r[:, 18] = 1.0
        r[:, 19:22] = colour
        rows.append(r)
    prior = hm + rng.normal(0, prior_noise, hm.shape)
    return np.concatenate(rows), prior.astype(np.float32)


def columns(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The named columns of ray-table rows."""
    return {"top": rows[:, 2:5], "bot": rows[:, 5:8], "sun": rows[:, 11:14],
            "t4": rows[:, 14:18], "gt_rgb": rows[:, 19:22]}


class StepDraws:
    """Every random number of training step ``step`` from a generator on
    ``device`` keyed by (seed, step): ``batch`` distinct row indices, the
    camera jitter, the sun rays' azimuth, elevation, start and times, and
    the sun rays' jitter (the names the program's loss reads)."""

    def __init__(self, seed: int, n_rows: int, batch: int, samples: int,
                 device):
        self.seed, self.n_rows, self.R, self.S = seed, n_rows, batch, samples
        self.device = device

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        g = generator(self.device, self.seed, 4, step)
        R, S, dev = self.R, self.S, self.device
        u = lambda *shape: torch.rand(shape, generator=g, device=dev)
        idx = torch.randperm(self.n_rows, generator=g, device=dev)[:R]
        lo, hi = math.radians(1.0), math.radians(90.0)
        return {"idx": idx, "jitter": u(R, S),
                "solar_az": (u(R) * 2.0 - 1.0) * math.pi,
                "solar_el": lo + u(R) * (hi - lo),
                "solar_xy": u(R, 2) * 2.0 - 1.0,
                "solar_t": u(R, 2) * (2.0 * math.pi),
                "solar_jitter": u(R, S)}


# -- frames ---------------------------------------------------------------
def frame_requests(seed: int, sizes: List[int], mix: dict) -> list:
    """A frame of each of ``sizes`` (px), in that order, each with a view,
    sun and year fraction drawn from the seed within the ranges of
    ``mix``."""
    n = len(sizes)
    rng = np.random.default_rng(entropy(seed, 5))
    u = lambda key: rng.uniform(*mix[key], n)
    v_el, v_az, s_el, s_az = (u(k) for k in ("view_el", "view_az",
                                             "sun_el", "sun_az"))
    years = rng.uniform(0.0, 1.0, n)
    return [{"view": (float(v_el[i]), float(v_az[i])),
             "sun": (float(s_el[i]), float(s_az[i])),
             "year": float(years[i]), "size": int(sizes[i])}
            for i in range(n)]
