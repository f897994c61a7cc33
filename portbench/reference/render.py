"""The plain reference of a whole-image render, in float32.

An orthographic view over the cube's footprint along the view direction
(a grid on z = 0 extended to z = +-1), ``n_samples`` evenly spaced samples
a ray with the steps of samples outside the cube set to 0, the network in
eval mode (running statistics), and the gated composite of the rendered
colour under the sun direction and the time of year.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.model import Net, positional, PE_SOLAR
from portbench.reference.train import hit_probs, sample_coarse


def angles_to_vec(el_deg: float, az_deg: float) -> np.ndarray:
    """A view or sun angle as a unit vector, azimuth from north
    (x = cos az)."""
    el, az = np.deg2rad(el_deg), np.deg2rad(az_deg)
    v = np.array([np.cos(az), np.sin(az), np.tan(el)])
    return v / np.linalg.norm(v)


def grid_rays(view_vec, size: int):
    """-> (tops, bots) [size * size, 3] in row-major pixel order."""
    xs, ys = np.linspace(1, -1, size), np.linspace(-1, 1, size)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    xyz = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], -1)
    v = np.asarray(view_vec, np.float64)
    return ((xyz + v / v[2]).astype(np.float32),
            (xyz - v / v[2]).astype(np.float32))


def time_code(year_frac: float) -> np.ndarray:
    return np.array([np.cos(2 * np.pi * year_frac),
                     np.sin(2 * np.pi * year_frac), 1.0, 0.0], np.float32)


@torch.no_grad()
def render_colour(net: Net, view, sun, year_frac, size, n_samples,
                  device, rows=5120) -> np.ndarray:
    """The [size, size, 3] colour of a frame from view and sun angles
    (elevation, azimuth in degrees) and a year fraction, ``rows`` rays at
    a time."""
    net.training = False
    tops, bots = grid_rays(angles_to_vec(*view), size)
    sun_vec = torch.tensor(angles_to_vec(*sun), dtype=torch.float32,
                           device=device)[None]
    sun_pe = positional(sun_vec, PE_SOLAR)
    sky = net.sky(sun_pe)
    probs = net.class_probs(torch.tensor(time_code(year_frac),
                                         device=device)[None])
    out = []
    for s in range(0, tops.shape[0], rows):
        t = torch.from_numpy(tops[s:s + rows]).to(device)
        b = torch.from_numpy(bots[s:s + rows]).to(device)
        R = t.shape[0]
        pts, deltas = sample_coarse(t, b, n_samples)
        outside = ((pts < -1.0) | (pts > 1.0)).any(-1, keepdim=True)
        deltas = torch.where(outside, torch.zeros_like(deltas), deltas)
        o = net.points(pts.reshape(-1, 3), sun_pe.expand(R, -1),
                       sky.expand(R, -1), probs.expand(R, -1), n_samples)
        rho, col, vis, sk = (o[k].reshape(R, n_samples, -1)
                             for k in ("rho", "col", "vis", "sky"))
        _, _, ps = hit_probs(rho, deltas)
        gate = torch.sigmoid(((vis * ps).sum(1) - 0.2) * 30.0)
        out.append((ps * col).sum(1) * (gate + (1.0 - gate) * sk.mean(1)))
    return torch.cat(out).reshape(size, size, 3).cpu().numpy()
