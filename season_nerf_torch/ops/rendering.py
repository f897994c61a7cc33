"""Volume rendering: transmittance, compositing, and the ray evaluator.

The inference half of ``season_nerf_tpu/ops/rendering.py``.  Two
illumination composites exist, selected by ``classic_solar`` (the
reference's ``Solar_Type_2``):

  classic: C = sum_s PS * col * (vis + (1 - vis) * sky)
  gated:   g = sigmoid((sum_s vis * PS - 0.2) * 30)
           C = (sum_s PS * col) * (g + (1 - g) * mean_s sky)
"""

from __future__ import annotations

import torch

from season_nerf_torch.ops.sampling import out_of_cube, sample_coarse


def transmittance(rho, deltas):
    """P_visible before each sample: exp(-exclusive cumsum(rho * delta)).
    rho/deltas: [R, S, 1]."""
    acc = torch.cumsum(rho * deltas, dim=1)
    acc = torch.cat([torch.zeros_like(acc[:, :1]), acc[:, :-1]], dim=1)
    return torch.exp(-acc)


def pv_pe_ps(rho, deltas):
    """-> (PV, PE, PS): visibility, per-sample hit prob, surface prob."""
    pv = transmittance(rho, deltas)
    pe = 1.0 - torch.exp(-rho * deltas)
    return pv, pe, pv * pe


def composite_classic(ps, col, vis, sky):
    """S-NeRF irradiance composite."""
    return torch.sum(ps * col * (vis + (1.0 - vis) * sky), dim=1)


def gated_visibility(ps, vis):
    """Scalar per-ray sun gate from per-sample visibility."""
    g = torch.sum(vis * ps, dim=1)
    return torch.sigmoid((g - 0.2) * 30.0)


def composite_gated(ps, col, vis, sky):
    """Season-NeRF gated composite."""
    albedo = torch.sum(ps * col, dim=1)
    g = gated_visibility(ps, vis)
    return albedo * (g + (1.0 - g) * torch.mean(sky, dim=1))


def expected_surface(ps, pts, deltas):
    """Expected surface point and distance along the ray."""
    denom = torch.sum(ps, dim=1) + 1e-8
    loc = torch.sum(ps * pts, dim=1) / denom
    dist = torch.sum(ps * torch.cumsum(deltas, dim=1), dim=1) / denom
    return loc, dist


def broadcast_rays(a, n_samples):
    """[R, D] per-ray values -> [R * S, D] per-sample rows."""
    R, D = a.shape
    return a[:, None, :].expand(R, n_samples, D).reshape(-1, D)


@torch.no_grad()
def eval_rays(model, tops, bots, sun, t4, *, n_samples,
              classic_solar=False, mask_out_of_cube=False):
    """Render a batch of rays at inference (the JAX ``eval_rays`` with
    ``train=False``, no prior, no importance samples).

    tops/bots/sun: [R, 3]; t4: [R, 4].  ``mask_out_of_cube`` zeroes the
    step of samples outside the unit cube (whole-image renders, whose edge
    rays leave the volume).  Returns the results dict."""
    R, S = tops.shape[0], n_samples
    pts, deltas = sample_coarse(tops, bots, S)
    if mask_out_of_cube:
        deltas = torch.where(out_of_cube(pts)[..., None],
                             torch.zeros_like(deltas), deltas)
    # the class, sun-encoding and sky branches depend on per-ray inputs
    # only: evaluate once per ray, broadcast to the samples
    probs_r, sun_pe_r, sky_raw_r = model.ray_consts(sun, t4)
    out = model(pts.reshape(-1, 3), None, None,
                probs=broadcast_rays(probs_r, S),
                sun_pe=broadcast_rays(sun_pe_r, S),
                sky_raw=broadcast_rays(sky_raw_r, S))
    rho = out["rho"].reshape(R, S, 1)
    col = out["col"].reshape(R, S, -1)
    vis = out["vis"].reshape(R, S, 1)
    sky = out["sky"].reshape(R, S, -1)

    pv, pe, ps = pv_pe_ps(rho, deltas)
    composite = composite_classic if classic_solar else composite_gated
    return {
        "rendered": composite(ps, col, vis, sky),
        "albedo": torch.sum(ps * col, dim=1),
        "pv": pv, "pe": pe, "ps": ps,
        "rho": rho, "col": col, "vis": vis, "sky": sky,
        "class_probs": out["class_probs"].reshape(R, S, -1),
        "adjust": out["adjust"].reshape(R, S, -1),
        "pts": pts, "deltas": deltas,
    }
