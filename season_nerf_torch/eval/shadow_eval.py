"""Shadow-claim verification: learned solar visibility against the exact
transmittance.

The counterpart of ``season_nerf_tpu/eval/shadow_eval.py``: for each sun
angle of the walk sets, sun-direction rays through a grid of ground points;
the solar head's visibility along each ray against the exact transmittance
of the density along it, summarised as accuracy, sun and shadow precision
and recall, the mean error and the mean offset of the shadow boundary.

Each sun angle is one ``forward_solar`` pass over its G x S ray points in
eval mode, so the position trunk runs through the folded inference trunk
(K3); the per-angle results stay on the device and come to the host in one
copy at the end, as the JAX package fetches once.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Sequence

import numpy as np
import torch

from season_nerf_torch.eval.img_eval import shadow_confusion
from season_nerf_torch.eval.walks import shadow_walk_points
from season_nerf_torch.geometry.units import elevation_azimuth_to_vec
from season_nerf_torch.ops.sampling import out_of_cube, sample_coarse
from season_nerf_torch.render.renderer import images_from_components


@torch.no_grad()
def eval_shadow_angles(model, sun_angles: np.ndarray,
                       ground_points: np.ndarray, n_samples: int = 96,
                       angles_to_vec=None):
    """For each (el, az) sun angle: the exact transmittance and the learned
    visibility at ``n_samples`` points of the sun ray through each ground
    point (z = 0), from one cube face's height above it to as far below.

    -> (exact [A, G, S], est [A, G, S], sky [A, 3]) float32 numpy."""
    to_vec = angles_to_vec or elevation_azimuth_to_vec
    G, S = ground_points.shape[0], n_samples
    dev = next(model.parameters()).device
    was_training = model.training
    if was_training:                # eval mode: the fused trunk (K3) and
        model.eval()                # the running statistics
    g3 = np.concatenate([ground_points, np.zeros((G, 1))], 1)
    outs = []
    try:
        for el, az in np.asarray(sun_angles):
            v = np.asarray(to_vec(el, az), np.float64)
            v_n = v / v[2]
            tops = torch.as_tensor((g3 + v_n[None]).astype(np.float32),
                                   device=dev)
            bots = torch.as_tensor((g3 - v_n[None]).astype(np.float32),
                                   device=dev)
            pts, deltas = sample_coarse(tops, bots, S)
            deltas = torch.where(out_of_cube(pts)[..., None],
                                 torch.zeros_like(deltas), deltas)
            sun = torch.as_tensor(v, dtype=torch.float32, device=dev)
            out = model.forward_solar(pts.reshape(-1, 3),
                                      sun[None].expand(G * S, 3))
            rho = out["rho"].float().reshape(G, S, 1)
            tau = torch.cumsum(rho * deltas, dim=1)
            pv = torch.exp(-torch.cat([torch.zeros_like(tau[:, :1]),
                                       tau[:, :-1]], 1))[:, :, 0]
            outs.append(torch.cat([
                pv.reshape(-1), out["vis"].float().reshape(-1),
                torch.sigmoid(out["sky_raw"][0].float())]))
    finally:
        if was_training:
            model.train()
    if not outs:
        return (np.zeros((0, G, S), np.float32),) * 2 + (
            np.zeros((0, 3), np.float32),)
    host = torch.stack(outs).cpu().numpy()
    A = host.shape[0]
    return (host[:, :G * S].reshape(A, G, S),
            host[:, G * S:2 * G * S].reshape(A, G, S),
            host[:, 2 * G * S:])


def shadow_analysis(exact: np.ndarray, est: np.ndarray) -> Dict[str, float]:
    """Confusion at 0.5 (sunlit = visibility above it), the mean squared
    and absolute errors, and the mean offset of the lit-sample count along
    a ray."""
    loss = float(np.mean((exact - est) ** 2))
    avg_err = float(np.mean(np.abs(exact - est)))
    gt = exact > 0.5
    pr = est > 0.5
    tp = float(np.sum(gt & pr))
    tn = float(np.sum(~gt & ~pr))
    fp = float(np.sum(~gt & pr))
    fn = float(np.sum(gt & ~pr))

    def safe(a, b):
        return a / b if b > 0 else float("nan")

    surf_dist = gt.sum(-1) - pr.sum(-1)
    return {"Acc": safe(tp + tn, tp + tn + fp + fn),
            "Prec_Sun": safe(tp, tp + fp), "Recall_Sun": safe(tp, tp + fn),
            "Prec_Shadow": safe(tn, tn + fn),
            "Recall_Shadow": safe(tn, tn + fp),
            "Loss": loss, "Avg_Error": avg_err,
            "Avg_Offset": float(np.mean(np.abs(surf_dist)))}


def advanced_solar_sweep(renderer, view_angles: np.ndarray,
                         sun_angles: np.ndarray, out_size=(32, 32),
                         angles_to_vec=None, csv_path: str = None):
    """The learned shadow mask against the exact one over a grid of view x
    sun angles (at mid-year): one row of confusion statistics per
    combination, also written to ``csv_path`` when given."""
    rows = []
    for ve, va in np.asarray(view_angles):
        for se, sa in np.asarray(sun_angles):
            comp = renderer.component_render_by_dir(
                (ve, va), (se, sa), 0.5, out_size,
                angles_to_vec=angles_to_vec, exact_solar=True)
            imgs = images_from_components(comp, out_size)
            stats = shadow_confusion(imgs["Shadow_Mask"],
                                     imgs["Shadow_Mask_Exact"])
            rows.append({"view_el": ve, "view_az": va, "sun_el": se,
                         "sun_az": sa, **stats})
    if csv_path:
        os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


def test_shadow_points(model, train_cams: Sequence, test_cams: Sequence,
                       n_samples: int = 96, points_in_space: int = 16,
                       points_across_angles: int = 6, angles_to_vec=None):
    """The exact-against-learned comparison over the four angle sets
    (training, testing, near the training suns, the full sky) ->
    {"Ground_Points", "Sun_El_Az", "Results", "Stats"}."""
    walks = shadow_walk_points(train_cams, test_cams,
                               points_in_space, points_across_angles)
    ground = walks.pop("Ground_Points")
    summary = {"Ground_Points": ground, "Sun_El_Az": walks, "Results": {},
               "Stats": {}}
    for name, angles in walks.items():
        if len(angles) == 0:
            continue
        exact, est, sky = eval_shadow_angles(
            model, angles, ground, n_samples, angles_to_vec)
        summary["Results"][name] = {"Exact_Vis": exact, "Est_Vis": est,
                                    "Sky_Col": sky}
        summary["Stats"][name] = shadow_analysis(exact, est)
    return summary
