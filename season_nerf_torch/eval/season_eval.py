"""Seasonal-claim verification: appearance stable across views and suns.

The counterpart of ``season_nerf_tpu/eval/season_eval.py``: render the walk
grid of view x sun x time, and at each time the pairwise colour EM distance
between all its (view, sun) renders; a model that is stable across seasons
changes its appearance with the time, not with the view, so these distances
should lie below the EM distances among the real prototype images.

All pairs of all times go through one batched Sinkhorn call on the
renderer's device; the prototype baseline takes the exact LP (few pairs).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from season_nerf_torch.eval.emd import (color_signature, emd_exact,
                                        emd_sinkhorn_batch, pad_signatures)
from season_nerf_torch.eval.walks import get_walking_points
from season_nerf_torch.render.renderer import Renderer, images_from_components


def full_eval_seasons(renderer: Renderer, cams: Sequence, out_size,
                      n_sun: int = 3, n_view: int = 3, n_time: int = 4,
                      min_day_sep: float = 20.0, angles_to_vec=None,
                      classic_shadows: bool = False) -> Dict:
    """Render the walk grid -> {"Input_Vals", "Imgs" [V, S, T] of
    shadow-adjusted renders, "Time_Class" [V, S, T]}."""
    walk_view, walk_sun, walk_times = get_walking_points(
        cams, n_view, n_sun, n_time, min_day_sep)
    V, S, T = len(walk_view), len(walk_sun), len(walk_times)
    imgs = np.empty((V, S, T), object)
    classes = np.empty((V, S, T), object)
    for i in range(V):
        for j in range(S):
            for k in range(T):
                comp = renderer.component_render_by_dir(
                    tuple(walk_view[i]), tuple(walk_sun[j]),
                    float(walk_times[k]), out_size,
                    angles_to_vec=angles_to_vec)
                d = images_from_components(comp, out_size, classic_shadows)
                imgs[i, j, k] = d["Season_Adj_Img"] * d["Shadow_Adjust"]
                classes[i, j, k] = d["Time_Class"]
    return {"Input_Vals": {"Idx_1_sat_angle": walk_view,
                           "Idx_2_sun_angle": walk_sun,
                           "Idx_3_Time_Frac": walk_times},
            "Imgs": imgs, "Time_Class": classes}


def prototype_baseline_em(proto_images: Sequence[np.ndarray]) -> np.ndarray:
    """[n, n] exact EM distances among the real prototype images (NaN on
    the diagonal): the scale a stable model's distances must stay under."""
    n = len(proto_images)
    sigs = [color_signature(img) for img in proto_images]
    out = np.full((n, n), np.nan)
    for i in range(n):
        for j in range(i + 1, n):
            out[i, j] = out[j, i] = emd_exact(sigs[i], sigs[j])
    return out


def season_stability(walk: Dict, use_sinkhorn: bool = True,
                     device="cuda") -> Dict:
    """Per time, the EM distance of every pair of (view, sun) renders
    -> {"EM_matrices" [T, K, K] (NaN on the diagonal), "Stats": mean,
    median, p95 and max}.  With ``use_sinkhorn`` every pair of every time
    is one :func:`emd_sinkhorn_batch` call on ``device``; else the exact LP
    per pair, on the host."""
    imgs = walk["Imgs"]
    V, S, T = imgs.shape
    K = V * S
    ia, ib = np.triu_indices(K, k=1)
    all_sigs = [color_signature(np.nan_to_num(imgs[i, j, k]))
                for k in range(T) for i in range(V) for j in range(S)]
    per_time = np.full((T, K, K), np.nan)
    if use_sinkhorn:
        # the batch of the JAX package: all signatures padded together,
        # so that each pair carries the same padding
        W, X = pad_signatures(all_sigs)
        pa = np.concatenate([k * K + ia for k in range(T)])
        pb = np.concatenate([k * K + ib for k in range(T)])
        vals = emd_sinkhorn_batch(W[pa], X[pa], W[pb], X[pb],
                                  device=device)
        vals = vals.reshape(T, -1)
        for k in range(T):
            per_time[k][ia, ib] = per_time[k][ib, ia] = vals[k]
    else:
        for k in range(T):
            sigs = all_sigs[k * K:(k + 1) * K]
            for a, b in zip(ia, ib):
                per_time[k, a, b] = per_time[k, b, a] = emd_exact(
                    sigs[a], sigs[b])
    vals = per_time[np.isfinite(per_time)]
    stats = {"mean": float(np.mean(vals)), "median": float(np.median(vals)),
             "p95": float(np.percentile(vals, 95)),
             "max": float(np.max(vals))}
    return {"EM_matrices": per_time, "Stats": stats}
