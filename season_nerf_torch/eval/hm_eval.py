"""Height-map (DSM) evaluation with an alignment search.

The counterpart of ``season_nerf_tpu/eval/hm_eval.py``: the network's
density on a dense nadir grid of columns, composited into the expected
surface height and the width of a 67 % confidence interval; MAE, RMSE,
share within 1 m and median against the lidar DSM, before and after a
greedy search over +-1 px shifts and +-5 deg rotations.

The density runs on the model's device, ``chunk_cols`` columns a call of
``sigma_only`` (the trunk through K3 in eval mode), the compositing and the
interval with it; the alignment searches warp the small rasters on the
host with ``scipy.ndimage``, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


@torch.no_grad()
def density_surface(model, grid_hw: Tuple[int, int], n_samples: int = 96,
                    chunk_cols: int = 4096):
    """Density on a [H, W] grid of columns over the cube, ``n_samples``
    from z = 1 down to -1 each, in eval mode on the model's device.

    -> (expected surface height [H, W] in [-1, 1], width of the 67 %-mass
    interval around the most likely sample, as a fraction of the z range:
    the first symmetric widening of it that holds the mass)."""
    H, W = grid_hw
    S = n_samples
    dev = next(model.parameters()).device
    xs = np.linspace(-1, 1, H)
    ys = np.linspace(-1, 1, W)
    cols_xy = torch.as_tensor(
        np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2),
        dtype=torch.float32, device=dev)
    zs = torch.as_tensor(np.linspace(1, -1, S), dtype=torch.float32,
                         device=dev)
    ks = torch.arange(S, device=dev)
    delta = 2.0 / S
    was_training = model.training
    model.eval()
    try:
        est, ci = [], []
        for s in range(0, cols_xy.shape[0], chunk_cols):
            xy = cols_xy[s:s + chunk_cols]
            n = xy.shape[0]
            pts = torch.cat([xy.repeat_interleave(S, 0),
                             zs[:, None].repeat(n, 1)], 1)
            rho = model.sigma_only(pts).float().reshape(n, S)
            tau = torch.cumsum(rho * delta, dim=1)
            pv = torch.exp(-torch.cat([torch.zeros_like(tau[:, :1]),
                                       tau[:, :-1]], 1))
            ps = pv * (1 - torch.exp(-rho * delta))
            denom = ps.sum(1)
            est.append(torch.sum(ps * zs[None], 1) / (denom + 1e-12))
            pdf = ps / (denom[:, None] + 1e-12)
            cdf = torch.cat([torch.zeros_like(pdf[:, :1]),
                             torch.cumsum(pdf, dim=1)], 1)
            amax = torch.argmax(pdf, dim=1)[:, None]
            # every widening k = 0..S-1 at once: the first that holds 67 %
            z0 = torch.clamp(amax - ks, min=0)
            z1 = torch.clamp(amax + 1 + ks, max=S)
            hit = (cdf.gather(1, z1) - cdf.gather(1, z0)) >= 0.67
            first = torch.argmax(hit.to(torch.uint8), dim=1)[:, None]
            width = torch.where(hit.any(1), (z1 - z0).gather(1, first)[:, 0],
                                torch.full_like(first[:, 0], S))
            ci.append(width.float() / S)
    finally:
        model.train(was_training)
    return (torch.cat(est).cpu().numpy().reshape(H, W),
            torch.cat(ci).cpu().numpy().reshape(H, W))


def hm_scores(est_m: np.ndarray, gt_m: np.ndarray) -> Dict[str, float]:
    """MAE / RMSE / share within 1 m / median |error| over the pixels
    finite in both."""
    diff = (est_m - gt_m).ravel()
    diff = diff[np.isfinite(diff)]
    return {"MAE": float(np.mean(np.abs(diff))),
            "RMSE": float(np.sqrt(np.mean(diff ** 2))),
            "Acc_1_m": float(np.mean(np.abs(diff) <= 1.0)),
            "Median": float(np.median(np.abs(diff)))}


def shift_and_rotate(img: np.ndarray, shift, rot_deg: float) -> np.ndarray:
    """Shift by whole pixels, then rotate about the centre; NaN where no
    pixel lands."""
    from scipy import ndimage
    out = img.copy()
    for axis, s in enumerate(shift):
        if s:
            out = np.roll(out, s, axis=axis)
            if axis == 0:
                (out[:s] if s > 0 else out[s:])[:] = np.nan
            else:
                (out[:, :s] if s > 0 else out[:, s:])[:] = np.nan
    if rot_deg:
        nanmask = ~np.isfinite(out)
        filled = np.where(nanmask, 0.0, out)
        out = ndimage.rotate(filled, rot_deg, reshape=False, order=1,
                             cval=np.nan, mode="constant")
        m = ndimage.rotate((~nanmask).astype(float), rot_deg, reshape=False,
                           order=1, cval=0.0, mode="constant")
        out = np.where(m > 0.5, out / np.maximum(m, 1e-6), np.nan)
    return out


def greedy_align(est_m: np.ndarray, gt_m: np.ndarray, max_steps: int = 100):
    """Greedy descent over {+-1 px shifts} x {+-5 deg rotations} on the
    RMSE, the mean bias removed at every candidate -> (aligned estimate,
    total change [rows, columns, degrees])."""
    shifts = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    rots = list(range(-5, 6))
    est = est_m + np.nanmean(gt_m - est_m)
    best = np.sqrt(np.nanmean((est - gt_m) ** 2))
    change = np.zeros(3)
    for _ in range(max_steps):
        best_mv = None
        for sh in shifts:
            for r in rots:
                if sh == (0, 0) and r == 0:
                    continue
                cand = shift_and_rotate(est, sh, r)
                cand = cand + np.nanmean(gt_m - cand)
                rmse = np.sqrt(np.nanmean((cand - gt_m) ** 2))
                if rmse < best - 1e-9:
                    best, best_mv = rmse, (sh, r)
        if best_mv is None:
            break
        est = shift_and_rotate(est, best_mv[0], best_mv[1])
        est = est + np.nanmean(gt_m - est)
        change += [best_mv[0][0], best_mv[0][1], best_mv[1]]
    return est, change


def apply_affine(img: np.ndarray, rot_deg: float, scale, shift) -> np.ndarray:
    """Rotate, scale and shift about the image centre; NaN where no pixel
    lands."""
    from scipy import ndimage
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    M = R @ np.diag([1.0 / scale[0], 1.0 / scale[1]])
    center = (np.array(img.shape) - 1) / 2
    offset = center - M @ (center + np.asarray(shift, float))
    nanmask = ~np.isfinite(img)
    filled = np.where(nanmask, 0.0, img)
    out = ndimage.affine_transform(filled, M, offset=offset, order=1,
                                   cval=0.0, mode="constant")
    w = ndimage.affine_transform((~nanmask).astype(float), M, offset=offset,
                                 order=1, cval=0.0, mode="constant")
    return np.where(w > 0.5, out / np.maximum(w, 1e-6), np.nan)


def simple_align(est_m: np.ndarray, gt_m: np.ndarray, max_steps: int = 60):
    """Hill-climb over (rotation, scale_x, scale_y, shift_x, shift_y) with a
    linear bias fit per candidate -> (aligned, T, (A, B) of the fit)."""

    def bias_fit(est, gt):
        x, y = est.ravel(), gt.ravel()
        ok = np.isfinite(x) & np.isfinite(y)
        if ok.sum() < 8:
            return est, 1.0, 0.0
        A, B = np.polyfit(x[ok], y[ok], deg=1)
        return est * A + B, A, B

    def score(T):
        warped = apply_affine(est_m, T[0], (T[1], T[2]), (T[3], T[4]))
        adj, A, B = bias_fit(warped, gt_m)
        return float(np.sqrt(np.nanmean((adj - gt_m) ** 2))), adj, (A, B)

    T = np.array([0.0, 1.0, 1.0, 0.0, 0.0])
    best, best_img, best_fit = score(T)
    for _ in range(max_steps):
        improved = False
        for axis, delta in [(0, 1.0), (0, -1.0), (1, 0.01), (1, -0.01),
                            (2, 0.01), (2, -0.01), (3, 1.0), (3, -1.0),
                            (4, 1.0), (4, -1.0)]:
            cand = T.copy()
            cand[axis] += delta
            r, img, fit = score(cand)
            if r < best - 1e-9:
                best, best_img, best_fit, T = r, img, fit, cand
                improved = True
        if not improved:
            break
    return best_img, T, best_fit


def eval_hm(model, gt_hm: np.ndarray, h_range: Tuple[float, float],
            n_samples: int = 96, chunk_cols: int = 4096):
    """Density surface -> meters -> scores before and after the greedy
    alignment.  gt_hm: the lidar raster in [-1, 1].  -> (images {GT,
    Est_HM_no_Shift, Est_HM_after_Shift, CI_width_m}, scores before, scores
    after with ``Shift_x_y_deg``: element 0 is the row (axis-0) shift, as
    the reference names it)."""
    h0, h1 = h_range
    est_n, ci = density_surface(model, gt_hm.shape, n_samples, chunk_cols)
    est_m = (est_n + 1) / 2 * (h1 - h0) + h0
    gt_m = (np.asarray(gt_hm, np.float64) + 1) / 2 * (h1 - h0) + h0
    est_m = est_m + np.nanmean(gt_m - est_m)
    before = hm_scores(est_m, gt_m)
    aligned, change = greedy_align(est_m, gt_m)
    after = hm_scores(aligned, gt_m)
    after["Shift_x_y_deg"] = change.tolist()
    imgs = {"GT": gt_m, "Est_HM_no_Shift": est_m,
            "Est_HM_after_Shift": aligned, "CI_width_m": ci * (h1 - h0)}
    return imgs, before, after
