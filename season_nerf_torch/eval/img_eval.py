"""Per-image evaluation: the rendering-quality gauntlet and the seasonal
alignment.

The counterpart of ``season_nerf_tpu/eval/img_eval.py``:

- seasonal alignment: for each candidate time (the capture's own, then
  ``n_times`` over the year), mix the per-class albedo adjusts by the time
  head's class vector, fit the sky colour per channel in closed form on
  the pixels the sun does not reach, and keep the time of least MSE.  The
  candidates are scored in torch on the renderer's device, in blocks sized
  to memory;
- the gauntlet: masked PSNR, masked Gaussian-window SSIM, mean L2 and the
  colour EM distance;
- ``eval_rendering`` / ``eval_img_dict`` / ``full_eval_images``: render
  each test camera, composite the base and the seasonally aligned
  variants, score the table of variants;
- the confusion of the learned shadow mask against the exact one.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from season_nerf_torch.eval.emd import compare_em_imgs
from season_nerf_torch.ops.metrics import psnr as masked_psnr
from season_nerf_torch.ops.metrics import ssim as masked_ssim
from season_nerf_torch.render.renderer import (Renderer, _sig,
                                               images_from_components)

# the largest [candidates, rays * samples * 3] float32 block of mixed
# colours the alignment holds at once (a 256^2 x 96 view is 75 MB a
# candidate)
ALIGN_BLOCK_BYTES = 1 << 30


@torch.no_grad()
def align_errors(renderer: Renderer, components: Dict, gt_cols: np.ndarray,
                 base_time: float, n_times: int = 366):
    """Score every candidate time of the seasonal alignment -> (times [T],
    class vectors [T, C], MSE [T], sky colours [T, 3]); T = n_times + 1,
    the capture's own time first."""
    dev = renderer.device
    ts = np.concatenate([[base_time], np.linspace(0, 1, n_times)])
    t4 = np.stack([np.cos(ts * 2 * np.pi), np.sin(ts * 2 * np.pi),
                   np.cos(ts * 2 * np.pi), np.sin(ts * 2 * np.pi)], 1)
    class_vecs = renderer.model.class_only(torch.as_tensor(
        t4, dtype=torch.float32, device=dev)).float().cpu().numpy()

    rho, deltas = components["rho"], components["deltas"]
    tau = np.cumsum(rho * deltas, 1)
    pv = np.exp(-np.concatenate([np.zeros_like(tau[:, :1]), tau[:, :-1]], 1))
    ps = pv * (1 - np.exp(-rho * deltas))
    gate = _sig((np.sum(ps * components["vis"], 1) - 0.2) * 30.0)   # [N,1]
    good = (gate < 0.99)[:, 0]

    put = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)
    adj = components["adjust_per_class"]
    N, S, C, _ = adj.shape
    # [C, N*S*3]: one matrix product mixes a block of candidates
    adj_c = put(adj).permute(2, 0, 1, 3).reshape(C, -1)
    ps_d, base = put(ps), put(components["col_raw"])
    gate_d, gt = put(gate), put(gt_cols)
    good_d = torch.as_tensor(good, device=dev)[None, :, None]
    cvs = put(class_vecs)
    block = max(1, ALIGN_BLOCK_BYTES // max(N * S * 3 * 4, 1))
    errors, skies = [], []
    for s in range(0, cvs.shape[0], block):
        cv = cvs[s:s + block]
        mixed = (cv @ adj_c).reshape(-1, N, S, 3)
        mixed.add_(base).sigmoid_().mul_(ps_d)
        A = mixed.sum(2)                                        # [B, N, 3]
        del mixed
        # closed-form sky: argmin over sky of |GT - A (g + (1 - g) sky)|^2
        # on the pixels the sun does not reach
        Y = torch.where(good_d, gt - A * gate_d, 0.0)
        X = torch.where(good_d, (1 - gate_d) * A, 0.0)
        sky = torch.clamp(torch.sum(X * Y, 1)
                          / (torch.sum(X * X, 1) + 1e-12), 0.0, 1.0)
        rendered = A * (gate_d + (1 - gate_d) * sky[:, None])
        errors.append(torch.mean((rendered - gt) ** 2, dim=(1, 2)))
        skies.append(sky)
    return (ts, class_vecs, torch.cat(errors).cpu().numpy(),
            torch.cat(skies).cpu().numpy())


def seasonal_align(renderer: Renderer, components: Dict, gt_cols: np.ndarray,
                   base_time: float, n_times: int = 366):
    """The (class vector [C], sky colour [3], time) that best explain the
    ground-truth colours ``gt_cols`` [N, 3] at the rendered rays of a
    ``component_render`` result."""
    ts, class_vecs, errors, skies = align_errors(renderer, components,
                                                 gt_cols, base_time, n_times)
    best = int(np.argmin(errors))
    return class_vecs[best], skies[best], float(ts[best])


def image_quality_gauntlet(img_gt: np.ndarray, img_est: np.ndarray,
                           ssim_win: int = 13, em_scale: float = 1.0):
    """(mean L2, PSNR, SSIM, EM) over the pixels valid in both images."""
    if not np.isfinite(img_est).any():
        return 1.0, 1.0, -1.0, 1.0
    mask = np.isfinite(img_gt).all(-1) & np.isfinite(img_est).all(-1)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    gt = f32(np.where(mask[..., None], img_gt, 0.0))
    est = f32(np.where(mask[..., None], img_est, 0.0))
    m = torch.from_numpy(mask)
    p = float(masked_psnr(est, gt, mask=m))
    win = min(ssim_win, min(gt.shape[0], gt.shape[1]) - 1)
    s = float(masked_ssim(est, gt, mask=m, win_size=win))
    d = np.sqrt(np.sum((img_gt - img_est) ** 2, -1))
    mean_l2 = float(np.nanmean(np.where(mask, d, np.nan)))
    em = compare_em_imgs(np.where(mask[..., None], img_gt, np.nan),
                         np.where(mask[..., None], img_est, np.nan))
    return mean_l2, p, s, em * em_scale


def shadow_confusion(est_mask: np.ndarray, exact_mask: np.ndarray,
                     thresh: float = 0.5) -> Dict[str, float]:
    """Accuracy and sun/shadow precision and recall of the learned shadow
    mask against the exact-transmittance mask."""
    ok = np.isfinite(est_mask) & np.isfinite(exact_mask)
    e = est_mask[ok] >= thresh     # True = sunlit
    x = exact_mask[ok] >= thresh
    tp = float(np.sum(e & x))
    tn = float(np.sum(~e & ~x))
    fp = float(np.sum(e & ~x))
    fn = float(np.sum(~e & x))

    def safe(a, b):
        return a / b if b > 0 else float("nan")
    return {"Accuracy": safe(tp + tn, tp + tn + fp + fn),
            "Sun_Precision": safe(tp, tp + fp),
            "Sun_Recall": safe(tp, tp + fn),
            "Shadow_Precision": safe(tn, tn + fn),
            "Shadow_Recall": safe(tn, tn + fp)}


def _axis_taps(n_out: int, n_in: int):
    """Bilinear taps along one axis as ``cv2.resize`` (INTER_LINEAR) takes
    them: pixel centres at half-pixel offsets, no antialiasing, a source
    position before the first pixel or at/after the last clamped to it."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(int)
    a = (f - i0).astype(np.float32)
    a[i0 < 0] = 0.0
    i0 = np.maximum(i0, 0)
    a[i0 >= n_in - 1] = 0.0
    i0 = np.minimum(i0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), a


def _resize(img, hw):
    """[H, W(, C)] -> [h, w(, C)] float32 by bilinear interpolation,
    ``cv2.resize(img, (w, h))``'s default (along the rows, then down
    the columns)."""
    x = np.asarray(img, np.float32)
    r0, r1, ar = _axis_taps(hw[0], x.shape[0])
    c0, c1, ac = _axis_taps(hw[1], x.shape[1])
    ar = ar.reshape((-1,) + (1,) * (x.ndim - 1))
    ac = ac.reshape((1, -1) + (1,) * (x.ndim - 2))
    cols = x[:, c0] * (1 - ac) + x[:, c1] * ac
    return (cols[r0] * (1 - ar) + cols[r1] * ar).astype(np.float32)


def eval_rendering(renderer: Renderer, cam, out_size: Tuple[int, int],
                   exact_solar: bool = False, classic_shadows: bool = False,
                   n_align_times: int = 366):
    """Render one test camera; build its base and seasonally aligned image
    dicts."""
    comp = renderer.component_render_by_camera(cam, out_size,
                                               exact_solar=exact_solar)
    imgs = images_from_components(comp, out_size, classic_shadows)

    gt_full = np.asarray(cam.image)
    gt_cols = gt_full[comp["gt_img_pts"][:, 0], comp["gt_img_pts"][:, 1], :3]
    cvec, sky, t_best = seasonal_align(renderer, comp, gt_cols,
                                       cam.time_frac, n_align_times)
    aligned = dict(comp)
    aligned["class_probs"] = np.broadcast_to(
        cvec[None, None], comp["class_probs"].shape).copy()
    aligned["sky"] = np.broadcast_to(
        np.asarray(sky, np.float32)[None, None], comp["sky"].shape).copy()
    imgs_aligned = images_from_components(aligned, out_size, classic_shadows)

    gt_resized = _resize(gt_full[..., :3], out_size)
    return {"Images": imgs, "Seasonal_Aligned_Imgs": imgs_aligned,
            "Aligned_Vals": (cvec, sky, t_best), "Ground_Truth": gt_resized,
            "Components": comp}


def eval_img_dict(result: Dict, ssim_win: int = 13, em_scale: float = 1.0,
                  score_extremes: bool = False) -> Dict[str, Tuple]:
    """Scores of the rendered variants: {Base, Aligned} x {flat, shadowed
    (, exact shadow)}, and with ``score_extremes`` each class's one-hot
    render."""
    gt = result["Ground_Truth"]
    scores = {}
    for name, imgs in [("Base", result["Images"]),
                       ("Aligned", result["Seasonal_Aligned_Imgs"])]:
        season = imgs["Season_Adj_Img"]
        variants = {f"{name}_Img": season,
                    f"{name}_Shadow_Img": season * imgs["Shadow_Adjust"]}
        if "Shadow_Adjust_Exact" in imgs:
            variants[f"{name}_Exact_Shadow_Img"] = (
                season * imgs["Shadow_Adjust_Exact"])
        for k, img in variants.items():
            scores[k] = image_quality_gauntlet(gt, img, ssim_win, em_scale)
    if score_extremes:
        for c, img in enumerate(result["Images"].get("Extreme_Imgs", [])):
            scores[f"Class_{c}_Img"] = image_quality_gauntlet(
                gt, img, ssim_win, em_scale)
    return scores


def full_eval_images(renderer: Renderer, test_cams: List, out_size,
                     exact_solar: bool = False, **kw):
    """Evaluate every test camera -> {camera name: {"Scores",
    "Aligned_Vals", ["Shadow_Scores",] "Result"}}."""
    out = {}
    for cam in test_cams:
        res = eval_rendering(renderer, cam, out_size,
                             exact_solar=exact_solar, **kw)
        entry = {"Scores": eval_img_dict(res),
                 "Aligned_Vals": res["Aligned_Vals"]}
        if exact_solar:
            imgs = res["Images"]
            entry["Shadow_Scores"] = shadow_confusion(
                imgs["Shadow_Mask"], imgs["Shadow_Mask_Exact"])
        entry["Result"] = res
        out[cam.name] = entry
    return out


def summarize_image_scores(per_image: Dict) -> Dict[str, Dict[str, float]]:
    """Average, best and worst of each metric of each variant over the
    images (best is the largest PSNR/SSIM, the smallest L2/EM)."""
    table = {}
    for entry in per_image.values():
        for variant, (l2, p, s, em) in entry["Scores"].items():
            cols = table.setdefault(variant, {"L2": [], "PSNR": [],
                                              "SSIM": [], "EM": []})
            for m, v in (("L2", l2), ("PSNR", p), ("SSIM", s), ("EM", em)):
                cols[m].append(v)
    out = {}
    for variant, cols in table.items():
        out[variant] = {}
        for m, vals in cols.items():
            v = np.asarray(vals, float)
            lower_better = m in ("L2", "EM")
            out[variant][m] = {
                "avg": float(np.nanmean(v)),
                "best": float(np.nanmin(v) if lower_better else np.nanmax(v)),
                "worst": float(np.nanmax(v) if lower_better
                               else np.nanmin(v))}
    return out
