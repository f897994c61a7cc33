"""The evaluation of a trained model, the regional suite and the merge.

The counterpart of ``season_nerf_tpu/eval/regional.py``:
- ``analyze_model`` and ``write_analysis_outputs``: the height map against
  the lidar DSM before and after alignment, every test camera rendered and
  scored under the seasonal alignment, and the solar and season walks,
  pickled as ``Analysis.pickle`` (numpy values, without the per-sample
  components); then ``Output/``: a comparison strip per test image, the
  height maps, the score tables and the walk animations;
- ``regional_eval``: ``Detailed_Output/``, the data-overview figures, the
  height maps (with the prior DSM's scores), the image scores, the shadow
  claims (``shadow_eval``) and the seasonal claims (``season_eval``), each
  pickled and written as a text report, and ``Region_Results.pickle``;
- ``multi_region_merge``: every region's ``Region_Results.pickle`` into
  one table per kind and ``Merged_Results.pickle``;
- ``area_overviews``: a nadir render of each model directory, side by side.

Every pickle holds numpy values and Python scalars only, so the two
packages read each other's.  The JAX package draws its figures with
matplotlib; here each figure is raster panels written by ``utils/png.py``,
and what the figures printed in their titles and colour bars (the scores,
the aligned time, the height scales) is appended to the text reports.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from season_nerf_torch.eval import (hm_eval, img_eval, reports, season_eval,
                                    shadow_eval, summary_images)
from season_nerf_torch.eval.walks import get_walking_points
from season_nerf_torch.render.loading import load_model_dir
from season_nerf_torch.render.movie import giffify
from season_nerf_torch.render.renderer import Renderer
from season_nerf_torch.utils.png import write_panels

_NAN_RGB = np.array([1.0, 0.0, 0.0])        # no data in a height panel


def _dump(obj, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def analyze_model(renderer: Renderer, model, cams: Sequence,
                  test_idx: Sequence[int], gt_dsm: Optional[np.ndarray],
                  h_range, out_dir: str, *, hm_samples: int = 96,
                  img_size=(256, 256), n_align_times: int = 100,
                  n_sun_walk: int = 5, n_time_walk: int = 12,
                  walk_size: int = 128, angles_to_vec=None) -> Dict:
    """Evaluate ``model`` (rendered by ``renderer``) -> the analysis dict
    (``HM`` where there is a ground-truth DSM, ``Images``,
    ``Image_Summary``, ``Solar_Walk``, ``Season_Walk``), also pickled to
    ``out_dir/Analysis.pickle`` without the per-sample components."""
    analysis: Dict = {}
    test_cams = [cams[i] for i in test_idx]

    if gt_dsm is not None:
        imgs, before, after = hm_eval.eval_hm(model, gt_dsm, h_range,
                                              n_samples=hm_samples)
        analysis["HM"] = {"Imgs": imgs, "Before": before, "After": after}

    analysis["Images"] = img_eval.full_eval_images(
        renderer, test_cams, img_size, n_align_times=n_align_times)
    analysis["Image_Summary"] = img_eval.summarize_image_scores(
        analysis["Images"])

    # the solar walk over the site's sun angles at the first camera's
    # time, the season walk over the year at its sun angle; both nadir
    _, walk_sun, walk_times = get_walking_points(
        cams, 3, n_sun_walk, n_time_walk, min_day_sep=0)
    nadir = (90.0, 0.0)
    analysis["Solar_Walk"] = [
        renderer.render_img(nadir, tuple(s), float(cams[0].time_frac),
                            walk_size, angles_to_vec=angles_to_vec)["Col_Img"]
        for s in walk_sun]
    analysis["Season_Walk"] = {
        "times": walk_times,
        "imgs": [renderer.render_img(
            nadir, tuple(cams[0].sun_el_az), float(t), walk_size,
            angles_to_vec=angles_to_vec)["Col_Img"] for t in walk_times]}

    slim_images = {}
    for name, e in analysis["Images"].items():
        se = {k: v for k, v in e.items() if k != "Result"}
        se["Result"] = {k: v for k, v in e["Result"].items()
                        if k != "Components"}
        slim_images[name] = se
    _dump({**analysis, "Images": slim_images},
          os.path.join(out_dir, "Analysis.pickle"))
    return analysis


def _gray(hm: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """A height map as grey from ``lo`` (black) to ``hi`` (white), no data
    in ``_NAN_RGB``."""
    v = (np.asarray(hm, float) - lo) / max(hi - lo, 1e-12)
    rgb = np.repeat(np.clip(v, 0, 1)[..., None], 3, -1)
    rgb[~np.isfinite(v)] = _NAN_RGB
    return rgb


def _append_table(path: str, title: str, headers, rows):
    with open(path, "a") as f:
        f.write(f"\n{title}\n\n{reports.text_table(headers, rows)}\n")


_COMPARISON = (("GT", None), ("Base", "Base_Img"),
               ("Aligned", "Aligned_Img"),
               ("Aligned+Shadow", "Aligned_Shadow_Img"))
_HM_PANELS = ("GT", "Est_HM_no_Shift", "Est_HM_after_Shift")


def _write_hm_outputs(hm: Dict, out_dir: str, keys, prior_scores=None):
    """``Height_Maps.png`` (the ``keys`` panels of ``hm["Imgs"]``, the
    heights grey over one shared scale, ``CI_width_m`` over its own) and
    ``HM_scores.txt``, the scales appended below the scores."""
    heights = [k for k in keys if k != "CI_width_m"]
    scales = [("shared", heights)] + (
        [("CI_width_m", ["CI_width_m"])] if "CI_width_m" in keys else [])
    panels, rows = {}, []
    for scale, ks in scales:
        vals = np.concatenate([np.asarray(hm["Imgs"][k], float).ravel()
                               for k in ks])
        vals = vals[np.isfinite(vals)]
        lo, hi = ((float(vals.min()), float(vals.max())) if vals.size
                  else (0.0, 1.0))
        rows.append([scale, lo, hi])
        panels.update({k: _gray(hm["Imgs"][k], lo, hi) for k in ks})
    write_panels([[panels[k] for k in keys]],
                 os.path.join(out_dir, "Height_Maps.png"))
    hm_path = os.path.join(out_dir, "HM_scores.txt")
    reports.hm_report(hm_path, hm["Before"], hm["After"], prior_scores)
    _append_table(hm_path, "Height_Maps.png: " + ", ".join(keys)
                  + "; grey from black to white, red where no data",
                  ["Scale", "black (m)", "white (m)"], rows)


def write_analysis_outputs(analysis: Dict, out_dir: str):
    """``Output/``: ``<camera>_comparison.png`` (ground truth, base,
    aligned, aligned with shadows), ``Height_Maps.png`` (ground truth, raw,
    aligned) and ``HM_scores.txt``, ``Image_scores.txt``, and the walks as
    ``Time_Walk.gif`` and ``Solar_Walk.gif``."""
    os.makedirs(out_dir, exist_ok=True)
    per_image = []
    for name, entry in analysis.get("Images", {}).items():
        if "Result" not in entry:
            continue
        res = entry["Result"]
        al = res["Seasonal_Aligned_Imgs"]
        imgs = {"GT": res["Ground_Truth"],
                "Base": res["Images"]["Season_Adj_Img"],
                "Aligned": al["Season_Adj_Img"],
                "Aligned+Shadow": al["Season_Adj_Img"] * al["Shadow_Adjust"]}
        safe = str(name).replace(os.sep, "_")
        write_panels([[imgs[t] for t, _ in _COMPARISON]],
                     os.path.join(out_dir, f"{safe}_comparison.png"))
        t_best = float(entry["Aligned_Vals"][2])
        for title, key in _COMPARISON[1:]:
            if key in entry.get("Scores", {}):
                _l2, p, s, em = entry["Scores"][key]
                per_image.append([str(name), title, p, s, em, t_best])
    if "HM" in analysis:
        _write_hm_outputs(analysis["HM"], out_dir, _HM_PANELS)
    img_path = os.path.join(out_dir, "Image_scores.txt")
    reports.image_report(img_path, analysis["Image_Summary"])
    if per_image:
        _append_table(img_path, "Per test image (the <image>_comparison.png "
                      "panels)", ["Image", "Variant", "PSNR", "SSIM", "EM",
                                  "Aligned time"], per_image)
    if analysis.get("Season_Walk", {}).get("imgs"):
        giffify(analysis["Season_Walk"]["imgs"],
                os.path.join(out_dir, "Time_Walk.gif"))
    if analysis.get("Solar_Walk"):
        giffify(analysis["Solar_Walk"],
                os.path.join(out_dir, "Solar_Walk.gif"))


_HM_DETAIL_PANELS = _HM_PANELS + ("CI_width_m",)


def regional_eval(renderer: Renderer, model, cams: Sequence,
                  test_idx: Sequence[int], gt_dsm, prior_dsm, h_range,
                  out_dir: str, *, quick: bool = True,
                  img_size=None, season_size=None, hm_samples=None,
                  angles_to_vec=None) -> Dict:
    """The regional evaluation into ``out_dir`` -> its results (also
    ``Region_Results.pickle``).  ``quick`` takes the fast sizes (3 held-out
    views at 256 x 256 with 25 alignment times, 48 samples for the height
    map and the shadow rays, 16 x 16 ground points and 6 points across
    the angles, the season walk's 3 views x 3 suns x 4 times at 64 x 64),
    else the full ones; ``img_size``, ``season_size`` and ``hm_samples``
    override them."""
    os.makedirs(out_dir, exist_ok=True)
    test_idx = list(test_idx)
    train_idx = [i for i in range(len(cams)) if i not in set(test_idx)]
    test_cams = [cams[i] for i in test_idx]
    train_cams = [cams[i] for i in train_idx]

    # data overview figures
    summary_images.angle_scatter(
        cams, test_idx, os.path.join(out_dir, "Data_Sat_and_Sun_pose.png"))
    summary_images.proto_time_plot(
        cams, train_idx, test_idx, test_idx[:3], np.array([]),
        os.path.join(out_dir, "Prototypical_Imgs.png"))

    results: Dict = {}
    n_samples = hm_samples or (48 if quick else 96)
    # 1. height maps, and the prior DSM's scores against the lidar's
    if gt_dsm is not None:
        imgs, before, after = hm_eval.eval_hm(model, gt_dsm, h_range,
                                              n_samples=n_samples)
        prior_scores = None
        if prior_dsm is not None:
            h0, h1 = h_range
            p_m = (np.asarray(prior_dsm) + 1) / 2 * (h1 - h0) + h0
            g_m = (np.asarray(gt_dsm) + 1) / 2 * (h1 - h0) + h0
            if p_m.shape != g_m.shape:
                p_m = img_eval._resize(p_m, g_m.shape)
            prior_scores = hm_eval.hm_scores(
                p_m + np.nanmean(g_m - p_m), g_m)
        hm_summary = {"Imgs": imgs, "Before": before, "After": after,
                      "Prior": prior_scores}
        _dump(hm_summary, os.path.join(out_dir, "HM_Summary.pickle"))
        _write_hm_outputs(hm_summary, out_dir, _HM_DETAIL_PANELS,
                          prior_scores)
        results["HM"] = hm_summary

    # 2. image quality; the pickle without the renders and components
    size = img_size or ((256, 256) if quick else (512, 512))
    img_summary = img_eval.full_eval_images(
        renderer, test_cams, size, n_align_times=25 if quick else 100)
    slim = {k: {"Scores": v["Scores"], "Aligned_Vals": v["Aligned_Vals"]}
            for k, v in img_summary.items()}
    del img_summary
    _dump(slim, os.path.join(out_dir, "Img_Summary.pickle"))
    summary = img_eval.summarize_image_scores(slim)
    reports.image_report(os.path.join(out_dir, "Image_scores.txt"), summary)
    results["Images"] = {"Summary": summary, "Per_Image": slim}

    # 3. shadow claims
    shadow_summary = shadow_eval.test_shadow_points(
        model, train_cams, test_cams, n_samples=n_samples,
        points_in_space=16 if quick else 64,
        points_across_angles=6 if quick else 20,
        angles_to_vec=angles_to_vec)
    _dump({"Stats": shadow_summary["Stats"],
           "Sun_El_Az": shadow_summary["Sun_El_Az"]},
          os.path.join(out_dir, "Shadow_Scores_Summary.pickle"))
    reports.shadow_report(os.path.join(out_dir, "Shadow_scores.txt"),
                          shadow_summary["Stats"])
    results["Shadows"] = shadow_summary["Stats"]

    # 4. seasonal claims
    walk = season_eval.full_eval_seasons(
        renderer, cams, season_size or ((64, 64) if quick else (128, 128)),
        n_sun=3 if quick else 5, n_view=3 if quick else 11,
        n_time=4 if quick else 12, angles_to_vec=angles_to_vec)
    stability = season_eval.season_stability(walk, device=renderer.device)
    proto = [cams[i].image for i in test_idx[:3]
             if cams[i].image is not None]
    baseline = (season_eval.prototype_baseline_em(proto)
                if len(proto) >= 2 else np.full((1, 1), np.nan))
    _dump({"Input_Vals": walk["Input_Vals"], "Stability": stability,
           "Baseline": baseline},
          os.path.join(out_dir, "Season_Summary.pickle"))
    reports.season_report(os.path.join(out_dir, "Season_scores.txt"),
                          stability, baseline)
    results["Seasons"] = {"Stability": stability["Stats"],
                          "Baseline": baseline}
    _dump(results, os.path.join(out_dir, "Region_Results.pickle"))
    return results


def multi_region_merge(region_dirs: Sequence[str], out_dir: str) -> Dict:
    """Every region's ``Region_Results.pickle`` (a region is named by its
    directory) -> one table per kind in ``out_dir``
    (``All_{HM,Image,Shadow,Season}_scores.txt``) and
    ``Merged_Results.pickle``; a directory without results is skipped."""
    os.makedirs(out_dir, exist_ok=True)
    merged: Dict = {"HM": {}, "Images": {}, "Shadows": {}, "Seasons": {}}
    for d in region_dirs:
        name = os.path.basename(os.path.normpath(d))
        path = os.path.join(d, "Region_Results.pickle")
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            r = pickle.load(f)
        if "HM" in r:
            merged["HM"][name] = r["HM"]["After"]
        if "Images" in r:
            merged["Images"][name] = r["Images"]["Summary"]
        if "Shadows" in r:
            merged["Shadows"][name] = r["Shadows"]
        if "Seasons" in r:
            merged["Seasons"][name] = r["Seasons"]["Stability"]

    if merged["HM"]:
        rows = [[n, s["MAE"], s["RMSE"], s["Acc_1_m"], s["Median"]]
                for n, s in merged["HM"].items()]
        reports.write_table(os.path.join(out_dir, "All_HM_scores.txt"),
                            ["Region", "MAE", "RMSE", "Acc<=1m", "Median"],
                            rows, title="Height-map accuracy by region")
    if merged["Images"]:
        rows = []
        for n, summ in merged["Images"].items():
            v = summ.get("Aligned_Shadow_Img") or next(iter(summ.values()))
            rows.append([n, v["PSNR"]["avg"], v["SSIM"]["avg"],
                         v["EM"]["avg"]])
        reports.write_table(os.path.join(out_dir, "All_Image_scores.txt"),
                            ["Region", "PSNR", "SSIM", "EM"], rows,
                            title="Image quality by region (aligned+shadow)")
    if merged["Shadows"]:
        rows = [[n, s.get("Full_Walk", s.get("Training", {})).get(
            "Acc", float("nan"))] for n, s in merged["Shadows"].items()]
        reports.write_table(os.path.join(out_dir, "All_Shadow_scores.txt"),
                            ["Region", "Full-walk accuracy"], rows,
                            title="Shadow accuracy by region")
    if merged["Seasons"]:
        rows = [[n, s.get("mean", float("nan")), s.get("median", float("nan")),
                 s.get("p95", float("nan")), s.get("max", float("nan"))]
                for n, s in merged["Seasons"].items()]
        reports.write_table(os.path.join(out_dir, "All_Season_scores.txt"),
                            ["Region", "EM mean", "EM median", "EM p95",
                             "EM max"], rows,
                            title="Seasonal stability by region "
                                  "(mg_merge_seasons equivalent)")
    _dump(merged, os.path.join(out_dir, "Merged_Results.pickle"))
    return merged


def area_overviews(model_dirs: Sequence[str], out_path: str,
                   out_size: int = 128, device="cuda"):
    """A nadir render (sun at 55 deg elevation from the south, mid-year) of
    each model directory (``Final_Model.nn`` + ``opts.json``), side by
    side, as a PNG -> ``out_path``."""
    renders = []
    for d in model_dirs:
        loaded = load_model_dir(d, device=device)
        out = loaded.renderer.render_img((90.0, 0.0), (55.0, 180.0), 0.5,
                                         out_size)
        renders.append(out["Col_Img"])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    write_panels([renders or [np.ones((out_size, out_size, 3))]], out_path)
    return out_path
