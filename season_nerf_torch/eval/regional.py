"""The evaluation of a trained model: ``analyze_model`` and its outputs.

The counterpart of ``analyze_model`` and ``write_analysis_outputs`` in
``season_nerf_tpu/eval/regional.py``: the height map against the lidar DSM
before and after alignment, every test camera rendered and scored under
the seasonal alignment, and the solar and season walks, pickled as
``Analysis.pickle`` (numpy values, without the per-sample components); then
``Output/``: a comparison strip per test image, the height maps, the score
tables and the walk animations.

The JAX package draws its figures with matplotlib; here each figure is a
strip of its panels written by ``utils/png.py``, and what the figures
printed in their titles and colour bars (the scores, the aligned time, the
height scale) is appended to the text reports.  The regional suite
(``regional_eval``, ``multi_region_merge``) is not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from season_nerf_torch.eval import hm_eval, img_eval, reports
from season_nerf_torch.eval.walks import get_walking_points
from season_nerf_torch.render.movie import giffify
from season_nerf_torch.render.renderer import Renderer
from season_nerf_torch.utils.png import encode_png

_GAP = 4                                    # px of white between panels
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


def _write_strip(panels: Sequence[np.ndarray], path: str):
    """[H, W, 3] panels in [0, 1] (NaN as 0) side by side, ``_GAP`` white
    pixels apart, as an 8-bit PNG."""
    h = max(p.shape[0] for p in panels)
    parts = []
    for i, p in enumerate(panels):
        p = np.clip(np.nan_to_num(np.asarray(p, float)), 0, 1)
        pad = np.ones((h, p.shape[1], 3))
        pad[:p.shape[0]] = p
        if i:
            parts.append(np.ones((h, _GAP, 3)))
        parts.append(pad)
    with open(path, "wb") as f:
        f.write(encode_png((np.concatenate(parts, 1) * 255 + 0.5)
                           .astype(np.uint8)))


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
        _write_strip([imgs[t] for t, _ in _COMPARISON],
                     os.path.join(out_dir, f"{safe}_comparison.png"))
        t_best = float(entry["Aligned_Vals"][2])
        for title, key in _COMPARISON[1:]:
            if key in entry.get("Scores", {}):
                _l2, p, s, em = entry["Scores"][key]
                per_image.append([str(name), title, p, s, em, t_best])
    if "HM" in analysis:
        hm = analysis["HM"]
        vals = np.concatenate([np.asarray(hm["Imgs"][k], float).ravel()
                               for k in _HM_PANELS])
        vals = vals[np.isfinite(vals)]
        lo, hi = ((float(vals.min()), float(vals.max())) if vals.size
                  else (0.0, 1.0))
        _write_strip([_gray(hm["Imgs"][k], lo, hi) for k in _HM_PANELS],
                     os.path.join(out_dir, "Height_Maps.png"))
        hm_path = os.path.join(out_dir, "HM_scores.txt")
        reports.hm_report(hm_path, hm["Before"], hm["After"])
        _append_table(hm_path, "Height_Maps.png: " + ", ".join(_HM_PANELS)
                      + "; grey from black to white, red where no data",
                      ["Scale", "black (m)", "white (m)"],
                      [["shared", lo, hi]])
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
