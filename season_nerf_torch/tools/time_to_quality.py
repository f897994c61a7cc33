"""Wall-clock-to-quality curve from a training run's save points.

For each ``Model_<step>.nn`` save point of a run directory:

1. the step's wall-clock seconds since training started, from the
   ``metrics.jsonl`` timestamps (the ``Testing/*`` scalars are written when
   the checkpoint is saved);
2. the checkpoint's weights scored by the reference protocol: seasonally
   aligned masked PSNR/SSIM over the testing cameras
   (``eval/img_eval.full_eval_images``) and the DSM MAE before and after
   the alignment (``eval/hm_eval.eval_hm``);
3. a JSON curve, with the minutes to each DSM-MAE band (the paper's
   1.2-1.5 m, Season-NeRF table 1).

Restarts leave gaps in the timestamps: the wall time is accumulated from
consecutive entries with each gap capped at 120 s.

    python -m season_nerf_torch.tools.time_to_quality RUN_DIR \\
        [-o curve.json] [--size 96] [--samples 96] [--max_ckpts 12] \\
        [--hm_grid 96] [--device cpu]

The counterpart of ``tools/time_to_quality.py``, with its flags and JSON.
Synthetic sites (the scene regenerates from opts.json); it reads the
checkpoints of either package (``train/state.py::load_weights``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np

from season_nerf_torch.train.state import load_weights


def wall_clock_map(run_dir: str, cap_s: float = 120.0):
    """step -> accumulated wall seconds (restart gaps capped)."""
    entries = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for ln in f:
            try:
                e = json.loads(ln)
            except ValueError:
                continue
            entries.append((float(e["t"]), int(e["step"])))
    entries.sort()
    acc, prev_t = 0.0, entries[0][0]
    step_wall = {}
    for t, step in entries:
        acc += min(max(t - prev_t, 0.0), cap_s)
        prev_t = t
        step_wall[step] = acc    # the last write at a step wins
    return step_wall


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of an area-averaging shrink of one axis:
    output cell i covers input [i * s, (i + 1) * s), s = n_in / n_out,
    each input cell weighted by its overlap, the weights rounded to
    float32 (OpenCV's INTER_AREA)."""
    if n_out > n_in:
        raise ValueError(f"area_resize shrinks only ({n_in} -> {n_out})")
    scale = n_in / n_out
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        f1 = i * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1 = int(np.ceil(f1))
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[i, s1 - 1] = (s1 - f1) / cell
        w[i, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[i, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return w.astype(np.float32).astype(np.float64)   # OpenCV's float table


def area_resize(img: np.ndarray, hw) -> np.ndarray:
    """Shrink a 2-D float image to ``hw`` = (rows, cols) by area
    averaging, as ``cv2.resize(img, (cols, rows),
    interpolation=cv2.INTER_AREA)`` does, in float64."""
    img = np.asarray(img, np.float64)
    return (_area_weights(img.shape[0], hw[0]) @ img
            @ _area_weights(img.shape[1], hw[1]).T)


def compute_bands(curve, bands):
    """Minutes to each DSM-MAE band under both alignment conventions:
    ``_aligned`` (after the alignment search: the convention of the
    paper's band) and ``_raw`` (before it: comparable across harnesses
    without an alignment convention)."""
    out = {}
    for band in bands:
        for col, tag in (("dsm_mae_m", "raw"),
                         ("dsm_mae_aligned_m", "aligned")):
            hit = next((r for r in curve if r.get(col) is not None
                        and r[col] <= band), None)
            out[f"minutes_to_dsm_mae_{band}m_{tag}"] = (
                hit["wall_minutes"] if hit else None)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--size", type=int, default=96,
                   help="render size for the image protocol")
    p.add_argument("--samples", type=int, default=96)
    p.add_argument("--hm_grid", type=int, default=96)
    p.add_argument("--max_ckpts", type=int, default=12,
                   help="score at most this many save points (evenly "
                        "thinned, endpoints kept)")
    p.add_argument("--bands", type=float, nargs="*", default=[1.5, 1.3],
                   help="DSM-MAE bands (meters) to report minutes-to")
    p.add_argument("--from_json", action="store_true",
                   help="treat RUN_DIR as an existing curve JSON and only "
                        "recompute the bands block (no device work)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda)")
    args = p.parse_args(argv)

    if args.from_json:
        with open(args.run_dir) as f:
            report = json.load(f)
        report["bands"] = compute_bands(report["curve"], args.bands)
        out = args.output or args.run_dir
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[ttq] bands: {report['bands']}")
        print(f"[ttq] rewrote {out}")
        return report

    from season_nerf_torch.data.synthetic import make_scene
    from season_nerf_torch.eval.hm_eval import eval_hm
    from season_nerf_torch.eval.img_eval import full_eval_images
    from season_nerf_torch.render.loading import load_model_dir

    loaded = load_model_dir(args.run_dir, device=args.device)
    cfg = loaded.cfg
    scene = make_scene(n_views=cfg.synth_views, img_size=cfg.synth_img_size,
                       grid=cfg.synth_grid, seed=cfg.seed)
    with open(os.path.join(args.run_dir, "Testing_Imgs.txt")) as f:
        test_names = {ln.strip() for ln in f if ln.strip()}
    test_cams = []
    for i, cam in enumerate(scene.cameras):
        if cam.name in test_names:
            cam.image = scene.images[i]
            test_cams.append(cam)
    gt_hm = np.asarray(scene.hm, np.float64)
    if args.hm_grid and gt_hm.shape[0] > args.hm_grid:
        gt_hm = area_resize(gt_hm, (args.hm_grid, args.hm_grid))
    h_range = (0.0, 30.0)

    ckpts = []
    for path in glob.glob(os.path.join(args.run_dir, "Model_*.nn")):
        m = re.match(r"Model_(\d+)\.nn$", os.path.basename(path))
        if m:
            ckpts.append((int(m.group(1)), path))
    ckpts.sort()
    if len(ckpts) > args.max_ckpts:
        idx = np.unique(np.linspace(0, len(ckpts) - 1,
                                    args.max_ckpts).astype(int))
        ckpts = [ckpts[i] for i in idx]

    wall = wall_clock_map(args.run_dir)
    curve = []
    for step, path in ckpts:
        loaded.model.load_weights(load_weights(path))
        per_img = full_eval_images(loaded.renderer, test_cams,
                                   (args.size, args.size))
        psnrs = [e["Scores"]["Aligned_Shadow_Img"][1]
                 for e in per_img.values()]
        ssims = [e["Scores"]["Aligned_Shadow_Img"][2]
                 for e in per_img.values()]
        _, before, after = eval_hm(loaded.model, gt_hm, h_range,
                                   n_samples=args.samples)
        minutes = wall.get(step, float("nan")) / 60.0
        row = {"step": step, "wall_minutes": round(minutes, 2),
               "aligned_psnr": round(float(np.mean(psnrs)), 3),
               "aligned_ssim": round(float(np.mean(ssims)), 4),
               "dsm_mae_m": round(float(before["MAE"]), 3),
               "dsm_mae_aligned_m": round(float(after["MAE"]), 3),
               "dsm_acc_1m": round(float(before["Acc_1_m"]), 4)}
        curve.append(row)
        print(f"[ttq] step {step:6d}  {minutes:7.1f} min  "
              f"PSNR {row['aligned_psnr']:6.2f}  "
              f"MAE {row['dsm_mae_m']:5.2f} m")

    bands = compute_bands(curve, args.bands)
    report = {"run_dir": os.path.abspath(args.run_dir),
              "protocol": {"size": args.size, "samples": args.samples,
                           "hm_grid": args.hm_grid,
                           "psnr_variant": "Aligned_Shadow_Img (seasonally "
                                           "aligned x shadow, the reference "
                                           "table's row 4)"},
              "curve": curve, "bands": bands}
    out = args.output or os.path.join(args.run_dir, "time_to_quality.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[ttq] bands: {bands}")
    print(f"[ttq] wrote {out}")
    return report


if __name__ == "__main__":
    main()
