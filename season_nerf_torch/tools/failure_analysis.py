"""Where does a run lose its image quality?  Per-region error attribution.

Renders each testing camera of a trained run (seasonally aligned, the
protocol's variant), splits the pixels into structural regions, and
attributes the squared error and the SSIM to each:

- shadow and sunlit (the ground-truth shadow from the synthetic scene's
  own ray marcher, not the model's);
- roof, wall edge and ground (from the ground-truth height field:
  high-gradient cells are walls, raised flat cells roofs).

One JSON line per camera and a JSON file of them all.  Synthetic sites
only (it needs the ground-truth structure):

    python -m season_nerf_torch.tools.failure_analysis RUN_DIR \\
        [--size 256] [-o out.json] [--device cpu]

The counterpart of ``tools/failure_analysis.py``, with its flags and JSON.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def regions_for_camera(cam, scene, out_size):
    """Per-pixel region labels from the ground truth for a camera's render
    grid -> {shadow, sunlit, edge, roof, ground}: boolean [H, W] masks."""
    from season_nerf_torch.data.synthetic import (hm_lookup, shadowed,
                                                  surface_hit)

    H = np.asarray(scene.hm)
    h, w = out_size
    # the component renderer samples the camera on a regular pixel grid;
    # its ray grid lands on the same surface points
    rr = np.round(np.linspace(0, cam.image.shape[0] - 1, h)).astype(int)
    cc = np.round(np.linspace(0, cam.image.shape[1] - 1, w)).astype(int)
    RR, CC = np.meshgrid(rr, cc, indexing="ij")
    tx, ty, _ = cam.backproject(RR.ravel(), CC.ravel(), 1.0)
    bx, by, _ = cam.backproject(RR.ravel(), CC.ravel(), -1.0)
    tops = np.stack([tx, ty, np.ones_like(tx)], -1)
    bots = np.stack([bx, by, -np.ones_like(bx)], -1)
    hit, _hit_ok = surface_hit(tops, bots, H)
    shadow = shadowed(hit, np.asarray(cam.sun_vec), H).reshape(h, w)

    surf_h = hm_lookup(H, hit[:, 0], hit[:, 1]).reshape(h, w)
    gy, gx = np.gradient(surf_h)
    grad = np.hypot(gx, gy)
    edge = grad > np.percentile(grad, 90)
    roof = (surf_h > np.percentile(surf_h, 60)) & ~edge
    ground = ~edge & ~roof
    return {"shadow": shadow, "sunlit": ~shadow,
            "edge": edge, "roof": roof, "ground": ground}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    args = p.parse_args(argv)

    import torch

    from season_nerf_torch.data.synthetic import make_scene
    from season_nerf_torch.eval.img_eval import eval_rendering
    from season_nerf_torch.ops.metrics import ssim
    from season_nerf_torch.render.loading import load_model_dir

    loaded = load_model_dir(args.run_dir, device=args.device)
    cfg = loaded.cfg
    scene = make_scene(n_views=cfg.synth_views, img_size=cfg.synth_img_size,
                       grid=cfg.synth_grid, seed=cfg.seed)
    with open(os.path.join(args.run_dir, "Testing_Imgs.txt")) as f:
        test_names = {ln.strip() for ln in f if ln.strip()}
    rows = []
    for i, cam in enumerate(scene.cameras):
        if cam.name not in test_names:
            continue
        cam.image = scene.images[i]
        res = eval_rendering(loaded.renderer, cam, (args.size, args.size))
        gt = res["Ground_Truth"]
        imgs = res["Seasonal_Aligned_Imgs"]
        est = imgs["Season_Adj_Img"] * imgs["Shadow_Adjust"]
        valid = np.isfinite(gt).all(-1) & np.isfinite(est).all(-1)
        err = np.where(valid, np.sum((np.nan_to_num(est) - gt) ** 2, -1),
                       np.nan)
        regions = regions_for_camera(cam, scene, (args.size, args.size))
        entry = {"camera": cam.name,
                 "view_el": round(float(cam.view_el_az[0]), 1),
                 "sun_el": round(float(cam.sun_el_az[0]), 1),
                 "time_frac": round(float(cam.time_frac), 3)}
        gtt = torch.from_numpy(np.where(valid[..., None], gt, 0.0))
        estt = torch.from_numpy(np.where(valid[..., None],
                                         np.nan_to_num(est), 0.0))
        for name, m in regions.items():
            sel = m & valid
            entry[f"mse_{name}"] = (round(float(np.nanmean(err[sel])), 5)
                                    if sel.any() else None)
            entry[f"frac_{name}"] = round(float(sel.mean()), 3)
            s = float(ssim(estt, gtt, mask=torch.from_numpy(sel)))
            entry[f"ssim_{name}"] = round(s, 4) if sel.any() else None
        rows.append(entry)
        print(json.dumps(entry))

    out = args.output or os.path.join(args.run_dir, "failure_analysis.json")
    report = {"run_dir": os.path.abspath(args.run_dir),
              "size": args.size, "per_camera": rows}
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[failure] wrote {out}")
    return report


if __name__ == "__main__":
    main()
