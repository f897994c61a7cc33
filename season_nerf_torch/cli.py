"""Command line of the port.

    python -m season_nerf_torch.cli train --site_name SYNTH_A \
        --exp_name run --IO_Location DIR [any Config field as --flag] \
        [--train_steps N] [--device cuda]
    python -m season_nerf_torch.cli render --Model_Location DIR \
        --VA 70 30 --SA 45 180 --tf 07/19 [--Output_Size 256 | H W S] \
        [--Save_Name out.png] [--exact_shadow] [--device cuda]

``train`` is the training half of ``main.py`` (the JAX package's
``run_test``) on a synthetic site (``SYNTH*``): prepare the site, train
(resuming from the newest ``Model_<step>.nn`` of the log directory), and
write ``Final_Model.nn``, ``opts.json`` and ``W2C_W2L_H.npy``, a model
directory ``render`` and the service load.  The eval suite and real sites
are not ported yet.  ``render`` is the port of ``main_run_Season_NeRF.py``:
a novel view of a model directory (season-adjusted composite times the
shadow adjustment), written as PNG.  Serving is
``python -m season_nerf_torch.render.serving``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import re
import sys
from typing import Optional, Tuple

import numpy as np

from season_nerf_torch.config import Config, add_config_flags
from season_nerf_torch.geometry.time_enc import year_frac_from_month_day
from season_nerf_torch.render.loading import load_model_dir
from season_nerf_torch.render.renderer import images_from_components
from season_nerf_torch.render.serving import png_bytes


def render_pretrained(model_dir: str, va: Tuple[float, float],
                      sa: Tuple[float, float], tf: str, out_size=256,
                      exact_shadow: bool = False,
                      save_name: Optional[str] = None, device="cuda"):
    """Novel view from a model directory -> (shown image, all images).

    ``out_size``: an int renders square at the model's n_samples; (H, W)
    sets the frame; (H, W, S) also sets the samples per ray."""
    try:
        if "/" in tf:
            month, day = tf.split("/")
            year_frac = year_frac_from_month_day(int(month), int(day))
        else:
            year_frac = float(tf)
    except (ValueError, TypeError):
        raise SystemExit(
            f"--tf must be MM/DD (e.g. 07/19) or a year fraction in [0,1); "
            f"got {tf!r}")
    size = ((out_size, out_size) if np.isscalar(out_size)
            else tuple(out_size))
    hw = (size[0], size[1] if len(size) > 1 else size[0])
    n_samples = size[2] if len(size) > 2 else None

    loaded = load_model_dir(model_dir, n_samples=n_samples, device=device)
    comp = loaded.renderer.component_render_by_dir(
        tuple(va), tuple(sa), year_frac, hw,
        angles_to_vec=loaded.angles_to_vec, exact_solar=exact_shadow)
    imgs = images_from_components(comp, hw,
                                  classic_shadows=loaded.cfg.Solar_Type_2)
    shown = imgs["Season_Adj_Img"] * imgs["Shadow_Adjust"]
    if save_name:
        with open(save_name, "wb") as f:
            f.write(png_bytes(shown))
    return shown, imgs


def prepare_synthetic(cfg: Config):
    """The synthetic site of ``cfg`` -> (train table, prior DSM); writes the
    split and the world artifact into the log directory."""
    from season_nerf_torch.data.ingest import save_world_artifact
    from season_nerf_torch.data.rays import build_ray_table, train_test_split
    from season_nerf_torch.data.synthetic import make_scene
    scene = make_scene(n_views=cfg.synth_views, img_size=cfg.synth_img_size,
                       grid=cfg.synth_grid, seed=cfg.seed)
    table = build_ray_table(scene.cameras, scene.images,
                            use_hsluv=cfg.use_HSLuv)
    train_idx, test_idx = train_test_split(len(scene.cameras),
                                           testing_size=cfg.testing_size)
    if cfg.logs_dir:
        names = [c.name for c in scene.cameras]
        for fname, idx in (("Training_Imgs.txt", train_idx),
                           ("Testing_Imgs.txt", test_idx)):
            with open(os.path.join(cfg.logs_dir, fname), "w") as f:
                f.write("\n".join(names[i] for i in idx))
        # no world frame, but the height range lets the model directory
        # serve height maps in meters
        save_world_artifact(os.path.join(cfg.logs_dir, "W2C_W2L_H.npy"),
                            None, None, (0.0, 30.0))
    return table.split(np.array(train_idx)), scene.prior_hm


def run_train(cfg: Config, train_steps: Optional[int] = None,
              device="cuda"):
    """Prepare, train (resuming from the newest checkpoint of the log
    directory when ``cfg.resume``), finalize -> the Trainer."""
    from season_nerf_torch.train.engine import Trainer
    if not cfg.site_name.upper().startswith("SYNTH"):
        raise NotImplementedError("the port trains synthetic sites (SYNTH*) "
                                  "only: real-site ingest is not ported yet")
    cfg.resolve_dirs()
    cfg.save_json()
    train_table, prior = prepare_synthetic(cfg)
    trainer = Trainer(cfg, train_table, prior_hm=prior, device=device)
    step_of = lambda p: int(re.search(r"Model_(\d+)\.nn$", p).group(1))
    ckpts = sorted(glob.glob(os.path.join(cfg.logs_dir, "Model_*.nn")),
                   key=step_of)
    if ckpts and cfg.resume and step_of(ckpts[-1]) > 0:
        print(f"resuming from {ckpts[-1]}")
        trainer.resume(ckpts[-1])
    if trainer.step < cfg.max_train_steps:
        trainer.run(n_steps=train_steps)
    else:
        print("training already complete")
    trainer.finalize()
    return trainer


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m season_nerf_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    t = sub.add_parser("train", help="train a synthetic site, write a "
                                     "model directory")
    add_config_flags(t)
    t.add_argument("--train_steps", type=int, default=None,
                   help="stop after this many steps (default: all)")
    t.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    r = sub.add_parser("render", help="render a novel view of a model dir")
    r.add_argument("--Model_Location", required=True)
    r.add_argument("--VA", nargs=2, type=float, default=[70.0, 0.0],
                   help="view elevation azimuth (deg)")
    r.add_argument("--SA", nargs=2, type=float, default=[45.0, 180.0],
                   help="sun elevation azimuth (deg)")
    r.add_argument("--tf", type=str, default="07/01",
                   help="time of year, MM/DD or fraction")
    r.add_argument("--Output_Size", type=int, nargs="+", default=[256],
                   help="1 int (square) or H W n_samples")
    r.add_argument("--Save_Name", type=str, default=None)
    r.add_argument("--exact_shadow", action="store_true")
    r.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    args = p.parse_args(argv)
    if args.command == "train":
        fields = {f.name for f in dataclasses.fields(Config)}
        cfg = Config(**{k: v for k, v in vars(args).items() if k in fields})
        trainer = run_train(cfg, args.train_steps, device=args.device)
        print("trained", trainer.step, "steps; model directory",
              cfg.logs_dir)
        return 0
    out_size = (args.Output_Size[0] if len(args.Output_Size) == 1
                else tuple(args.Output_Size))
    save = args.Save_Name or os.path.join(args.Model_Location, "render.png")
    render_pretrained(args.Model_Location, tuple(args.VA), tuple(args.SA),
                      args.tf, out_size=out_size,
                      exact_shadow=args.exact_shadow, save_name=save,
                      device=args.device)
    print("saved", save)


if __name__ == "__main__":
    sys.exit(main())
