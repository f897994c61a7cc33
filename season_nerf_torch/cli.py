"""Command line of the port.

    python -m season_nerf_torch.cli render --Model_Location DIR \
        --VA 70 30 --SA 45 180 --tf 07/19 [--Output_Size 256 | H W S] \
        [--Save_Name out.png] [--exact_shadow] [--device cuda]

``render`` is the port of ``main_run_Season_NeRF.py``: a novel view of a
model directory (season-adjusted composite times the shadow adjustment),
written as PNG.  Serving is ``python -m season_nerf_torch.render.serving``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Tuple

import numpy as np

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


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m season_nerf_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
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
