"""Render a keyframed movie from a trained model directory.

A default orbit script (the view spirals around the site while the sun and
the season sweep) or custom keyframes:

    python -m season_nerf_torch.tools.make_movie --Model_Location <dir> \
        --out movie.gif [--frames 60] [--size 256] \
        [--keyframe VEL,VAZ,SEL,SAZ,T ...] [--device cpu]

The counterpart of ``tools/make_movie.py``, with its flags and its default
script; the frames render on the card (K3) unless ``--device cpu``, on the
render mesh of every visible card (or the model directory's
``mesh_shape``), as the JAX tool loads with ``use_mesh=True``.
"""

from __future__ import annotations

import argparse
import os

from season_nerf_torch.render.loading import load_model_dir
from season_nerf_torch.render.movie import (MovieScript, export_film,
                                            render_movie)


def default_script() -> MovieScript:
    """Orbit the site through a full year."""
    script = MovieScript()
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        script.add((80 - 15 * abs(frac - 0.5) * 2, 360 * frac),
                   (40 + 25 * (0.5 - abs(frac - 0.5)) * 2, 180), frac)
    return script


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--Model_Location", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--keyframe", action="append", default=None,
                   help="repeatable: view_el,view_az,sun_el,sun_az,time_frac")
    p.add_argument("--pose_keyframe", action="append", default=None,
                   help="repeatable 6-DoF free-camera keyframe (cube "
                        "coords): x,y,z,pitch,yaw,fov,sun_el,sun_az,"
                        "time_frac; use --pose_keyframe=-0.8,... for "
                        "values starting with a minus")
    p.add_argument("--fast_render", type=int, nargs=2, default=None,
                   metavar=("N_COARSE", "N_FINE"),
                   help="depth-guided fast rendering for every frame")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    loaded = load_model_dir(args.Model_Location, use_mesh=True,
                            fast_render=args.fast_render, device=args.device)
    if args.pose_keyframe:
        script = MovieScript()
        for kf in args.pose_keyframe:
            x, y, z, pitch, yaw, fov, se, sa, t = \
                [float(v) for v in kf.split(",")]
            script.add(None, (se, sa), t,
                       cam_pose=(x, y, z, pitch, yaw, fov))
    elif args.keyframe:
        script = MovieScript()
        for kf in args.keyframe:
            ve, va, se, sa, t = [float(x) for x in kf.split(",")]
            script.add((ve, va), (se, sa), t)
    else:
        script = default_script()
    frames = render_movie(loaded.renderer, script, args.frames, args.size,
                          angles_to_vec=loaded.angles_to_vec)
    out = args.out or os.path.join(args.Model_Location, "movie.gif")
    path = export_film(frames, out, fps=args.fps)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
