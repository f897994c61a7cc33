"""Whole frames back to back: a closed loop of ``Renderer.render_img`` on
a model directory loaded by ``load_model_dir``, as a batch user (movies,
evaluation renders) drives it.

Parameters of the mix: ``size`` (px, square), ``frames`` (how many are
drawn: the last warms the shape, the window takes the others in order
and starts again from the first once it has rendered them all), the
ranges ``view_el``, ``view_az``, ``sun_el``, ``sun_az`` in degrees, and
``checked`` (frames the reference renders after the window).
"""

from __future__ import annotations

import time

import torch

from portbench import frames, inputs, program

# the mix at a CPU test's size, and the window of a control run on the card
SMALL = {"size": 16, "frames": 4000, "checked": 3}
CONTROL_SECONDS = 3.0


def setup(run):
    from season_nerf_torch.render.loading import load_model_dir
    t = run.traffic
    d = frames.model_dir(run)
    run.mark("model directory written")
    loaded = load_model_dir(d, device=str(run.device))
    run.mark("model directory loaded")
    run.program = loaded.renderer
    run.faults.get("render", lambda r: None)(run.program)
    run.frames = inputs.frame_requests(run.seed, [t["size"]] * t["frames"],
                                       t)
    warm = run.frames[-1]
    with run.spans("render_img"):
        run.program.render_img(warm["view"], warm["sun"], warm["year"],
                               warm["size"])


def window(run):
    r = run.program
    drawn, run.outputs, rays = run.frames[:-1], {}, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        i = len(rays) % len(drawn)
        f = drawn[i]
        with run.spans("render_img"):
            out = r.render_img(f["view"], f["sun"], f["year"], f["size"])
        run.outputs[i] = out["Col_Img"]
        rays.append(f["size"] ** 2)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    wall = time.perf_counter() - t0
    run.window_span = (t0, t0 + wall)
    run.attempted, run.failed = len(rays), 0
    run.work = {"frames": rays, "rays": sum(rays), "wall_s": wall}
    run.end_to_end["render_rays_per_s"] = (sum(rays) / wall, "rays/s")


def release(run):
    program.free(run)


def check(run, modes) -> dict:
    return frames.check(run, modes)
