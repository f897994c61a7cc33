"""Fast-render A/B on a trained model: agreement and speed-up against the
exact render.

Renders the same novel views through the exact uniform sampler and the
depth-guided fast render (``render/renderer.py``'s
``render_chunk_outputs_fast``), then reports how closely they agree (PSNR
and SSIM between the two images, DSM MAE between the two height maps) and
the wall-clock speed-up: the evidence that qualifies serving with
``--fast_render``.  The evaluation's component renders always take the
exact sampler, so what must be measured is the served composite itself.

    python -m season_nerf_torch.tools.fast_render_ab --Model_Location <dir> \\
        [--size 512] [--coarse 32] [--fine 32] [--views 3] [--grid] \\
        [--output ab.json] [--device cpu]

Prints one JSON line.  The counterpart of ``tools/fast_render_ab.py``, with
its flags and JSON.
"""

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--Model_Location", required=True)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--coarse", type=int, default=32)
    p.add_argument("--fine", type=int, default=32)
    p.add_argument("--views", type=int, default=3)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--grid", action="store_true",
                   help="qualification grid: views x suns x times frames "
                        "with learned AND exact shadow-mask agreement (the "
                        "exact-shadow path samples inside the fast render's "
                        "window, so the masks must be shown to survive)")
    p.add_argument("--output", default=None,
                   help="also write the JSON to this path")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from season_nerf_torch.ops.metrics import psnr, ssim
    from season_nerf_torch.render.loading import load_model_dir

    exact = load_model_dir(args.Model_Location, chunk=args.chunk,
                           device=args.device)
    fast = load_model_dir(args.Model_Location, chunk=args.chunk,
                          fast_render=(args.coarse, args.fine),
                          device=args.device)

    if args.grid:
        cells = [((55.0 + 15 * i, 120.0 * i), (30.0 + 20 * j, 90.0 + 60 * j),
                  0.1 + 0.35 * k)
                 for i in range(3) for j in range(3) for k in range(3)]
    else:
        cells = [((70.0 + 7 * i, 40.0 * i), (45.0, 180.0), 0.5)
                 for i in range(args.views)]

    def render_all(lm, exact_shadow):
        outs, heights, shadows, ex_shadows = [], [], [], []
        t0 = time.perf_counter()
        for v, sun, tf in cells:
            out = lm.renderer.render_img(v, sun, tf, args.size,
                                         exact_shadow=exact_shadow)
            outs.append(out["Col_Img"])
            heights.append(np.where(out["PS_Sum"] > 1e-2, out["Height"],
                                    np.nan))
            shadows.append(out["Shadow_Mask"])
            if exact_shadow:
                ex_shadows.append(out["Exact_Shadow_Mask"])
        dt = time.perf_counter() - t0
        return outs, heights, shadows, ex_shadows, dt

    # a warm-up on a small frame (the kernels' first build and launch),
    # then the timed renders
    for lm in (exact, fast):
        lm.renderer.render_img(cells[0][0], cells[0][1], cells[0][2], 64,
                               exact_shadow=args.grid)
    imgs_e, hm_e, sh_e, exsh_e, dt_e = render_all(exact, args.grid)
    imgs_f, hm_f, sh_f, exsh_f, dt_f = render_all(fast, args.grid)

    t = torch.from_numpy
    psnrs = [float(psnr(t(a), t(b))) for a, b in zip(imgs_e, imgs_f)]
    ssims = [float(ssim(t(a), t(b))) for a, b in zip(imgs_e, imgs_f)]
    # height agreement in meters where both paths report a surface
    h_scale = 1.0
    if exact.h_range is not None:
        h_scale = (exact.h_range[1] - exact.h_range[0]) / 2.0
    dsm_mae = []
    for a, b in zip(hm_e, hm_f):
        both = np.isfinite(a) & np.isfinite(b)
        dsm_mae.append(float(np.mean(np.abs(a[both] - b[both])) * h_scale)
                       if both.any() else float("nan"))

    def mask_agreement(masks_e, masks_f):
        """The share of pixels whose thresholded sun/shadow call agrees."""
        out = []
        for a, b in zip(masks_e, masks_f):
            ok = np.isfinite(a) & np.isfinite(b)
            out.append(float(np.mean((a[ok] >= 0.5) == (b[ok] >= 0.5)))
                       if ok.any() else float("nan"))
        return out

    n_rays = args.size * args.size * len(cells)
    result = {
        "metric": "fast_render_agreement",
        "n_frames": len(cells),
        "psnr_fast_vs_exact": [round(v, 2) for v in psnrs],
        "ssim_fast_vs_exact": [round(v, 4) for v in ssims],
        "dsm_mae_m_fast_vs_exact": [round(v, 4) for v in dsm_mae],
        "exact_rays_per_sec": round(n_rays / dt_e, 1),
        "fast_rays_per_sec": round(n_rays / dt_f, 1),
        "speedup": round(dt_e / dt_f, 2),
        "config": f"{args.size}px, coarse {args.coarse} + fine {args.fine} "
                  f"vs n_samples {exact.cfg.n_samples}",
    }
    if args.grid:
        sh_agree = mask_agreement(sh_e, sh_f)
        exsh_agree = mask_agreement(exsh_e, exsh_f)
        worst = int(np.argmin(psnrs))
        result.update({
            "grid": [{"view": c[0], "sun": c[1], "t": c[2]} for c in cells],
            "shadow_mask_agreement": [round(v, 4) for v in sh_agree],
            "exact_shadow_mask_agreement": [round(v, 4) for v in exsh_agree],
            "summary": {
                "min_psnr": round(min(psnrs), 2),
                "max_dsm_mae_m": round(max(dsm_mae), 3),
                "min_shadow_agreement": round(min(sh_agree), 4),
                "min_exact_shadow_agreement": round(min(exsh_agree), 4),
                "worst_cell": {"view": cells[worst][0],
                               "sun": cells[worst][1], "t": cells[worst][2]},
            },
        })
    print(json.dumps(result))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
