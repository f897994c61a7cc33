"""End-to-end equality of training on a mesh and on one device: a whole
run on ``n`` devices must reach the quality of the same run on one.

    python -m season_nerf_torch.tools.multidevice_equality --io DIR \\
        [--steps 3000] [--batch 512] [--n_samples 48] [--fc 128] \\
        [--eval_size 96] [--n_devices N] [-o report.md] [--device cpu]

The counterpart of ``tools/multidevice_equality.py``, with its flags and
report.  One step on a mesh equals the one-device step
(``tests/test_torch_mesh.py``); this catches what a step cannot: drift of
the global BatchNorm statistics, of the draws or of the reduction order
over a whole run with its phase switch, save points and final
evaluation.  Both arms run the same config (seed 0, a 10-view synthetic
site) through ``cli.run_test`` (train, then the evaluation into
``Output/`` and ``Detailed_Output/``); the report sets their aligned
PSNR/SSIM and DSM errors side by side.  On the card the mesh is
``n`` cards (``--n_devices``, default every visible one); with ``--device
cpu``, ``n`` ranks on the CPU over gloo (default 2).
"""

import argparse
import json
import time

from season_nerf_torch.tools.report_metrics import arm_metrics


def run_arm(args, n_devices: int):
    """Train and evaluate one arm -> (its log directory, wall minutes)."""
    from season_nerf_torch import cli
    from season_nerf_torch.config import Config
    from season_nerf_torch.parallel.mesh import make_mesh

    cfg = Config(exp_name=f"mde_mesh{n_devices}", site_name="SYNTH_MDE",
                 IO_Location=args.io, max_train_steps=args.steps,
                 batch_size=args.batch, n_samples=args.n_samples,
                 fc_units=args.fc, n_saves=3, testing_size=2,
                 synth_views=10, seed=0, mesh_shape=n_devices,
                 save_point_val_renders=0)
    cfg.resolve_dirs().adopt_resume_settings()
    cfg.save_json()
    # the CPU has one device: its ranks share it, on a mesh given whole
    mesh = (make_mesh(devices=["cpu"] * n_devices)
            if args.device == "cpu" and n_devices > 1 else None)
    t0 = time.perf_counter()
    cli.run_test(cfg, eval_img_size=(args.eval_size, args.eval_size),
                 eval_season_size=(24, 24), device=args.device, mesh=mesh)
    return cfg.logs_dir, (time.perf_counter() - t0) / 60.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--io", default="multidev_eq")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--n_samples", type=int, default=48)
    p.add_argument("--fc", type=int, default=128)
    p.add_argument("--eval_size", type=int, default=96)
    p.add_argument("--n_devices", type=int, default=None,
                   help="devices of the mesh arm (default: every visible "
                        "card; 2 with --device cpu)")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    n = args.n_devices or (2 if args.device == "cpu"
                           else torch.cuda.device_count())
    if n < 2:
        raise SystemExit(f"the mesh arm needs 2 devices or more, got {n} "
                         f"(pass --n_devices, or --device cpu)")
    where = ("gloo ranks on the CPU" if args.device == "cpu"
             else "cards over NCCL")
    results = {}
    for k in (1, n):
        logs_dir, wall = run_arm(args, k)
        m = arm_metrics(logs_dir)
        m["wall_min"] = round(wall, 1)
        results[f"mesh{k}"] = m
        print(json.dumps({f"mesh{k}": m}), flush=True)

    a, b = results["mesh1"], results[f"mesh{n}"]
    lines = [
        "# Multi-device end-to-end training equality",
        "",
        f"Full-run equality of the port's data-parallel mesh ({n} {where}): "
        f"the identical config ({args.steps} steps x {args.batch} rays, "
        f"{args.n_samples} samples/ray, fc {args.fc}, 10-view synthetic "
        "site, seed 0, both training phases + save points + final regional "
        f"eval) trained once on one device and once on {n} (the batch "
        "split over the ranks, weights replicated, global BatchNorm "
        "statistics and a summed gradient over torch.distributed).",
        "",
        f"| metric | 1 device | {n}-device mesh | delta |",
        "|---|---|---|---|",
    ]
    for k, label in (("psnr", "aligned+shadow PSNR (dB)"),
                     ("ssim", "aligned+shadow SSIM"),
                     ("dsm_mae", "DSM MAE (m)"),
                     ("dsm_median", "DSM median err (m)"),
                     ("wall_min", "wall-clock (min)")):
        if k in a and k in b:
            lines.append(f"| {label} | {a[k]:.3f} | {b[k]:.3f} | "
                         f"{b[k] - a[k]:+.3f} |")
    lines.append("")
    report = "\n".join(lines)
    print(report)
    if args.output:
        with open(args.output, "w") as f:
            f.write(report + "\n")
        print(f"wrote {args.output}")
    return results


if __name__ == "__main__":
    main()
