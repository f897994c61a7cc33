"""Training-quality gate for the polynomial sine (``ops/fast_math.py``).

Trains runs that differ only in the sine (PyTorch's full-range ``sin``
against the range-reduced polynomial, K0 inside K1/K2/K3 on the card),
each through the whole pipeline (train -> evaluation -> regional tables,
``cli.run_test``), then compares the headline quality numbers:
seasonally aligned PSNR/SSIM on held-out views and the recovered DSM's
MAE/median after alignment (the reference's own scoring,
main_eval_region.py:10-123).  Seeded twins of each arm give the spread
that a difference between the sines is judged against.

    python -m season_nerf_torch.tools.fast_sine_parity --io /tmp/fsp \\
        --steps 5000 --batch 2048 [--arms exact_sin fast_sine] \\
        [-o report.md] [--device cpu]

The counterpart of ``tools/fast_sine_parity.py``, with its arms, flags and
report.  An arm whose directory under ``--io`` already holds
``Output/Image_scores.txt`` is read, not trained again.
"""

import argparse
import json
import os
import time

from season_nerf_torch.tools.report_metrics import arm_metrics

ARMS = {
    # name -> config overrides; every arm otherwise identical.  The _s1
    # arms run again from another seed: the spread between seeds is the
    # noise floor the exact-vs-fast difference is judged against (the same
    # forward arithmetic to ~2e-7 still gives another training
    # trajectory).  compute_dtype is pinned per arm, so that the sine arms
    # stay a pure float32 A/B under the bfloat16 default.
    "exact_sin": dict(fast_sine=False, compute_dtype="float32"),
    "fast_sine": dict(fast_sine=True, compute_dtype="float32"),
    "exact_sin_s1": dict(fast_sine=False, compute_dtype="float32", seed=1),
    "fast_sine_s1": dict(fast_sine=True, compute_dtype="float32", seed=1),
    "fast_bf16": dict(fast_sine=True, compute_dtype="bfloat16"),
    "fast_bf16_s1": dict(fast_sine=True, compute_dtype="bfloat16", seed=1),
}


def run_arm(args, name: str):
    """Train and evaluate one arm -> (its log directory, wall minutes)."""
    from season_nerf_torch import cli
    from season_nerf_torch.config import Config

    overrides = dict(seed=0)
    overrides.update(ARMS[name])
    cfg = Config(exp_name=f"parity_{name}", site_name="SYNTH_PARITY",
                 IO_Location=args.io, max_train_steps=args.steps,
                 batch_size=args.batch, n_samples=args.n_samples,
                 fc_units=args.fc, n_saves=4, testing_size=3,
                 synth_views=14, save_point_val_renders=0,
                 chunk=args.chunk, **overrides)
    cfg.resolve_dirs().adopt_resume_settings()
    cfg.save_json()
    t0 = time.perf_counter()
    cli.run_test(cfg, device=args.device)
    wall = (time.perf_counter() - t0) / 60.0
    return cfg.logs_dir, wall


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--io", default="/tmp/fast_sine_parity")
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--n_samples", type=int, default=96)
    p.add_argument("--fc", type=int, default=512)
    p.add_argument("--chunk", type=int, default=2560,
                   help="render chunk for the evaluation")
    p.add_argument("-o", "--output", default=None,
                   help="markdown report path (default: print only)")
    p.add_argument("--arms", nargs="*", default=["exact_sin", "fast_sine"],
                   choices=sorted(ARMS), help="arms to (re)run; finished "
                   "run directories under --io are reused")
    p.add_argument("--device", default="cuda",
                   help="torch device to train and evaluate on "
                        "(default cuda)")
    args = p.parse_args(argv)

    results = {}
    for name in args.arms:
        done = os.path.join(args.io, "Logs", f"parity_{name}",
                            "Output", "Image_scores.txt")
        if os.path.exists(done):
            logs_dir = os.path.dirname(os.path.dirname(done))
            wall = float("nan")     # already trained and scored
        else:
            logs_dir, wall = run_arm(args, name)
        m = arm_metrics(logs_dir)
        m["wall_min"] = round(wall, 1)
        results[name] = m
        print(json.dumps({name: m}), flush=True)

    arm_names = [n for n in ("exact_sin", "exact_sin_s1", "fast_sine",
                             "fast_sine_s1", "fast_bf16", "fast_bf16_s1")
                 if n in results]
    base = results[arm_names[0]]
    lines = [
        "# fast_sine training-quality parity",
        "",
        f"Runs of the identical config ({args.steps} steps x "
        f"{args.batch} rays, {args.n_samples} samples/ray, fc {args.fc}, "
        "14-view synthetic site, seed 0, 3 held-out views) differing only "
        "in the trunk arithmetic: full-range `sin` vs the "
        "range-reduced degree-11 polynomial (`ops/fast_math.py`), "
        "optionally with bfloat16 matmul compute. Scores "
        "are the reference's own protocol: seasonally-aligned + shadow "
        "PSNR/SSIM on held-out views; DSM accuracy after alignment.",
        "",
        "| metric | " + " | ".join(arm_names) +
        " | delta (last-first) |",
        "|---|" + "---|" * (len(arm_names) + 1),
    ]
    keys = [("psnr", "aligned+shadow PSNR (dB)"),
            ("ssim", "aligned+shadow SSIM"),
            ("em", "color EM distance"),
            ("dsm_mae", "DSM MAE (m)"),
            ("dsm_rmse", "DSM RMSE (m)"),
            ("dsm_le1m", "DSM frac <= 1 m"),
            ("dsm_median", "DSM median err (m)"),
            ("wall_min", "wall-clock (min)")]
    for k, label in keys:
        if all(k in results[n] for n in arm_names):
            cells = " | ".join(f"{results[n][k]:.3f}" for n in arm_names)
            delta = results[arm_names[-1]][k] - base[k]
            lines.append(f"| {label} | {cells} | {delta:+.3f} |")
    lines.append("")
    report = "\n".join(lines)
    print(report)
    if args.output:
        with open(args.output, "w") as fo:
            fo.write(report + "\n")
        print(f"wrote {args.output}")
    return report


if __name__ == "__main__":
    main()
