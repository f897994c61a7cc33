"""Post-hoc geometry-best selection over a completed run's save points.

``final_model_selection=best_geometry`` (``train/engine.py``'s
``finalize``) ships the save point whose validation renders score the
lowest height error against the training-time prior DSM, a signal free of
ground-truth leakage.  This tool recomputes that signal for every
``Model_<step>.nn`` of a run directory and shows what the selection buys:

1. per save point: the validation renders' height MAE against the prior
   (the selection's signal) and against the ground-truth DSM (a
   diagnostic), and their PSNR;
2. the selected checkpoint and the last one scored with the full
   ``eval_hm`` protocol (density surface -> meters -> greedy alignment).

Synthetic sites only (the scene regenerates from opts.json):

    python -m season_nerf_torch.tools.select_best_geometry <run_dir> \\
        [--skip-full-eval] [--device cpu]

The counterpart of ``tools/select_best_geometry.py``, with its output.  It
reads the weights and running statistics of each checkpoint of either
package (``train/state.py::load_weights``), so it scores JAX-made run
directories too.
"""

import argparse
import glob
import json
import os
import re


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir")
    p.add_argument("--skip-full-eval", action="store_true",
                   help="only print the per-save-point table")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda)")
    args = p.parse_args(argv)

    from season_nerf_torch.config import Config
    cfg = Config.load_json(os.path.join(args.run_dir, "opts.json"))
    if not cfg.site_name.upper().startswith("SYNTH"):
        raise SystemExit("post-hoc study supports synthetic sites only "
                         "(the scene regenerates from opts.json)")
    ckpts = sorted(
        glob.glob(os.path.join(args.run_dir, "Model_*.nn")),
        key=lambda q: int(re.search(r"Model_(\d+)", q).group(1)))
    if not ckpts:
        raise SystemExit(f"no Model_*.nn checkpoints in {args.run_dir}")

    run_dir = args.run_dir
    cfg.logs_dir = ""          # a writer that writes nothing: the run
    cfg.n_saves = 0            # directory is never touched
    cfg.mesh_shape = None      # read-only analysis: never require the
    #                            training slice recorded in opts.json
    import numpy as np
    from season_nerf_torch.cli import _prepare
    from season_nerf_torch.train.engine import Trainer
    from season_nerf_torch.train.state import load_weights

    cams, table, train_idx, test_idx, prior, gt_dsm, h_range, _, _ = \
        _prepare(cfg, args.device)
    train_table = table.split(np.array(train_idx))
    val_table = table.split(np.array(test_idx))
    tr = Trainer(cfg, train_table, val_table, prior_hm=prior, gt_dsm=gt_dsm,
                 device=args.device)

    def restore(ck):
        tr.model.load_weights(load_weights(ck))

    rows = []
    for ck in ckpts:
        step = int(re.search(r"Model_(\d+)", ck).group(1))
        restore(ck)
        rep = tr.validation_report(step=step)
        rows.append({"step": step,
                     "prior_mae": rep.get("Prior_Height_Error"),
                     "gt_mae": rep.get("Mean_Height_Error"),
                     "psnr": rep.get("Mean_PSNR")})
        print(json.dumps(rows[-1]), flush=True)

    scored = [r for r in rows
              if r["prior_mae"] is not None and r["gt_mae"] is not None]
    if not scored:
        raise SystemExit("no save point produced a prior-DSM height score "
                         "(validation renders had no overlap with the "
                         "prior); nothing to select from")
    best = min(scored, key=lambda r: r["prior_mae"])
    last = scored[-1]
    print(f"\nselected (argmin prior-DSM MAE): step {best['step']} "
          f"(prior {best['prior_mae']:.4f}, GT {best['gt_mae']:.4f}) "
          f"vs last step {last['step']} "
          f"(prior {last['prior_mae']:.4f}, GT {last['gt_mae']:.4f})")
    # does the leakage-free signal rank the save points as the GT does?
    n = len(scored)
    if n > 1:
        pr = np.argsort(np.argsort([r["prior_mae"] for r in scored]))
        gr = np.argsort(np.argsort([r["gt_mae"] for r in scored]))
        rho = 1 - 6 * np.sum((pr - gr) ** 2) / (n * (n * n - 1))
        print(f"rank correlation prior-vs-GT across {n} save points: "
              f"{rho:.3f}")

    if args.skip_full_eval:
        return rows
    from season_nerf_torch.eval import hm_eval

    def full_dsm(ck):
        restore(ck)
        _, before, after = hm_eval.eval_hm(tr.model, gt_dsm, h_range,
                                           n_samples=cfg.n_samples)
        return before, after

    for label, ck in (("best_geometry", os.path.join(
            run_dir, f"Model_{best['step']}.nn")),
            ("last (reference protocol)", ckpts[-1])):
        before, after = full_dsm(ck)
        print(f"\n{label}: DSM raw MAE {before['MAE']:.3f} m -> aligned "
              f"MAE {after['MAE']:.3f} m, RMSE {after['RMSE']:.3f} m, "
              f"<=1m {after['Acc_1_m']:.3f}, median {after['Median']:.3f} m")
    return rows


if __name__ == "__main__":
    main()
