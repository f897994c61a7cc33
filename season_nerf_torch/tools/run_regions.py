"""Train and evaluate several sites one after the other, then merge their
summaries.

The reference's multi-region workflow (``main.py`` for each site, then
``multi_region_merge``, main_eval_region.py:125-157): each site through
``cli.run_test`` (training, the evaluation into ``Output/`` and the
regional evaluation into ``Detailed_Output/``), then every site's
``Detailed_Output/`` merged into ``<IO_Location>/Logs/Full_Summary``.

    python -m season_nerf_torch.tools.run_regions --IO_Location ./io \\
        --sites OMA_132 OMA_281 [--max_train_steps 50000] [--lite] \\
        [--set fc_units=128 ...] [--device cpu]

The counterpart of ``tools/run_regions.py``, with its flags.  A site's
directory that holds an earlier run's checkpoints resumes under its
recorded settings, as ``cli train`` does.
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--IO_Location", required=True)
    p.add_argument("--sites", nargs="+", required=True)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--lite", action="store_true")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="override any Config field, e.g. --set fc_units=128")
    p.add_argument("--device", default="cuda",
                   help="torch device to train and evaluate on "
                        "(default cuda)")
    args = p.parse_args(argv)

    from season_nerf_torch import cli
    from season_nerf_torch.config import (Config, apply_overrides,
                                          lite_defaults)
    from season_nerf_torch.eval.regional import multi_region_merge

    region_dirs = []
    for site in args.sites:
        cfg = lite_defaults() if args.lite else Config()
        cfg.site_name = site
        cfg.exp_name = f"{site}_sweep"
        cfg.IO_Location = args.IO_Location
        if args.max_train_steps:
            cfg.max_train_steps = args.max_train_steps
        apply_overrides(cfg, args.set)
        cfg.resolve_dirs()
        cfg.adopt_resume_settings()
        cfg.save_json()
        print(f"=== training {site} -> {cfg.logs_dir}")
        cli.run_test(cfg, device=args.device)
        region_dirs.append(os.path.join(cfg.logs_dir, "Detailed_Output"))

    out = os.path.join(args.IO_Location, "Logs", "Full_Summary")
    multi_region_merge(region_dirs, out)
    print("merged summary:", out)
    return out


if __name__ == "__main__":
    main()
