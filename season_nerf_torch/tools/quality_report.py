"""Assemble a markdown quality report from a completed run directory.

Reads the artifacts the pipeline already writes (``opts.json``,
``metrics.jsonl``, ``Output/Image_scores.txt`` and the four
``Detailed_Output/*_scores.txt`` tables of ``regional_eval``) and emits one
markdown document with a headline summary and the full tables:

    python -m season_nerf_torch.tools.quality_report <model_dir> \\
        [-o report.md]

The counterpart of ``tools/quality_report.py``, host-only text parsing
with the same output; it reads run directories of either package.
"""

import argparse
import json
import os
import re
import sys


def _read(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _table_rows(txt):
    """Parse a 'simple'-format score table into {row_label: [floats]}."""
    rows = {}
    if not txt:
        return rows
    body = txt.split("LaTeX:")[0]
    for line in body.splitlines():
        m = re.match(r"^(\S[\w ()<=/.-]*?)\s\s+(-?\d.*)$", line)
        if not m or set(line.strip()) <= {"-", " "}:
            continue
        vals = []
        for tok in m.group(2).split():
            try:
                vals.append(float(tok))
            except ValueError:
                break
        if vals:
            rows[m.group(1).strip()] = vals
    return rows


def _train_stats(metrics_path, batch_size):
    """Sustained steps/s and rays/s from the Training/* scalar timeline."""
    pts = []
    try:
        with open(metrics_path) as f:
            for line in f:
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if str(d.get("tag", "")).startswith("Training/"):
                    pts.append((d["t"], d["step"]))
    except OSError:
        return None
    if len(pts) < 2:
        return None
    pts.sort()
    # skip the first tenth of the run (start-up, first builds)
    lo = pts[max(1, len(pts) // 10)]
    hi = pts[-1]
    dt, ds = hi[0] - lo[0], hi[1] - lo[1]
    if dt <= 0 or ds <= 0:
        return None
    return {"steps_per_sec": ds / dt,
            "rays_per_sec": ds / dt * batch_size,
            "span_steps": (lo[1], hi[1]),
            "span_min": dt / 60.0}


def build_report(model_dir):
    opts = json.loads(_read(os.path.join(model_dir, "opts.json")) or "{}")
    out = []
    out.append(f"# Quality report — {opts.get('exp_name', model_dir)}\n")
    out.append(
        f"Config: {opts.get('max_train_steps', '?')} steps x "
        f"{opts.get('batch_size', '?')} rays (+ equal solar rays), "
        f"{opts.get('n_samples', '?')} samples/ray, fc {opts.get('fc_units', '?')}"
        f"x{opts.get('fc_layers', '?')}, site {opts.get('site_name', '?')}"
        f" ({opts.get('synth_views', '?')} views).\n")

    ts = _train_stats(os.path.join(model_dir, "metrics.jsonl"),
                      int(opts.get("batch_size", 0) or 0))
    if ts:
        out.append(
            f"Training throughput (steady state, steps "
            f"{ts['span_steps'][0]}–{ts['span_steps'][1]}, "
            f"{ts['span_min']:.0f} min): **{ts['steps_per_sec']:.2f} steps/s"
            f" = {ts['rays_per_sec']:,.0f} camera-rays/s**.\n")

    img = _read(os.path.join(model_dir, "Output", "Image_scores.txt")) or \
        _read(os.path.join(model_dir, "Detailed_Output", "Image_scores.txt"))
    rows = _table_rows(img)
    best = rows.get("Aligned_Shadow_Img") or rows.get("Aligned_Img")
    if best:
        out.append(
            f"Headline (seasonally aligned + shadow, held-out views): "
            f"**PSNR {best[0]:.2f}** (best {best[1]:.2f} / worst "
            f"{best[2]:.2f}), **SSIM {best[3]:.3f}**, EM {best[4]:.3f}.\n")

    hm = _read(os.path.join(model_dir, "Detailed_Output", "HM_scores.txt"))
    hrows = _table_rows(hm)
    al = hrows.get("NeRF (aligned)")
    if al:
        out.append(
            f"Recovered DSM (aligned vs GT): **MAE {al[0]:.2f} m, RMSE "
            f"{al[1]:.2f} m, {al[2] * 100:.0f}% within 1 m**, median "
            f"{al[3]:.2f} m.\n")

    for title, rel in (
            ("Image quality", os.path.join("Output", "Image_scores.txt")),
            ("Height-map accuracy",
             os.path.join("Detailed_Output", "HM_scores.txt")),
            ("Shadow verification",
             os.path.join("Detailed_Output", "Shadow_scores.txt")),
            ("Seasonal stability",
             os.path.join("Detailed_Output", "Season_scores.txt"))):
        txt = _read(os.path.join(model_dir, rel))
        if txt:
            out.append(f"## {title}\n")
            out.append("```\n" + txt.split("LaTeX:")[0].rstrip() + "\n```\n")
    return "\n".join(out)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model_dir")
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args(argv)
    report = build_report(args.model_dir)
    if args.output:
        with open(args.output, "w") as f:
            f.write(report)
        print(f"wrote {args.output}")
    else:
        sys.stdout.write(report)
    return report


if __name__ == "__main__":
    main()
