"""Report writers: aligned text tables with LaTeX rows, score summaries.

The counterpart of ``season_nerf_tpu/eval/reports.py``.  Every table is
written as aligned plain text, then as LaTeX rows.  The text layout is the
JAX package's own when ``tabulate`` is not installed; the port never uses
``tabulate``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def text_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    """Columns padded to their widest cell, two spaces apart, the header
    underlined with dashes."""
    widths = [max(len(str(h)), *(len(_fmt(r[i])) for r in rows))
              for i, h in enumerate(headers)]
    line = "  ".join(str(h).ljust(w) for h, w in zip(headers, widths))
    out = [line, "-" * len(line)]
    for r in rows:
        out.append("  ".join(_fmt(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


def latex_rows(rows: Sequence[Sequence]) -> str:
    return "\n".join(" & ".join(_fmt(c) for c in r) + r" \\" for r in rows)


def write_table(path: str, headers, rows, title: str = ""):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        if title:
            f.write(title + "\n\n")
        f.write(text_table(headers, rows))
        f.write("\n\nLaTeX:\n")
        f.write(latex_rows(rows))
        f.write("\n")


def hm_report(path: str, before: Dict, after: Dict,
              prior_scores: Optional[Dict] = None):
    """Height-map score table: prior (optional), raw and aligned NeRF."""
    headers = ["Variant", "MAE", "RMSE", "Acc<=1m", "Median"]
    rows = []
    if prior_scores:
        rows.append(["Prior DSM"] + [prior_scores[k] for k in
                                     ("MAE", "RMSE", "Acc_1_m", "Median")])
    rows.append(["NeRF (raw)"] + [before[k] for k in
                                  ("MAE", "RMSE", "Acc_1_m", "Median")])
    rows.append(["NeRF (aligned)"] + [after[k] for k in
                                      ("MAE", "RMSE", "Acc_1_m", "Median")])
    write_table(path, headers, rows, title="Height-map accuracy (meters)")


def image_report(path: str, summary: Dict[str, Dict]):
    """Per-variant average/best/worst image-quality table."""
    headers = ["Variant", "PSNR avg", "PSNR best", "PSNR worst",
               "SSIM avg", "EM avg", "L2 avg"]
    rows = []
    for variant, cols in summary.items():
        rows.append([variant, cols["PSNR"]["avg"], cols["PSNR"]["best"],
                     cols["PSNR"]["worst"], cols["SSIM"]["avg"],
                     cols["EM"]["avg"], cols["L2"]["avg"]])
    write_table(path, headers, rows, title="Image quality by variant")


def shadow_report(path: str, stats_by_set: Dict[str, Dict]):
    headers = ["Angle set", "Acc", "Prec sun", "Recall sun", "Prec shadow",
               "Recall shadow", "Avg err", "Avg offset"]
    rows = [[name, s["Acc"], s["Prec_Sun"], s["Recall_Sun"],
             s["Prec_Shadow"], s["Recall_Shadow"], s["Avg_Error"],
             s["Avg_Offset"]] for name, s in stats_by_set.items()]
    write_table(path, headers, rows,
                title="Shadow claims: learned vis vs exact transmittance")


def season_report(path: str, stability: Dict, baseline: np.ndarray):
    s = stability["Stats"]
    base = baseline[np.isfinite(baseline)]
    headers = ["Quantity", "mean", "median", "p95", "max"]
    rows = [["Walk EM (lower=stabler)", s["mean"], s["median"], s["p95"],
             s["max"]]]
    if base.size:
        rows.append(["Prototype baseline EM", float(np.mean(base)),
                     float(np.median(base)), float(np.percentile(base, 95)),
                     float(np.max(base))])
    write_table(path, headers, rows, title="Seasonal stability (EM distance)")
