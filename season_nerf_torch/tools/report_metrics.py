"""Shared score-table parsing for the evidence tools.

``fast_sine_parity`` reduces a finished run directory to its headline
quality numbers by parsing the score tables ``regional_eval`` writes, with
``quality_report``'s parser, so that a change of the tables' format moves
every tool at once.  The counterpart of ``tools/report_metrics.py``.
"""

import os

from season_nerf_torch.tools import quality_report as qr


def arm_metrics(logs_dir):
    """Headline metrics from a completed run directory: seasonally aligned
    (+ shadow) PSNR/SSIM/EM on held-out views and the aligned DSM's
    accuracy (the reference's scoring, main_eval_region.py:10-123)."""
    img = qr._table_rows(qr._read(
        os.path.join(logs_dir, "Output", "Image_scores.txt")))
    hm = qr._table_rows(qr._read(
        os.path.join(logs_dir, "Detailed_Output", "HM_scores.txt")))
    out = {}
    best = img.get("Aligned_Shadow_Img") or img.get("Aligned_Img")
    if best:
        out.update(psnr=best[0], ssim=best[3], em=best[4])
    al = hm.get("NeRF (aligned)")
    if al:
        out.update(dsm_mae=al[0], dsm_rmse=al[1], dsm_le1m=al[2],
                   dsm_median=al[3])
    return out
