"""Ray sampling: stratified samples along rays and the scene-cube mask.

The counterpart of ``season_nerf_tpu/ops/sampling.py``.  The training
jitter is passed in (``[R, n]`` uniform draws in [0, 1)), so a caller can
give both packages the same numbers.  ``sample_fine`` (importance
resampling) is not ported: the flagship trains with ``n_importance=0``.
"""

from __future__ import annotations

import torch


def sample_coarse(tops, bots, n_samples, include_end=False, jitter=None):
    """Stratified samples along top->bot segments.

    tops/bots: [R, 3].  -> (pts [R, n, 3], deltas [R, n, 1]) with the
    constant per-ray step ``|top - bot| / n``.  Without ``jitter`` (the
    JAX ``train=False``): ``include_end`` spans [0, 1] inclusive, else the
    n bin starts of [0, 1).  With ``jitter`` [R, n] (training): each bin
    start moves by ``jitter / n``, per ray, whatever ``include_end``."""
    R = tops.shape[0]
    if include_end and jitter is None:
        ts = torch.linspace(0.0, 1.0, n_samples, device=tops.device)
    else:
        ts = torch.linspace(0.0, 1.0, n_samples + 1, device=tops.device)[:-1]
    ts = ts[None, :].expand(R, n_samples)
    if jitter is not None:
        ts = ts + jitter / n_samples
    ts = ts[:, :, None]
    pts = tops[:, None, :] * (1.0 - ts) + bots[:, None, :] * ts
    deltas = torch.sqrt(torch.sum((tops - bots) ** 2, dim=1)) / n_samples
    return pts, deltas[:, None, None].expand(R, n_samples, 1)


def out_of_cube(pts, lo=-1.0, hi=1.0):
    """Boolean mask of points outside the scene cube."""
    return torch.any((pts < lo) | (pts > hi), dim=-1)
