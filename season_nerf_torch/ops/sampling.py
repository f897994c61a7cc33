"""Ray sampling: stratified and importance samples along rays, and the
scene-cube mask.

The counterpart of ``season_nerf_tpu/ops/sampling.py``.  The random numbers
are passed in (the training jitter, ``[R, n]`` uniform draws in [0, 1); the
importance samples' ``u`` and ``shift``), so a caller can give both
packages the same numbers.
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


def sample_fine(tops, bots, base_pts, weights, n_fine, u, shift):
    """Importance-resample ``n_fine`` extra points per ray proportional to
    ``weights`` (the coarse samples' surface probabilities) and merge them
    with the coarse points in order of distance from the ray top.

    base_pts: [R, S, 3]; weights: [R, S]; ``u`` [R, n_fine] picks each new
    point's bin by the inverse CDF (the right-side search), ``shift``
    [R, n_fine, 1] places it inside the bin, between the midpoints of its
    neighbours; both uniform in [0, 1).  -> (pts [R, S + n_fine, 3],
    deltas [R, S + n_fine, 1]), each delta the length of its sample's
    segment between the midpoints to its neighbours (the ray's ends
    outside)."""
    R, S, _ = base_pts.shape
    cdf = torch.cumsum(weights + 1e-5, dim=1)
    cdf = (cdf / cdf[:, -1:]).contiguous()
    idx = torch.searchsorted(cdf, u.contiguous(), right=True).clamp_(0, S - 1)
    mids = (base_pts[:, 1:] + base_pts[:, :-1]) / 2
    starts = torch.cat([tops[:, None, :], mids], dim=1)          # [R, S, 3]
    ends = torch.cat([mids, bots[:, None, :]], dim=1)            # [R, S, 3]
    take = lambda a, i: torch.gather(a, 1, i[..., None].expand(
        *i.shape, a.shape[-1]))
    lo, hi = take(starts, idx), take(ends, idx)
    all_pts = torch.cat([base_pts, lo + (hi - lo) * shift], dim=1)
    # coarse and fine points can tie in distance: a stable sort keeps the
    # coarse one first, as jnp.argsort does
    d2 = torch.sum((tops[:, None, :] - all_pts) ** 2, dim=2)
    all_pts = take(all_pts, torch.argsort(d2, dim=1, stable=True))
    mid2 = (all_pts[:, :-1] + all_pts[:, 1:]) / 2
    seg = torch.cat([tops[:, None, :], mid2, bots[:, None, :]], dim=1)
    deltas = torch.sqrt(torch.sum((seg[:, 1:] - seg[:, :-1]) ** 2, dim=2))
    return all_pts, deltas[:, :, None]


def out_of_cube(pts, lo=-1.0, hi=1.0):
    """Boolean mask of points outside the scene cube."""
    return torch.any((pts < lo) | (pts > hi), dim=-1)
