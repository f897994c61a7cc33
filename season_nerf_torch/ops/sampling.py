"""Ray sampling at inference: uniform samples and the scene-cube mask."""

from __future__ import annotations

import torch


def sample_coarse(tops, bots, n_samples, include_end=False):
    """Deterministic samples along top->bot segments (the JAX package's
    ``sample_coarse`` with ``train=False``; no jitter at inference).

    tops/bots: [R, 3].  -> (pts [R, n, 3], deltas [R, n, 1]) with the
    constant per-ray step ``|top - bot| / n``.  ``include_end`` spans
    [0, 1] inclusive, else the n bin starts of [0, 1)."""
    R = tops.shape[0]
    if include_end:
        ts = torch.linspace(0.0, 1.0, n_samples, device=tops.device)
    else:
        ts = torch.linspace(0.0, 1.0, n_samples + 1, device=tops.device)[:-1]
    ts = ts[None, :, None]
    pts = tops[:, None, :] * (1.0 - ts) + bots[:, None, :] * ts
    deltas = torch.sqrt(torch.sum((tops - bots) ** 2, dim=1)) / n_samples
    return pts, deltas[:, None, None].expand(R, n_samples, 1)


def out_of_cube(pts, lo=-1.0, hi=1.0):
    """Boolean mask of points outside the scene cube."""
    return torch.any((pts < lo) | (pts > hi), dim=-1)
