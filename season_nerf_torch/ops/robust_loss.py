"""Barron's general and adaptive robust loss, in PyTorch.

The counterpart of ``season_nerf_tpu/ops/robust_loss.py`` ("A General and
Adaptive Robust Loss Function", Barron 2019):

  rho(x, alpha, c) = (b/d) * ((  (x/c)^2 / b + 1 )^(d/2) - 1),
      b = |alpha - 2| + eps,  d = alpha + eps,

written with expm1/log1p, and the adaptive negative log-likelihood

  nll(x, alpha, c) = rho(x, alpha, c) + log c + log Z(alpha),

where log Z is linearly interpolated in a quadrature table
(``_partition_table.npz``, this package's copy of the JAX package's).  The
interpolation's gradient in alpha is the slope of the segment, as
``jnp.interp``'s.  alpha and scale are functions of latent parameters
(sigmoid-affine and softplus-affine, latent 0 = the initial value).
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "_partition_table.npz")
_TABLE: Dict[str, np.ndarray] = {}


def general_loss(x, alpha, scale, eps: float = 1e-6):
    """rho(x, alpha, scale) for alpha >= 0, continuous in alpha."""
    sq = (x / scale) ** 2
    b = torch.abs(alpha - 2.0) + eps
    d = alpha + eps
    return (b / d) * torch.expm1(0.5 * d * torch.log1p(sq / b))


def _table(device) -> Tuple[torch.Tensor, torch.Tensor]:
    if not _TABLE:
        dat = np.load(_TABLE_PATH)
        _TABLE["alphas"], _TABLE["logz"] = dat["alphas"], dat["logz"]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return f32(_TABLE["alphas"]), f32(_TABLE["logz"])


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """``jnp.interp`` for x within [xp[0], xp[-1]]: the segment is found
    with ``side="right"`` and clipped to the table, so x = xp[-1] takes the
    last segment; the gradient in x is the segment's slope."""
    i = torch.clamp(torch.searchsorted(xp, x.detach(), right=True), 1,
                    xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    return f0 + (x - x0) / (x1 - x0) * (f1 - f0)


def log_partition(alpha: torch.Tensor) -> torch.Tensor:
    """log Z(alpha) by linear interpolation of the quadrature table."""
    alphas, logz = _table(alpha.device)
    a = torch.clamp(alpha, float(alphas[0]), float(alphas[-1]))
    return interp(a.contiguous(), alphas, logz)


def nll(x, alpha, scale):
    """The adaptive objective: rho + log(scale) + log Z(alpha)."""
    return general_loss(x, alpha, scale) + torch.log(scale) + \
        log_partition(alpha)


class AdaptiveCfg(NamedTuple):
    """Bounds and initial values of one adaptive loss."""
    n_channels: int
    alpha_lo: float = 0.001
    alpha_hi: float = 2.99
    alpha_init: float = 2.0
    scale_lo: float = 0.01
    scale_init: float = 0.03


def init_adaptive(cfg: AdaptiveCfg, device=None) -> Dict[str, torch.Tensor]:
    """Latent parameters (zeros: alpha_init and scale_init)."""
    z = lambda: torch.zeros((1, cfg.n_channels), device=device)
    return {"latent_alpha": z(), "latent_scale": z()}


def alpha_of(params, cfg: AdaptiveCfg):
    """sigmoid-affine: latent 0 -> alpha_init, range (alpha_lo, alpha_hi)."""
    lo, hi, ref = cfg.alpha_lo, cfg.alpha_hi, cfg.alpha_init
    offset = math.log((ref - lo) / (hi - ref))
    return lo + (hi - lo) * torch.sigmoid(params["latent_alpha"] + offset)


def scale_of(params, cfg: AdaptiveCfg):
    """softplus-affine: latent 0 -> scale_init, range (scale_lo, inf)."""
    lo, ref = cfg.scale_lo, cfg.scale_init
    shift = math.log(math.e - 1.0)          # softplus^-1(1)
    sp = lambda v: F.softplus(v, beta=1.0, threshold=1e30)
    return lo + (ref - lo) * sp(params["latent_scale"] + shift) / \
        sp(torch.tensor(shift))


def adaptive_nll(params, cfg: AdaptiveCfg, x):
    """Per-element NLL under the current (alpha, scale).  x: [N, C]."""
    return nll(x, alpha_of(params, cfg), scale_of(params, cfg))


def carry_over(params, cfg: AdaptiveCfg, new_cfg: AdaptiveCfg):
    """Fresh latents whose alpha and scale take the current mean values
    (clamped into the new bounds) -> (latents, carried cfg)."""
    a = float(alpha_of(params, cfg).mean())
    s = float(scale_of(params, cfg).mean())
    a = min(max(a, new_cfg.alpha_lo + 1e-4), new_cfg.alpha_hi - 1e-4)
    s = max(s, new_cfg.scale_lo + 1e-6)
    carried = new_cfg._replace(alpha_init=a, scale_init=s)
    return init_adaptive(carried, params["latent_alpha"].device), carried
